"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The suite runs on the CPU; sharding tests use
``xla_force_host_platform_device_count`` so multi-device layouts are
exercised without accelerators. Tests marked ``card`` need an NVIDIA GPU:
they skip here and are run on the card by ``chip_smoke.py``, which sets
``YSMR_TEST_ON_CARD=1`` so that the platform is left to JAX.
"""

import os

os.environ.setdefault('YSMR_NO_EDITOR', '1')
os.environ.setdefault('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS', '1')

import jax  # noqa: E402

if os.environ.get('YSMR_TEST_ON_CARD') != '1':
    # the environment may select an accelerator backend; the suite pins the
    # CPU explicitly, before any backend initialises
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 8)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def tmp_ini(tmp_path):
    """A default tracking.ini in a temp dir, headless-safe."""
    from ysmr_tpu.config import create_configs
    path = str(tmp_path / 'tracking.ini')
    create_configs(path, open_editor=False)
    return path


@pytest.fixture
def native_lib():
    """The native library, built at first use; skips when it cannot be."""
    from ysmr_tpu import native
    if not native.available():
        pytest.skip('native library could not be built: {}'.format(
            native.build()[1]))
    return native


@pytest.fixture
def gpu():
    """The first GPU device; skips on a host without one.

    ``YSMR_REHEARSE_CARD_TESTS=1`` runs the card tests on the CPU instead,
    to rehearse them before a run on the card.
    """
    devices = jax.devices()
    if devices[0].platform != 'gpu' and \
            os.environ.get('YSMR_REHEARSE_CARD_TESTS') != '1':
        pytest.skip('needs an NVIDIA GPU (run by chip_smoke.py on the card)')
    return devices[0]

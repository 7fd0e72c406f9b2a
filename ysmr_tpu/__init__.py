"""ysmr_tpu — accelerator-native bacterial video tracking and motility analysis.

A from-scratch JAX/XLA rebuild with the capabilities of schwanbeck/YSMR
(see SURVEY.md): per-frame OpenCV detection becomes fused device kernels,
the centroid tracker + Gaussian-Sum FIR filter become a batched ``lax.scan``
over persistent track state, and the pandas selection/statistics pipeline is
preserved as the public interchange surface.

Public API mirrors the reference package (ysmr/__init__.py): ``ysmr``,
``analyse``, the pipeline stages, and the plot functions.
"""

import os as _os
import sys as _sys


def configure_compile_cache():
    """Point JAX's persistent compilation cache at a fixed directory.

    ``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
    lives in ``.jax_cache`` at the root of the checkout (a fixed path, so
    later processes find what earlier ones compiled). Applied through
    ``jax.config`` as well when jax was imported before this package.

    :return: the cache directory in use
    """
    path = _os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if path:
        return path
    path = _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), '.jax_cache')
    _os.environ['JAX_COMPILATION_CACHE_DIR'] = path
    _os.environ.setdefault('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS', '1')
    if 'jax' in _sys.modules:
        jax = _sys.modules['jax']
        jax.config.update('jax_compilation_cache_dir', path)
        jax.config.update(
            'jax_persistent_cache_min_compile_time_secs',
            float(_os.environ['JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS']))
    return path


configure_compile_cache()

from ysmr_tpu.__version__ import VERSION, __version__  # noqa: E402,F401
from ysmr_tpu.main import analyse, ysmr  # noqa: E402,F401
from ysmr_tpu.pipeline.track_bacteria import track_bacteria  # noqa: E402,F401
from ysmr_tpu.pipeline.select import select_tracks  # noqa: E402,F401
from ysmr_tpu.pipeline.evaluate import evaluate_tracks  # noqa: E402,F401
from ysmr_tpu.pipeline.annotate import annotate_video  # noqa: E402,F401
from ysmr_tpu.plot_functions import (angle_distribution_plot,  # noqa: E402,F401
                                     large_xy_plot, rose_graph, violin_plot)

__all__ = ['ysmr', 'analyse', 'track_bacteria', 'select_tracks',
           'evaluate_tracks', 'annotate_video', 'angle_distribution_plot',
           'large_xy_plot', 'rose_graph', 'violin_plot', 'VERSION',
           '__version__', 'configure_compile_cache']

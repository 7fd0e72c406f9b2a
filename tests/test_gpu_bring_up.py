"""Choices made for the GPU: device path flags per backend, the compile
cache location, chip_smoke.py's contract, and no code left for the TPU."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from ysmr_tpu.pipeline.track_bacteria import (_DEVICE_PATH_DEFAULTS,
                                              device_path_flags)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('backend', ['cpu', 'gpu', 'rocm'])
def test_device_path_flags_auto_follow_backend(backend):
    want = _DEVICE_PATH_DEFAULTS.get(backend, _DEVICE_PATH_DEFAULTS['cpu'])
    assert device_path_flags({}, backend) == want
    assert device_path_flags({'run cc': 'auto'}, backend) == want


def test_device_path_flags_gpu_defaults():
    """The measured GPU choice: run-graph CC and sorted compaction."""
    assert device_path_flags({}, 'gpu') == {'run_cc': True,
                                            'sort_compact': True}
    assert device_path_flags({}, 'cpu') == {'run_cc': False,
                                            'sort_compact': False}


@pytest.mark.parametrize('run_cc', ['on', 'off'])
@pytest.mark.parametrize('backend', ['cpu', 'gpu', 'rocm'])
def test_device_path_flags_forced(run_cc, backend):
    """'run cc' forces run_cc; sort_compact stays the backend's default."""
    want = _DEVICE_PATH_DEFAULTS.get(backend, _DEVICE_PATH_DEFAULTS['cpu'])
    flags = device_path_flags({'run cc': run_cc}, backend)
    assert flags == {'run_cc': run_cc == 'on',
                     'sort_compact': want['sort_compact']}


def _cache_dir_in_child(env):
    code = ('import ysmr_tpu, jax; print(ysmr_tpu.configure_compile_cache());'
            'print(jax.config.jax_compilation_cache_dir)')
    env = dict(env, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()[-2:]


def test_compile_cache_follows_env(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / 'cc'))
    assert _cache_dir_in_child(env) == [str(tmp_path / 'cc')] * 2


def test_compile_cache_defaults_into_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != 'JAX_COMPILATION_CACHE_DIR'}
    assert _cache_dir_in_child(env) == [os.path.join(REPO, '.jax_cache')] * 2


def test_chip_smoke_result_line():
    sys.path.insert(0, REPO)
    import chip_smoke

    class Dev:
        platform = 'gpu'
        device_kind = 'NVIDIA H100 80GB HBM3'

    line = chip_smoke.result_line([Dev()] * 4)
    assert json.loads(line) == {'ok': True, 'device': {
        'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 4}}
    assert '\n' not in line


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return out.returncode != 0 and not (lines and '"ok"' in lines[-1])


def test_chip_smoke_refuses_without_gpu(tmp_path):
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    out = _run_smoke(tmp_path, 'chip_smoke.py')
    assert _no_result(out)
    assert 'needs 1 NVIDIA GPU' in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout the script has nothing to run: it must fail even
    where the device check passes (forced here by a stub jax that reports a
    GPU)."""
    shutil.copy(os.path.join(REPO, 'chip_smoke.py'), tmp_path)
    stub = tmp_path / 'stub'
    (stub / 'jax').mkdir(parents=True)
    (stub / 'jax' / '__init__.py').write_text(
        '__version__ = "stub"\n'
        'class _D:\n    platform = "gpu"\n    device_kind = "stub"\n'
        'def devices():\n    return [_D()]\n'
        'class monitoring:\n'
        '    register_event_duration_secs_listener = staticmethod('
        'lambda f: None)\n')
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    smi = bin_dir / 'nvidia-smi'
    smi.write_text('#!/bin/sh\necho "stub, 700.00 W"\n')
    smi.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(stub),
               PATH='{}:{}'.format(bin_dir, os.environ['PATH']))
    out = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert _no_result(out)
    assert 'ysmr_tpu' in out.stderr


def _program_files():
    out = subprocess.run(['git', 'ls-files', 'ysmr_tpu', 'bench.py',
                          '__graft_entry__.py', 'chip_smoke.py'], cwd=REPO,
                         capture_output=True, text=True)
    files = [f for f in out.stdout.split() if f.endswith('.py')]
    if not files:  # not a git checkout: walk the tree
        files = [os.path.relpath(os.path.join(d, f), REPO)
                 for d, _, fs in os.walk(os.path.join(REPO, 'ysmr_tpu'))
                 for f in fs if f.endswith('.py')]
        files += ['bench.py', '__graft_entry__.py', 'chip_smoke.py']
    return files


@pytest.mark.parametrize('pattern', [
    r'pallas\.tpu', r'pltpu', r'==\s*[\'"]tpu[\'"]', r'interpret\s*=',
    r'from jax\.experimental import pallas', r'import jax\.experimental\.pallas',
])
def test_no_tpu_kernel_code_left(pattern):
    """No Pallas-for-TPU import, no platform compared with 'tpu', and no
    interpret-mode kernel call in the program files."""
    hits = []
    for rel in _program_files():
        with open(os.path.join(REPO, rel)) as f:
            for i, line in enumerate(f, 1):
                if re.search(pattern, line):
                    hits.append('{}:{}: {}'.format(rel, i, line.strip()))
    assert not hits, hits

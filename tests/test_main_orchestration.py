"""End-to-end orchestration: ysmr() over multiple files, CSV restart, xlsx."""

import glob
import os

import numpy as np
import pytest


def _settings_for(tmp_path, video):
    from ysmr_tpu.config import create_configs, get_configs
    ini = str(tmp_path / 'tracking.ini')
    create_configs(ini, open_editor=False)
    settings = get_configs(ini)
    settings.update({
        'display video analysis': False,
        'user input': False,
        'select files': False,
        'save video': False,
        'verbose': False,
        'log to file': False,
        'minimal frame count': 30,
        'minimal length in seconds': 2.0,
        'limit track length to x seconds': 3.0,
        'extreme area outliers upper end in px*px': 500,
        'save large plots': False,
        'save rose plot': False,
        'save time violin plot': False,
        'save acr violin plot': False,
        'save length violin plot': False,
        'save turning point violin plot': False,
        'save speed violin plot': False,
        'save displacement violin plot': False,
        'save percent motile plot': False,
        'save angle distribution plot / bins': 0,
        'collate results csv to xlsx': True,
        'frame batch size': 8,
        'max detections per frame': 64,
        'max track slots': 128,
        'debugging': False,
        'path to test video': video,
    })
    return settings


@pytest.mark.e2e
def test_ysmr_batch_and_csv_restart(tmp_path):
    from tests.test_e2e_parity import make_synthetic_video
    from ysmr_tpu.main import analyse, ysmr
    v1 = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60, seed=3)
    v2 = make_synthetic_video(str(tmp_path / 'b.avi'), n_frames=60, seed=4)
    settings = _settings_for(tmp_path, v1)
    settings['minimal length in seconds'] = 1.0
    settings['limit track length to x seconds'] = 1.5
    result_folder = str(tmp_path / 'results')
    os.makedirs(result_folder)
    finished = ysmr(paths=[v1, v2], settings=settings,
                    result_folder=result_folder, multiprocess=False)
    assert finished is not None and len(finished) == 2
    assert all(res is not None for _, res in finished)
    # artifact names derive from the path handed to each stage (the video
    # stem here), matching reference main.py:113-136 / track_eval.py:570-572
    for stem in ('a', 'b'):
        for suffix in ('_list.csv', '_selected_data.csv',
                       '_statistics.csv', '_analysed.csv'):
            path = os.path.join(result_folder, stem + suffix)
            assert os.path.isfile(path), path
        assert os.path.isfile(os.path.join(result_folder, stem + '_meta.json'))
    assert glob.glob(os.path.join(result_folder, '*_collated_statistics.xlsx'))

    # stage restart from the CSV alone (+ _meta.json sidecar): results match
    import pandas as pd
    first_stats = pd.read_csv(os.path.join(result_folder,
                                           'a_statistics.csv'))
    restart_folder = str(tmp_path / 'restart')
    os.makedirs(restart_folder)
    settings['collate results csv to xlsx'] = False
    out = analyse(os.path.join(result_folder, 'a_list.csv'), settings=settings,
                  result_folder=restart_folder, return_df=True,
                  fps=30.0, frame_height=288, frame_width=384)
    assert out is not None
    restat = pd.read_csv(os.path.join(restart_folder,
                                      'a_list_statistics.csv'))
    assert restat.shape == first_stats.shape
    np.testing.assert_allclose(
        restat['Distance (µm)'].to_numpy(),
        first_stats['Distance (µm)'].to_numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.e2e
def test_ysmr_skips_finished_files(tmp_path):
    from ysmr_tpu.main import analyse
    settings = _settings_for(tmp_path, 'unused')
    path = str(tmp_path / 'x_analysed.csv')
    open(path, 'w').write('TRACK_ID\n0\n')
    assert analyse(path, settings=settings,
                   result_folder=str(tmp_path)) is None


@pytest.mark.e2e
def test_ysmr_multiprocess_pool(tmp_path):
    """mp.Pool dispatch (spawn context, maxtasksperchild=1 — reference
    main.py:281-313): the good video is processed, the broken path is
    isolated into the failure tally without aborting the batch
    (main.py:292-317). One worker video keeps the spawn-import cost of this
    test bounded on slow hosts."""
    from tests.test_e2e_parity import make_synthetic_video
    from ysmr_tpu.main import ysmr
    v1 = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60, seed=3)
    v_bad = str(tmp_path / 'missing.avi')  # does not exist
    settings = _settings_for(tmp_path, v1)
    settings['minimal length in seconds'] = 1.0
    settings['limit track length to x seconds'] = 1.5
    settings['collate results csv to xlsx'] = False
    result_folder = str(tmp_path / 'results_mp')
    os.makedirs(result_folder)
    # spawn workers on this single-core host can be starved to death under
    # full-suite load; one retry keeps the test about pool semantics rather
    # than scheduler luck
    for attempt in range(2):
        finished = ysmr(paths=[v1, v_bad], settings=settings,
                        result_folder=result_folder, multiprocess=True)
        assert finished is not None
        if os.path.isfile(os.path.join(result_folder, 'a_statistics.csv')):
            break
    assert os.path.isfile(os.path.join(result_folder, 'a_statistics.csv'))
    done = {p: r for p, r in finished}
    assert done.get(v_bad) is None


@pytest.mark.e2e
def test_ysmr_multiprocess_with_parent_device_held(tmp_path):
    """Pool dispatch while the PARENT process already holds a JAX backend:
    workers are pinned to the CPU backend (main._pool_worker_init), so N
    workers never race for one accelerator. The batch must complete with
    artifacts, not hang or crash."""
    import jax
    import jax.numpy as jnp
    from tests.test_e2e_parity import make_synthetic_video
    from ysmr_tpu.main import _pool_worker_init, ysmr
    # simulate "parent owns the device": initialise the backend up front
    assert float(jnp.sum(jnp.ones((4,)))) == 4.0
    assert jax.devices()
    v1 = make_synthetic_video(str(tmp_path / 'a.avi'), n_frames=60, seed=3)
    settings = _settings_for(tmp_path, v1)
    settings['minimal length in seconds'] = 1.0
    settings['limit track length to x seconds'] = 1.5
    settings['collate results csv to xlsx'] = False
    result_folder = str(tmp_path / 'results_mp2')
    os.makedirs(result_folder)
    for attempt in range(2):  # spawn workers can starve under suite load
        finished = ysmr(paths=[v1], settings=settings,
                        result_folder=result_folder, multiprocess=True)
        assert finished is not None
        if os.path.isfile(os.path.join(result_folder, 'a_statistics.csv')):
            break
    assert os.path.isfile(os.path.join(result_folder, 'a_statistics.csv'))
    # the initializer pins workers to the CPU plugin
    old = os.environ.get('JAX_PLATFORMS')
    try:
        _pool_worker_init()
        assert os.environ['JAX_PLATFORMS'] == 'cpu'
    finally:
        if old is None:
            os.environ.pop('JAX_PLATFORMS', None)
        else:
            os.environ['JAX_PLATFORMS'] = old


def test_resolve_batch_size_rules():
    """Pixels-mode batch rounding: up to 64 on an accelerator (dense
    capacities included since the run-table stats path removed the
    batch-64 compile pathology), UNTOUCHED on CPU; display bounds the
    batch for preview latency."""
    from ysmr_tpu.pipeline.track_bacteria import resolve_batch_size
    sparse = {'frame batch size': 16, 'max detections per frame': 512}
    dense = {'frame batch size': 16, 'max detections per frame': 4096}
    assert resolve_batch_size(sparse, 'pixels', 'gpu', False) == 64
    assert resolve_batch_size(dense, 'pixels', 'gpu', False) == 64
    assert resolve_batch_size(sparse, 'pixels', 'cpu', False) == 16
    assert resolve_batch_size(sparse, 'frames', 'gpu', False) == 16
    assert resolve_batch_size({'frame batch size': 128,
                               'max detections per frame': 512},
                              'pixels', 'gpu', False) == 128
    assert resolve_batch_size(sparse, 'pixels', 'gpu', True) == 16
    assert resolve_batch_size({'frame batch size': 32,
                               'max detections per frame': 512},
                              'pixels', 'gpu', True) == 16

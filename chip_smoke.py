#!/usr/bin/env python3
"""Smoke test of the tracking pipeline on one NVIDIA GPU.

    python chip_smoke.py           # one GPU: all phases below
    python chip_smoke.py --four    # four GPUs: the multi-device path only

Phases (each prints its wall time, the part of it spent compiling, and its
result; any failure exits non-zero and the result line is not printed):

1. device    JAX must report a GPU; no phase falls back to the CPU.
2. build     the native host library, compiled from native/ for this host.
3. numerics  the card tests (tests/test_on_card.py): the bit-exact f32
             recipes, cv2-exact centres, the GSFF bank and every XLA form
             that replaced a hand-written kernel, against host oracles at
             full width.
4. full      the bench clip (1228x922, 630 frames, 200 rods, seed 123,
             512 detections, 1024 track slots, 64-frame batches) through
             ``ysmr()`` in 'pixels' mode, which must reproduce the
             reference's _list.csv row for row, and in 'auto' mode, which
             reports the transfer mode it picked and its share of
             reference-identical rows. Each runs twice: cold (compiles)
             and warm (steady state).
5. cpu       a 96-frame prefix of the clip in each mode, on the GPU and in
             a subprocess on the CPU (JAX_PLATFORMS=cpu): identical track
             ids and row counts, positions within the stated tolerance.

``--four`` shards four seeded clips over a 1-axis mesh of four GPUs through
``ysmr()`` ('shard videos across devices') and requires each _list.csv to
equal a solo one-GPU run of the same clip, then checks
``sharded_greedy_assign`` at 16384 slots against ``greedy_assign``.

The runs go through ``ysmr()`` with the plot outputs off; where matplotlib
is not installed the evaluation stage (statistics and plots) is off too,
and ``ysmr()`` runs detection, tracking and track selection.

The card's name and power limit (nvidia-smi) and the JAX version are
printed before the last line, which is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Clips and results go to a temporary directory that is removed at the end;
the phase lines are also written to chiprun_out/chip_smoke/summary.txt.
"""

import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SUMMARY = os.path.join(REPO, 'chiprun_out', 'chip_smoke', 'summary.txt')
OUT = None  # work directory, made in main()
PREFIX_FRAMES = 96
#: frames-mode rects and positions are computed on the device in f32 (and
#: double-single in the GSFF bank). XLA:CPU contracts multiply-adds into
#: fused multiply-adds and XLA:GPU does not, so rect centres differ by up
#: to 2 ulp in a few rows and the filter bank's inexact products round
#: differently; the filter's feedback carries this forward. Fed identical
#: detections, the GPU and CPU trackers differ by up to 2.6e-3 px on the
#: 96-frame prefix, growing with the frame count, hence 1e-2 px. Pixels mode
#: measures and tracks on the host in float64 and must match exactly.
CPU_POSITION_ATOL = {'pixels': 0.0, 'frames': 1e-2}
FOUR_CLIP_FRAMES = 150

_COMPILE_EVENTS = ('/jax/core/compile/backend_compile_duration',
                   '/jax/core/compile/jaxpr_trace_duration',
                   '/jax/core/compile/jaxpr_to_mlir_module_duration')
_compile_s = [0.0]


def _on_duration(event, duration_secs, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration_secs


def result_line(devices):
    """The contract's last line for a list of JAX devices."""
    return json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}})


def require_gpu(count):
    """The JAX devices, when the first ``count`` are GPUs; else exit 1."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu' or len(devices) < count:
        print('chip_smoke: needs {} NVIDIA GPU(s); JAX found {}'.format(
            count, devices), file=sys.stderr)
        sys.exit(1)
    return devices


def say(line):
    """Print a summary line and append it to the summary file."""
    print(line, flush=True)
    os.makedirs(os.path.dirname(SUMMARY), exist_ok=True)
    with open(SUMMARY, 'a') as f:
        f.write(line + '\n')


def card_info():
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip()


class Phase:
    """Context manager printing a phase's wall time, compile share, result."""

    def __init__(self, name):
        self.name = name
        self.result = ''

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = _compile_s[0]
        say('[{}] start'.format(self.name))
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self.t0
        comp = _compile_s[0] - self.c0
        status = 'FAILED' if exc_type else 'ok'
        say('[{}] {} wall {:.1f} s, compile {:.1f} s, rest {:.1f} s{}'.format(
            self.name, status, wall, comp, wall - comp,
            (': ' + self.result) if self.result else ''))
        return False


def smoke_settings(**extra):
    """bench_settings plus what a headless smoke run needs: no plots, no
    xlsx, no prompts, warnings only (the plotting packages are optional;
    without matplotlib the evaluation stage, which always draws the median
    speed violin, is off too)."""
    import bench
    evaluate = importlib.util.find_spec('matplotlib') is not None
    settings = bench.bench_settings({
        'store generated statistical .csv file': evaluate,
        'store final analysed .csv file': evaluate,
        'log_level': logging.WARNING,
        'save large plots': False, 'save rose plot': False,
        'save time violin plot': False, 'save acr violin plot': False,
        'save length violin plot': False,
        'save turning point violin plot': False,
        'save speed violin plot': False,
        'save displacement violin plot': False,
        'save percent motile plot': False,
        'save angle distribution plot / bins': 0,
        'collate results csv to xlsx': False,
        'delete .csv file after analysis': False,
        'shut down after analysis': False,
        'minimal frame count': 16,
    })
    settings.update(extra)
    return settings


def stage1_only(settings, **extra):
    """Settings for ysmr() runs of detection and tracking alone: short
    clips leave too few tracks for the selection stage."""
    return dict(settings, **{'store processed .csv file': False,
                             'store generated statistical .csv file': False,
                             'store final analysed .csv file': False},
                **extra)


def run_ysmr(clip, folder, settings):
    """One clip through ysmr(); returns the sorted _list.csv DataFrame."""
    from ysmr_tpu import ysmr
    from ysmr_tpu.utils.parity import read_list_csv
    os.makedirs(folder, exist_ok=True)
    finished = ysmr(paths=[clip], settings=dict(settings),
                    result_folder=folder)
    assert finished and all(r is not None for _, r in finished), finished
    name = os.path.splitext(os.path.basename(clip))[0] + '_list.csv'
    return read_list_csv(os.path.join(folder, name))


def resolved_mode(clip, settings):
    """The transfer mode track_bacteria resolves for this clip."""
    from ysmr_tpu.io.video import BatchedVideoReader
    from ysmr_tpu.pipeline.track_bacteria import resolve_transfer_mode
    probe = BatchedVideoReader(clip, batch_size=1)
    frame_bytes = probe.width * probe.height * 3
    probe._cap.release()
    return resolve_transfer_mode(settings, frame_bytes)


def phase_numerics():
    """The card tests, in this process (one process owns the card)."""
    import pytest

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == 'call' and report.passed:
                self.passed += 1
            elif report.failed:
                self.failed += 1
            elif report.skipped:
                self.skipped += 1

    counter = Count()
    os.environ['YSMR_TEST_ON_CARD'] = '1'
    rc = pytest.main(['-q', '-s', '-p', 'no:cacheprovider', '-p', 'no:xdist',
                      '-m', 'card', os.path.join(REPO, 'tests',
                                                 'test_on_card.py')],
                     plugins=[counter])
    assert rc == 0 and counter.failed == 0 and counter.skipped == 0 \
        and counter.passed > 0, (rc, counter.passed, counter.failed,
                                 counter.skipped)
    return '{} card tests passed'.format(counter.passed)


def phase_full(clip, ref_csv, flags):
    """Both transfer modes on the full clip; returns the per-mode settings
    the CPU comparison reuses (with the GPU's labeling path, so that the CPU
    runs the same program)."""
    from ysmr_tpu.utils.parity import compare_rows, read_list_csv
    ref = read_list_csv(ref_csv)
    run_cc = {'run cc': 'on' if flags['run_cc'] else 'off'}
    modes = {}
    for mode in ('pixels', 'auto'):
        settings = smoke_settings(**{'transfer mode': mode}, **run_cc)
        picked = resolved_mode(clip, settings)
        for run in ('cold', 'warm'):
            with Phase('full/{}/{}'.format(mode, run)) as ph:
                df = run_ysmr(clip, os.path.join(OUT, 'full_' + mode),
                              settings)
                strict, detail = compare_rows(df, ref)
                ph.result = ('mode {}, {} rows, {} tracks, identical rows '
                             'vs reference: {}, id agreement {:.6f}'.format(
                                 picked, df.shape[0],
                                 df['TRACK_ID'].nunique(), strict,
                                 detail.get('id_agreement', 0.0)))
        say('full/{} parity detail: {}'.format(mode, json.dumps(detail)))
        if mode == 'pixels':
            assert strict, detail
            assert df.shape[0] == 127314 and df['TRACK_ID'].nunique() == 328
        modes[picked] = settings
    modes.setdefault('pixels', smoke_settings(**{'transfer mode': 'pixels'},
                                              **run_cc))
    return modes


def phase_cpu(prefix_clip, modes):
    """Each mode on the prefix clip, here on the GPU and in a CPU-only
    subprocess running the same program."""
    from ysmr_tpu.utils.parity import compare_rows, read_list_csv
    for mode, settings in sorted(modes.items()):
        settings = stage1_only(settings, **{'transfer mode': mode})
        with Phase('cpu/{}'.format(mode)) as ph:
            gpu_df = run_ysmr(prefix_clip, os.path.join(OUT, 'gpu_' + mode),
                              settings)
            cpu_dir = os.path.join(OUT, 'cpu_' + mode)
            spec = os.path.join(OUT, 'cpu_{}.json'.format(mode))
            with open(spec, 'w') as f:
                json.dump({k: v for k, v in settings.items()
                           if isinstance(v, (str, int, float, bool,
                                             type(None), list))}, f)
            env = dict(os.environ, JAX_PLATFORMS='cpu')
            env.pop('YSMR_TEST_ON_CARD', None)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--cpu-run',
                 prefix_clip, cpu_dir, spec], env=env, capture_output=True,
                text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:])
            assert proc.returncode == 0, 'CPU run failed'
            name = os.path.splitext(os.path.basename(prefix_clip))[0]
            cpu_df = read_list_csv(os.path.join(cpu_dir,
                                                name + '_list.csv'))
            ok_ids = cpu_df.shape[0] == gpu_df.shape[0] and \
                (cpu_df['TRACK_ID'].to_numpy() ==
                 gpu_df['TRACK_ID'].to_numpy()).all() and \
                (cpu_df['POSITION_T'].to_numpy() ==
                 gpu_df['POSITION_T'].to_numpy()).all()
            strict, detail = compare_rows(gpu_df, cpu_df,
                                          atol=CPU_POSITION_ATOL[mode])
            ph.result = ('{} rows, ids identical: {}, within {} px: {}, '
                         'max |dx| {}, max |dy| {}'.format(
                             gpu_df.shape[0], bool(ok_ids),
                             CPU_POSITION_ATOL[mode], strict,
                             detail.get('max_abs_diff_POSITION_X'),
                             detail.get('max_abs_diff_POSITION_Y')))
            assert ok_ids and strict, detail


def cpu_run(clip, folder, spec):
    """--cpu-run: one clip through ysmr() on the CPU backend."""
    import jax
    assert jax.devices()[0].platform == 'cpu'
    with open(spec) as f:
        settings = smoke_settings()
        settings.update(json.load(f))
    run_ysmr(clip, folder, settings)


def phase_four(devices):
    """Sharded multi-video stage 1 over four GPUs vs solo runs, and the
    row-sharded dense assignment vs the single-device matcher."""
    import numpy as np
    import jax.numpy as jnp
    import bench
    from ysmr_tpu import ysmr
    from ysmr_tpu.ops import assignment as asg
    from ysmr_tpu.parallel import sharding as shd
    from ysmr_tpu.utils.parity import compare_rows, read_list_csv

    clips = []
    for k in range(4):
        path = os.path.join(OUT, 'four_clip_{}.avi'.format(k))
        if not os.path.isfile(path):
            bench.make_clip(path, FOUR_CLIP_FRAMES, seed=bench.SEED + 10 + k)
        clips.append(path)
    settings = stage1_only(smoke_settings(), **{'transfer mode': 'frames'})
    with Phase('four/solo') as ph:
        solo = {c: run_ysmr(c, os.path.join(OUT, 'four_solo'), settings)
                for c in clips}
        ph.result = 'rows {}'.format([d.shape[0] for d in solo.values()])
    with Phase('four/sharded') as ph:
        folder = os.path.join(OUT, 'four_sharded')
        finished = ysmr(paths=clips, settings=dict(
            settings, **{'shard videos across devices': True}),
            result_folder=folder)
        assert finished and all(r is not None for _, r in finished)
        same = []
        for c in clips:
            name = os.path.splitext(os.path.basename(c))[0] + '_list.csv'
            strict, detail = compare_rows(
                read_list_csv(os.path.join(folder, name)), solo[c], atol=0.0)
            same.append(bool(strict))
            assert strict, (c, detail)
        ph.result = 'identical to solo: {}'.format(same)
    with Phase('four/dense_assign') as ph:
        mesh = shd.make_mesh(4, axis='slots')
        rng = np.random.default_rng(0)
        r, c = 16384, 4096
        obj = rng.uniform(0, 1228, (r, 2)).astype(np.float32)
        det = rng.uniform(0, 1228, (c, 2)).astype(np.float32)
        ov = rng.random(r) < 0.8
        dv = rng.random(c) < 0.9
        got = shd.sharded_greedy_assign(mesh, shd.shard_videos(mesh, obj),
                                        shd.shard_videos(mesh, ov), det, dv)
        want = asg.greedy_assign(asg.pairwise_distances(
            jnp.asarray(obj), jnp.asarray(ov), jnp.asarray(det),
            jnp.asarray(dv)), jnp.asarray(ov), jnp.asarray(dv))
        for key in ('row_to_col', 'col_matched'):
            assert np.array_equal(np.asarray(got[key]), np.asarray(want[key]))
        ph.result = '{} slots x {} detections: identical to greedy_assign' \
            .format(r, c)


def main(argv):
    if argv[:1] == ['--cpu-run']:
        return cpu_run(*argv[1:4])
    four = '--four' in argv
    global OUT
    if os.path.exists(SUMMARY):
        os.remove(SUMMARY)
    with Phase('device') as ph:
        devices = require_gpu(4 if four else 1)
        import jax
        jax.monitoring.register_event_duration_secs_listener(_on_duration)
        info = card_info()
        ph.result = '{} x {}'.format(len(devices), devices[0].device_kind)
    say('card: {}'.format(info))
    say('jax {}'.format(jax.__version__))
    sys.path.insert(0, REPO)
    import ysmr_tpu  # noqa: F401  (compile cache, package import)
    OUT = tempfile.mkdtemp(prefix='chip_smoke_')
    try:
        run_phases(four, devices, jax)
    finally:
        shutil.rmtree(OUT, ignore_errors=True)
    say('card: {}'.format(info))
    print(result_line(devices))


def run_phases(four, devices, jax):
    if four:
        phase_four(devices)
    else:
        from ysmr_tpu import native
        with Phase('build') as ph:
            built, msg = native.build()
            ph.result = 'native library built: {} ({}), avdec: {}'.format(
                built, msg, native.avdec_available())
            assert built and native.available(), msg
        with Phase('numerics') as ph:
            ph.result = phase_numerics()
        import bench
        from ysmr_tpu.pipeline.track_bacteria import device_path_flags
        flags = device_path_flags({}, jax.default_backend())
        say('device path flags: {}'.format(flags))
        clip = os.path.join(OUT, 'bench_clip.avi')
        prefix = os.path.join(OUT, 'bench_prefix.avi')
        with Phase('clip') as ph:
            bench.make_clip(clip, bench.N_FRAMES)
            bench.make_clip(prefix, PREFIX_FRAMES)
            import hashlib
            with open(clip, 'rb') as f:
                ph.result = 'md5 {}'.format(hashlib.md5(f.read()).hexdigest())
        modes = phase_full(clip, os.path.join(REPO, 'bench_data',
                                              'bench_clip_list.csv.gz'),
                           flags)
        phase_cpu(prefix, modes)


if __name__ == '__main__':
    main(sys.argv[1:])

"""Child process for tests/test_distributed_mesh.py.

Joins a 2-process CPU-backend JAX cluster (a real cross-process mesh — the
multi-host shape of SURVEY.md section 5's distributed backend, exercised
on one machine), runs ONE sharded multi-video detect+track step over the GLOBAL
8-device mesh, and byte-compares the per-video emissions of its own
addressable shards against the parent's solo single-process reference.

Exit codes: 0 = shards match, 3 = mismatch, other = infrastructure failure
(the parent turns coordination-service failures into a skip).
"""

import os
import sys


def main():
    ref_path = sys.argv[1]
    # pin the CPU backend before anything initialises one
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 4)

    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from ysmr_tpu.parallel import sharding as shd

    assert shd.init_distributed(), 'no YSMR_DIST_* configuration'
    assert jax.process_count() == 2, jax.process_count()
    mesh = shd.make_mesh()
    assert mesh.devices.size == 8, mesh  # 2 processes x 4 local devices

    ref = np.load(ref_path)
    frames = ref['frames']  # (V, T, H, W, 3) uint8
    valid = ref['valid']    # (V, T) bool

    from jax.sharding import NamedSharding
    from ysmr_tpu.pipeline import tracker as trk

    def global_put(arr):
        sharding = NamedSharding(mesh, shd.video_pspec(mesh, arr.ndim))
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx])

    state0 = jax.tree_util.tree_map(
        np.asarray, trk.init_tracker_state(int(ref['max_slots']), dims=2))
    state = jax.tree_util.tree_map(
        lambda x: global_put(np.stack([x] * frames.shape[0])), state0)

    step = shd.make_multi_video_step(
        mesh,
        detect_kwargs=dict(mode='adaptive_double', white_on_dark=True,
                           offset=float(ref['offset']), double_delta=2.0,
                           max_det=int(ref['max_det']), max_bh=8,
                           cc_iters=8, include_luminosity=False, lum_win=3),
        tracker_kwargs=dict(max_disappeared=30.0, use_gsff=False),
        emit_counts=True)
    _, emissions = step(global_put(frames), global_put(valid), state)

    rc = 0
    for key in ('mask', 'ids', 'pos', 'n_components'):
        got = emissions[key]
        want = ref['em_' + key]
        for shard in got.addressable_shards:
            if not np.array_equal(np.asarray(shard.data), want[shard.index]):
                print('MISMATCH', key, shard.index, file=sys.stderr)
                rc = 3
    print('child %d checked %d arrays over %d local shards: %s' % (
        jax.process_index(), 4,
        len(emissions['mask'].addressable_shards),
        'MISMATCH' if rc else 'ok'), file=sys.stderr)
    sys.exit(rc)


if __name__ == '__main__':
    main()

"""Numerics on the card: device results vs host oracles at full width.

Marked ``card``: each test takes the ``gpu`` fixture, which skips on a host
without an NVIDIA GPU. ``chip_smoke.py`` runs them on the card (phase
'numerics'). What they hold the device to:

* the bit-exact recipes (gray, 3x3 blur, adaptive thresholds) on full
  1228x922 frames, bit-equal to OpenCV and the native host recipe;
* the cv2-exact centres (ops/cv2_centers.py, the ``_dot2`` two-rounding
  arithmetic) on a full batch's components, bit-equal to the host replica
  of cv2's chain (ops/cv2_exact.py);
* the device tracker's double-single GSFF bank (ops/ds.py) at 1024 slots
  and 512 detections, against the float64 host tracker
  (native/tracker64.cpp) at tests/test_gsff.py's tolerance;
* each XLA form that replaced a hand-written kernel, against the
  numpy/scipy oracles of tests/oracles.py at full width.
"""

import time

import cv2
import numpy as np
import pytest

import oracles

pytestmark = pytest.mark.card

H, W = 922, 1228


def _timed(label, fn, *args):
    """Run ``fn`` twice; print the first (compiling) and second call."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t2 = time.perf_counter()
    print('  {}: first call {:.3f} s, second {:.3f} s'.format(
        label, t1 - t0, t2 - t1))
    return out


def _frames(rng, t, n_bugs=200):
    """Full-width BGR frames like the bench clip: noise + bright rods."""
    frames = np.empty((t, H, W, 3), np.uint8)
    for i in range(t):
        img = rng.normal(40, 4, (H, W)).clip(0, 255).astype(np.uint8)
        for _ in range(n_bugs):
            cv2.ellipse(img, (int(rng.integers(5, W - 5)),
                              int(rng.integers(5, H - 5))),
                        (4, 2), float(rng.uniform(0, 180)), 0, 360, 200, -1)
        frames[i] = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    frames[-1] = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    return frames


def _host_masks(frame, offset=5, delta=2.0):
    """The native host recipe's (mask, marker) images for one frame."""
    from ysmr_tpu.io.preproc import HostPreprocessor
    pre = HostPreprocessor({'white bacteria on dark background': True,
                            'threshold offset for detection': offset,
                            'adaptive double threshold': delta,
                            'include luminosity in tracking calculation':
                                False,
                            'color filter': cv2.COLOR_BGR2GRAY},
                           30.0, max_fg=H * W)
    out = pre(frame)
    packed = out['px_packed'][:out['count']]
    lin = packed & np.uint32(0x7FFFFFFF)
    mask = np.zeros(H * W, bool)
    marker = np.zeros(H * W, bool)
    mask[lin] = True
    marker[lin[(packed >> np.uint32(31)) > 0]] = True
    return mask.reshape(H, W), marker.reshape(H, W)


def test_preprocess_full_frame_bit_exact(gpu, native_lib):
    """Gray and blur bit-equal to OpenCV; both adaptive thresholds
    bit-equal to the native host recipe on bench-like frames. On the
    pure-noise frame the device sum and the host's fused multiply-add
    chain may round an exact tie apart (ops/preprocess.py
    adaptive_gaussian_mean): at most 16 of its 1.13M pixels may differ."""
    from ysmr_tpu.ops import preprocess as pp
    from ysmr_tpu.pipeline import detect as det
    rng = np.random.default_rng(0)
    frames = _frames(rng, 4)
    gray, blurred = _timed('gray+blur', det.prepare_batch, frames)
    mask, markers = _timed(
        'adaptive double threshold',
        lambda b: pp.detect_masks(b, 'adaptive_double', 5, 2.0, True),
        blurred)
    gray, blurred, mask, markers = map(np.asarray,
                                       (gray, blurred, mask, markers))
    for i, f in enumerate(frames):
        g = cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
        assert np.array_equal(gray[i].astype(np.uint8), g), i
        assert np.array_equal(blurred[i].astype(np.uint8),
                              cv2.GaussianBlur(g, (3, 3), 0)), i
        host_mask, host_marker = _host_masks(f)
        diff = int((mask[i] != host_mask).sum() +
                   (markers[i] != host_marker).sum())
        print('  frame {}: {} threshold pixels differ from the host '
              'recipe'.format(i, diff))
        assert diff <= (16 if i == len(frames) - 1 else 0), (i, diff)


def test_cv2_centers_full_batch_bit_exact(gpu):
    """Every rod component of a 64-frame batch: device cv2 centres ==
    the host replica of cv2's contour -> minAreaRect chain (its f32
    centre; ops/cv2_exact.py, fuzzed against OpenCV in test_cv2_exact.py)."""
    import jax.numpy as jnp
    from ysmr_tpu.ops import cv2_exact
    from ysmr_tpu.ops.cv2_centers import cv2_centers_standalone, inv_sqrt_table
    rng = np.random.default_rng(1)
    r = 64
    blobs = []
    for _ in range(64 * 200):
        img = np.zeros((r, r), np.uint8)
        cv2.ellipse(img, (32, 32), (int(rng.integers(3, 12)),
                                    int(rng.integers(1, 4))),
                    float(rng.uniform(0, 180)), 0, 360, 255, -1)
        ys, xs = np.nonzero(img)
        off = rng.integers(0, (W - r, H - r))
        blobs.append((xs + off[0], ys + off[1]))
    d = len(blobs)
    rmin = np.full((d, r), 1 << 30, np.int32)
    rmax = np.full((d, r), -(1 << 30), np.int32)
    min_y = np.zeros(d, np.int32)
    for i, (xs, ys) in enumerate(blobs):
        min_y[i] = ys.min()
        for y in np.unique(ys):
            rmin[i, y - ys.min()] = xs[ys == y].min()
            rmax[i, y - ys.min()] = xs[ys == y].max()
    tab = inv_sqrt_table(256, r)
    cx, cy, ok = map(np.asarray, _timed(
        'cv2 centres, {} components'.format(d),
        lambda *a: cv2_centers_standalone(*a, tab, max_bh=r),
        jnp.asarray(rmin), jnp.asarray(rmax), jnp.asarray(rmin < (1 << 30)),
        jnp.asarray(min_y)))
    assert ok.all()
    bad = []
    for i, (xs, ys) in enumerate(blobs):
        (rcx, rcy), *_ = cv2_exact.rect_from_component_pixels(xs, ys)
        if not (np.float32(rcx) == cx[i] and np.float32(rcy) == cy[i]):
            bad.append(i)
    assert not bad, '{} of {} centres differ, first {}'.format(
        len(bad), d, bad[:5])


def test_gsff_bank_vs_float64_tracker(gpu, native_lib):
    """Device tracker + double-single GSFF at 1024 slots / 512 detections
    vs the float64 host tracker on the same stream (noisy tracks on a
    grid, one shared velocity, so matching is unambiguous)."""
    from ysmr_tpu.ops import gsff as gsff_ops
    from ysmr_tpu.pipeline import tracker as trk
    rng = np.random.default_rng(2)
    fps, t_len, n, slots = 30.0, 70, 512, 1024
    gx, gy = np.meshgrid(np.arange(32) * 36.0 + 20, np.arange(16) * 36.0 + 20)
    start = np.stack([gx.ravel(), gy.ravel()], 1)[:n]
    t = np.arange(t_len)[:, None, None] / fps
    meas = start[None] + t * np.array([45.0, -30.0]) + \
        rng.normal(0, 0.8, (t_len, n, 2)) + np.array([0.0, 300.0])
    rects = np.zeros((t_len, n, 5), np.float32)
    rects[..., :2] = meas
    rects[..., 2:4] = (4.0, 2.0)
    valid = np.ones((t_len, n), bool)
    params = gsff_ops.GSFFParams(fps=fps, n_min=0, n_max=30, n_f=3)
    state = trk.init_tracker_state(slots, dims=2, use_gsff=True,
                                   gsff_params=params)
    _, em = _timed(
        'tracker scan + GSFF, {} slots'.format(slots),
        lambda *a: trk.run_tracker_scan(
            *a, max_disappeared=fps, use_gsff=True, gsff_gains=params.gains,
            gsff_n_i=params.n_i_arr, gsff_n_f=params.n_f,
            gsff_n_i0=params.n_i[0]),
        state, rects[..., :2], rects[..., 2:], valid)
    mask, ids, pos = (np.asarray(em[k]) for k in ('mask', 'ids', 'pos'))
    host = native_lib.Tracker64(dims=2, max_disappeared=fps,
                                gsff_params=params)
    rows = host.update_batch(rects, valid, frame0=0)
    ref = np.full((t_len, n, 2), np.nan)
    ref[rows['POSITION_T'], rows['TRACK_ID']] = np.stack(
        [rows['POSITION_X'], rows['POSITION_Y']], 1)
    got = np.full((t_len, n, 2), np.nan)
    tt, ss = np.nonzero(mask)
    got[tt, ids[tt, ss]] = pos[tt, ss, :2]
    assert not np.isnan(ref).any() and not np.isnan(got).any()
    err = np.abs(got - ref)
    print('  GSFF |device - float64|: median {:.3g} px, max {:.3g} px'.format(
        np.median(err), err.max()))
    assert np.median(err) < 2e-3, np.median(err)
    assert err.max() < 0.05, err.max()


@pytest.mark.parametrize('connectivity', [4, 8])
def test_label_components_full_frame(gpu, connectivity):
    mask, _ = oracles.blob_masks(np.random.default_rng(3), 1, H, W,
                                 n_blobs=400)
    oracles.check_label_components(mask[0], connectivity)


def test_binary_reconstruct_full_batch(gpu):
    mask, marker = oracles.blob_masks(np.random.default_rng(4), 64, H, W,
                                      n_blobs=200)
    _timed('binary_reconstruct 64x922x1228',
           lambda: oracles.lb.binary_reconstruct(mask, marker).block_until_ready())
    oracles.check_binary_reconstruct(mask, marker)


@pytest.mark.parametrize('path', ['scatter', 'sorted', 'runs'])
def test_pixel_path_full_width(gpu, path):
    mask, marker = oracles.blob_masks(np.random.default_rng(5), 8, H, W,
                                      n_blobs=300)
    oracles.check_pixel_path(mask, marker, double=True, path=path)


@pytest.mark.parametrize('r,c', [(1024, 512), (16384, 4096)])
def test_row_min_argmin_full_capacity(gpu, r, c):
    obj, ov, det, dv = oracles.random_tracks(np.random.default_rng(6), r, c,
                                             2)
    _timed('row min/argmin {}x{}'.format(r, c),
           lambda: oracles._row_min_argmin(obj, ov, det, dv)[0]
           .block_until_ready())
    near_ties = oracles.check_row_min_argmin(obj, ov, det, dv)
    print('  {} near-tie rows of {}'.format(near_ties, r))


def test_hull_and_extents_4096_detections(gpu):
    rng = np.random.default_rng(7)
    oracles.check_min_area_rect(*oracles.blob_hull_tables(rng, 4096, 32))
    pts = rng.uniform(0, 1228, (4096, 64, 2)).astype(np.float32)
    valid = rng.random((4096, 64)) < 0.7
    ux = rng.integers(1, 40, (4096, 63)).astype(np.float32)
    uy = rng.integers(0, 40, (4096, 63)).astype(np.float32)
    oracles.check_projected_extents(pts, valid, ux, uy)

"""Independent numpy/scipy oracles for the XLA device paths.

Shared by the CPU tests (tests/test_xla_paths.py, small shapes) and the
card tests (tests/test_on_card.py, full widths): each ``check_*`` runs the
production XLA form on the default device and asserts it against a
straightforward host implementation of the same semantics.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
from scipy import ndimage

from ysmr_tpu.ops import assignment as asg
from ysmr_tpu.ops import labeling as lb
from ysmr_tpu.ops import run_cc

STRUCT4 = ndimage.generate_binary_structure(2, 1)
STRUCT8 = ndimage.generate_binary_structure(2, 2)


def same_partition(a, b):
    """True when two label arrays induce the same partition."""
    m1, m2 = {}, {}
    for x, y in zip(np.asarray(a).ravel().tolist(),
                    np.asarray(b).ravel().tolist()):
        if m1.setdefault(x, y) != y or m2.setdefault(y, x) != x:
            return False
    return True


def blob_masks(rng, t, h, w, n_blobs=12, r_max=6, marker_every=2):
    """(T, H, W) mask and marker stacks of rotated-ellipse blobs; markers
    are single pixels inside every ``marker_every``-th blob."""
    mask = np.zeros((t, h, w), np.uint8)
    marker = np.zeros((t, h, w), np.uint8)
    for i in range(t):
        for k in range(n_blobs):
            c = (int(rng.integers(r_max, w - r_max)),
                 int(rng.integers(r_max, h - r_max)))
            a = int(rng.integers(2, r_max + 1))
            b = int(rng.integers(1, max(2, a)))
            cv2.ellipse(mask[i], c, (a, b), int(rng.integers(0, 180)), 0,
                        360, 255, -1)
            if k % marker_every == 0:
                marker[i, c[1], c[0]] = 255
    mask = mask > 0
    return mask, (marker > 0) & mask


def random_tracks(rng, r, c, k, frame=1228.0):
    """Slot and detection tables with invalid entries and one planted exact
    tie (columns 3 and 4 coincide)."""
    obj = rng.uniform(0, frame, (r, k)).astype(np.float32)
    det = rng.uniform(0, frame, (c, k)).astype(np.float32)
    ov = rng.random(r) < 0.8
    dv = rng.random(c) < 0.8
    ov[0] = False
    dv[:2] = False
    if c > 4:
        det[3] = det[4]
        dv[3] = dv[4] = True
    return obj, ov, det, dv


@jax.jit
def _row_min_argmin(obj, ov, det, dv):
    d = asg.pairwise_distances(obj, ov, det, dv)
    return jnp.min(d, axis=1), jnp.argmin(d, axis=1)


def check_row_min_argmin(obj, ov, det, dv):
    """Row min/argmin of the masked distance matrix vs float64 numpy:
    minima within f32 rounding, argmin identical except on rows whose two
    nearest detections tie within f32 rounding. Returns the count of such
    near-tie rows."""
    got_min, got_arg = map(np.asarray, _row_min_argmin(obj, ov, det, dv))
    d64 = np.sqrt(((obj[:, None, :].astype(np.float64) -
                    det[None, :, :].astype(np.float64)) ** 2).sum(-1))
    d64 = np.where(ov[:, None] & dv[None, :], d64, np.inf)
    rows = ov & dv.any()
    np.testing.assert_allclose(got_min[rows], d64[rows].min(1), rtol=1e-5,
                               atol=1e-3)
    assert (got_min[~rows] == asg.BIG).all()
    assert (got_arg[~rows] == 0).all()
    planted = det.shape[0] > 4 and dv[3] and (det[3] == det[4]).all()
    d_tie = d64.copy()
    if planted:
        # the planted exact tie: the first of the two equal columns must win
        # on both sides, so it is checked as a column of its own
        d_tie[:, 4] = np.inf
    part = np.partition(d_tie[rows], 1, axis=1)
    tie = (part[:, 1] - part[:, 0]) <= 1e-5 * part[:, 0] + 1e-3
    ref_arg = d64[rows].argmin(1)
    assert np.array_equal(got_arg[rows][~tie], ref_arg[~tie])
    if planted:
        assert not (got_arg[rows] == 4).any()
    return int(tie.sum())


def check_label_components(mask, connectivity):
    """Whole-frame min-label CC vs scipy.ndimage.label: identical
    partitions of the foreground, background marked h*w."""
    h, w = mask.shape
    got = np.asarray(lb.label_components(jnp.asarray(mask),
                                         connectivity=connectivity,
                                         max_iters=max(h, w) * 2))
    ref, _ = ndimage.label(mask, structure=STRUCT8 if connectivity == 8
                           else STRUCT4)
    assert (got[~mask] == h * w).all()
    assert same_partition(got[mask], ref[mask])


def check_binary_reconstruct(mask, marker, max_iters=64):
    """Bit-packed reconstruction vs scipy.ndimage.binary_propagation,
    frame by frame."""
    got = np.asarray(lb.binary_reconstruct(jnp.asarray(mask),
                                           jnp.asarray(marker),
                                           max_iters=max_iters))
    for i in range(mask.shape[0]):
        want = ndimage.binary_propagation(marker[i], mask=mask[i])
        assert np.array_equal(got[i], want), i


def check_projected_extents(pts, valid, ux, uy):
    """Rotated extents of candidate points vs float64 numpy."""
    big = np.float32(3.0e38)
    got = [np.asarray(a) for a in lb._projected_extents(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(ux),
        jnp.asarray(uy), jnp.float32(big))]
    p = pts.astype(np.float64)
    u = (p[:, None, :, 0] * ux[:, :, None] + p[:, None, :, 1] * uy[:, :, None])
    v = (p[:, None, :, 1] * ux[:, :, None] - p[:, None, :, 0] * uy[:, :, None])
    vm = valid[:, None, :]
    ref = [np.where(vm, u, np.inf).min(-1), np.where(vm, u, -np.inf).max(-1),
           np.where(vm, v, np.inf).min(-1), np.where(vm, v, -np.inf).max(-1)]
    scale = np.abs(p).max() * (np.abs(ux).max() + np.abs(uy).max())
    for name, g, r in zip(('min_u', 'max_u', 'min_v', 'max_v'), got, ref):
        fin = np.isfinite(r)
        np.testing.assert_allclose(g[fin], r[fin], rtol=0,
                                   atol=scale * 2e-7 + 1e-6, err_msg=name)
        assert (np.abs(g[~fin]) == big).all(), name


def blob_hull_tables(rng, d, max_bh):
    """Row-extreme tables of ``d`` random convex-ish blobs (components of
    random rotated ellipses), plus their pixel sets for the oracle."""
    row_min = np.full((d, max_bh), 1 << 30, np.int32)
    row_max = np.full((d, max_bh), -(1 << 30), np.int32)
    min_y = np.zeros(d, np.int32)
    pix = []
    for i in range(d):
        img = np.zeros((max_bh, 64), np.uint8)
        a = int(rng.integers(2, min(12, max_bh // 2)))
        b = int(rng.integers(1, max(2, a)))
        cv2.ellipse(img, (32, max_bh // 2), (a, b), int(rng.integers(0, 180)),
                    0, 360, 255, -1)
        ys, xs = np.nonzero(img)
        y0 = int(rng.integers(0, 800))
        x0 = int(rng.integers(0, 1100))
        for y in np.unique(ys):
            row = xs[ys == y]
            row_min[i, y - ys.min()] = row.min() + x0
            row_max[i, y - ys.min()] = row.max() + x0
        min_y[i] = ys.min() + y0
        pix.append(np.stack([xs + x0, ys - ys.min() + min_y[i]], 1))
    return row_min, row_max, row_min < (1 << 30), min_y, pix


def check_min_area_rect(row_min, row_max, row_valid, min_y, pix):
    """Exact min-area rectangle (hull-edge candidates, rotated extents) vs a
    float64 rotating-calipers oracle over scipy's convex hull: the areas
    agree to 1e-6 relative and match cv2.minAreaRect's area."""
    from scipy.spatial import ConvexHull
    tables = lb._stats_tail_from_tables(
        jnp.asarray(row_min), jnp.asarray(row_max), jnp.asarray(row_valid),
        jnp.asarray(min_y), max_det=row_min.shape[0],
        max_bh=row_min.shape[1])
    rect = lb.min_area_rect(tables['points'], tables['points_valid'],
                            edge_angles=tables['edge_angles'],
                            edge_valid=tables['edge_valid'],
                            edge_dx=tables['edge_dx'],
                            edge_dy=tables['edge_dy'])
    area = np.asarray(rect['w']).astype(np.float64) * np.asarray(rect['h'])
    for i, p in enumerate(pix):
        p = p.astype(np.float64)
        if len(np.unique(p[:, 0])) < 2 or len(np.unique(p[:, 1])) < 2:
            want = (np.ptp(p[:, 0])) * (np.ptp(p[:, 1]))
        else:
            hull = p[ConvexHull(p).vertices]
            edges = np.roll(hull, -1, 0) - hull
            best = np.inf
            for e in edges:
                n = np.hypot(*e)
                u = hull @ (e / n)
                v = hull @ (np.array([-e[1], e[0]]) / n)
                best = min(best, np.ptp(u) * np.ptp(v))
            want = best
        assert abs(area[i] - want) <= 1e-6 * max(want, 1.0), (i, area[i],
                                                             want)
        (_, _), (cw, ch), _ = cv2.minAreaRect(p.astype(np.int32))
        assert abs(area[i] - cw * ch) <= 1e-3 * max(want, 1.0), i


def encode_runs(img, marker=None, r=1024):
    """Mask (+ marker subset) -> (1, R) run wire via the numpy encoder."""
    from ysmr_tpu import native
    h, w = img.shape
    yy, xx = np.nonzero(img)
    lin = (yy * w + xx).astype(np.uint32)
    mk = np.zeros(len(yy), np.uint32)
    if marker is not None:
        mk = (marker[yy, xx] > 0).astype(np.uint32)
    packed = (lin | (mk << 31)).astype(np.uint32)[None, :]
    buf = np.zeros((1, max(packed.shape[1], 4)), np.uint32)
    buf[0, :packed.shape[1]] = packed
    counts = np.array([packed.shape[1]], np.int32)
    runs = np.zeros((1, r), np.uint32)
    rcnt = np.zeros(1, np.int32)
    ret = native.encode_runs_numpy(buf, counts, runs, rcnt, w=w)
    assert ret is not None and ret >= 0
    return runs, rcnt


def run_pixels(runs, rcnt, w):
    """Per-run (rows, xs, lens) of the valid runs of frame 0."""
    geo = {k: np.asarray(v)[0] for k, v in
           run_cc.decode_runs(runs, rcnt, w).items()}
    n = int(rcnt[0])
    return geo['rows'][:n], geo['xs'][:n], geo['lens'][:n]


def check_run_fixpoint(img, marker):
    """Run-graph min fixpoint vs scipy: the strong init partitions runs as
    scipy.ndimage.label (8-connected) does, the weak/strong init keeps
    exactly the runs binary_propagation (4-connected) keeps."""
    h, w = img.shape
    runs, rcnt = encode_runs(img, marker)
    rows, xs, lens = run_pixels(runs, rcnt, w)
    n = len(rows)
    lab8 = np.asarray(run_cc.label_runs(runs, rcnt, w=w, connectivity=8,
                                        max_iters=4 * (h + w)))[0, :n]
    ref8, _ = ndimage.label(img, structure=STRUCT8)
    assert same_partition(lab8, ref8[rows, xs])
    keep = np.asarray(run_cc.keep_marked_runs(runs, rcnt, w=w,
                                              max_iters=4 * (h + w)))[0, :n]
    want = ndimage.binary_propagation(marker, mask=img)
    assert np.array_equal(keep, want[rows, xs])
    return n


def check_run_cc_components(img, marker):
    """run_cc_components (reconstruction + 8-connected CC) vs scipy:
    surviving runs and their component partition."""
    h, w = img.shape
    runs, rcnt = encode_runs(img, marker)
    rows, xs, lens = run_pixels(runs, rcnt, w)
    n = len(rows)
    out = run_cc.run_cc_components(runs, rcnt, w=w, double_threshold=True,
                                   max_iters=4 * (h + w))
    comp = np.asarray(out['run_comp'])[0, :n]
    kept = ndimage.binary_propagation(marker, mask=img)
    ref, n_ref = ndimage.label(kept, structure=STRUCT8)
    assert int(np.asarray(out['n_components'])[0]) == n_ref
    assert np.array_equal(comp >= 0, kept[rows, xs])
    alive = comp >= 0
    assert same_partition(comp[alive], ref[rows, xs][alive])


def pixel_wire(mask, marker):
    """(T, H, W) mask + marker -> packed pixel wire (T, F) and counts:
    raster-order ``y*w + x`` with the marker in bit 31."""
    t, h, w = mask.shape
    f = max(int(mask.reshape(t, -1).sum(1).max()), 4)
    packed = np.zeros((t, f), np.uint32)
    counts = np.zeros(t, np.int32)
    for i in range(t):
        yy, xx = np.nonzero(mask[i])
        lin = (yy * w + xx).astype(np.uint32)
        mk = marker[i, yy, xx].astype(np.uint32)
        packed[i, :len(lin)] = lin | (mk << 31)
        counts[i] = len(lin)
    return packed, counts


def check_pixel_path(mask, marker, *, double, path, max_det=512,
                     cc_iters=64):
    """Pixels-mode labeling (detect_from_pixels, labels only) vs scipy on
    every frame: component count and the per-pixel partition of the kept
    pixels. ``path``: 'scatter' (scatter/gather compaction), 'sorted'
    (sort_compact) or 'runs' (run-graph CC on the run wire)."""
    from ysmr_tpu import native
    from ysmr_tpu.pipeline.detect_pixels import detect_from_pixels
    t, h, w = mask.shape
    packed, counts = pixel_wire(mask, marker)
    kw = dict(h=h, w=w, double_threshold=double, max_det=max_det, max_bh=32,
              cc_iters=cc_iters, return_det_px=True, skip_rect=True,
              sort_compact=path == 'sorted')
    fv = np.ones(t, bool)
    if path == 'runs':
        f = packed.shape[1]
        runs = np.zeros((t, f), np.uint32)
        rcnt = np.zeros(t, np.int32)
        assert native.encode_runs_numpy(packed, counts, runs, rcnt, w=w) >= 0
        out = detect_from_pixels(None, None, counts, None, fv, px_runs=runs,
                                 run_counts=rcnt, expanded_f=f,
                                 use_run_cc=True, **kw)
    else:
        out = detect_from_pixels(None, None, counts, None, fv,
                                 px_packed=packed, **kw)
    det_px = np.asarray(out['det_px_idx'])
    n_comp = np.asarray(out['n_components'])
    for i in range(t):
        kept = ndimage.binary_propagation(marker[i], mask=mask[i]) \
            if double else mask[i]
        ref, n_ref = ndimage.label(kept, structure=STRUCT8)
        assert int(n_comp[i]) == n_ref, (i, int(n_comp[i]), n_ref)
        yy, xx = np.nonzero(mask[i])
        got = det_px[i, :len(yy)]
        assert np.array_equal(got >= 0, kept[yy, xx]), i
        alive = got >= 0
        assert same_partition(got[alive], ref[yy, xx][alive]), i

"""Fuzz the device cv2-center replica against the pure-Python cv2 oracle.

The oracle (``ops/cv2_exact.rect_from_component_pixels``) traces the
contour and runs the bit-exact convexHull + rotating-calipers replica of
cv2.minAreaRect (itself fuzzed against OpenCV in test_cv2_exact.py).  The
device path (``ops/cv2_centers``) must reproduce its CENTER bit-for-bit
from the per-row x-extreme tables alone for every simple (non-self-
touching) component; self-touching contours (1-px-wide pinches) make
cv2's own hull quirky — fuzzing bounds that residual class instead.
"""
import numpy as np
import pytest

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from ysmr_tpu.ops import cv2_exact as oracle
from ysmr_tpu.ops.cv2_centers import cv2_centers_standalone, inv_sqrt_table

R = 96
MAX_EDGE_W = 256


def random_blob(rng, max_side=24):
    kind = rng.integers(0, 4)
    if kind == 0:  # rotated rod (the real data shape)
        w = rng.uniform(2, max_side)
        h = rng.uniform(1, max_side / 3)
        ang = rng.uniform(0, np.pi)
        cx, cy = rng.uniform(30, 60, 2)
        ca, sa = np.cos(ang), np.sin(ang)
        ys, xs = np.mgrid[0:96, 0:96]
        u = (xs - cx) * ca + (ys - cy) * sa
        v = -(xs - cx) * sa + (ys - cy) * ca
        m = (np.abs(u) <= w / 2) & (np.abs(v) <= h / 2)
    elif kind == 1:  # ellipse
        rx = rng.uniform(1, max_side / 2)
        ry = rng.uniform(1, max_side / 2)
        cx, cy = rng.uniform(30, 60, 2)
        ys, xs = np.mgrid[0:96, 0:96]
        m = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1
    elif kind == 2:  # random scatter, row-filled
        side = int(rng.integers(2, max_side))
        m = np.zeros((96, 96), bool)
        box = rng.random((side, side)) < rng.uniform(0.3, 0.9)
        m[30:30 + side, 30:30 + side] = box
        rows_any = m.any(axis=1)
        if rows_any.any():
            lo, hi = np.nonzero(rows_any)[0][[0, -1]]
            for r in range(lo, hi + 1):
                if not m[r].any():
                    m[r, int(rng.integers(30, 30 + side))] = True
    else:  # axis-aligned rect (tie-heavy)
        w = int(rng.integers(1, 8))
        h = int(rng.integers(1, 8))
        m = np.zeros((96, 96), bool)
        m[40:40 + h, 40:40 + w] = True
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return random_blob(rng, max_side)
    from scipy import ndimage
    lab, _ = ndimage.label(m, structure=np.ones((3, 3), int))
    order = np.lexsort((xs, ys))
    keep = lab == lab[ys[order[0]], xs[order[0]]]
    ys, xs = np.nonzero(m & keep)
    return xs, ys


def thin_rod(rng):
    L = rng.uniform(3, 20)
    wdt = rng.uniform(0.8, 2.5)
    ang = rng.uniform(0, np.pi)
    cx, cy = rng.uniform(30, 60, 2)
    ca, sa = np.cos(ang), np.sin(ang)
    ys, xs = np.mgrid[0:96, 0:96]
    u = (xs - cx) * ca + (ys - cy) * sa
    v = -(xs - cx) * sa + (ys - cy) * ca
    m = (np.abs(u) <= L / 2) & (np.abs(v) <= wdt / 2)
    ys, xs = np.nonzero(m)
    if len(xs) == 0:
        return thin_rod(rng)
    from scipy import ndimage
    lab, _ = ndimage.label(m, structure=np.ones((3, 3), int))
    order = np.lexsort((xs, ys))
    keep = lab == lab[ys[order[0]], xs[order[0]]]
    ys, xs = np.nonzero(m & keep)
    return xs, ys


def is_degenerate(xs, ys):
    """The traced contour revisits a point (self-touching boundary)."""
    x0, y0 = xs.min(), ys.min()
    mask = np.zeros((ys.max() - y0 + 1, xs.max() - x0 + 1), np.uint8)
    mask[ys - y0, xs - x0] = 1
    order = np.lexsort((xs, ys))
    cont = oracle.trace_contour(mask, int(ys[order[0]] - y0),
                                int(xs[order[0]] - x0))
    return len(set(cont)) != len(cont)


def tables_from_blobs(blobs):
    d = len(blobs)
    rmin = np.full((d, R), 1 << 30, np.int32)
    rmax = np.full((d, R), -(1 << 30), np.int32)
    rvalid = np.zeros((d, R), bool)
    min_y = np.zeros(d, np.int32)
    for i, (xs, ys) in enumerate(blobs):
        y0 = ys.min()
        min_y[i] = y0
        for r in np.unique(ys):
            sel = ys == r
            rmin[i, r - y0] = xs[sel].min()
            rmax[i, r - y0] = xs[sel].max()
            rvalid[i, r - y0] = True
    return rmin, rmax, rvalid, min_y


def run_device(blobs):
    rmin, rmax, rvalid, min_y = tables_from_blobs(blobs)
    tab = inv_sqrt_table(MAX_EDGE_W, R)
    cx, cy, ok = cv2_centers_standalone(
        jnp.asarray(rmin), jnp.asarray(rmax), jnp.asarray(rvalid),
        jnp.asarray(min_y), tab, max_bh=R)
    return np.asarray(cx), np.asarray(cy), np.asarray(ok)


@pytest.mark.parametrize('gen,n_cases', [('mixed', 150), ('rod', 150)])
def test_centers_bit_exact_vs_oracle(gen, n_cases):
    rng = np.random.default_rng(7 if gen == 'mixed' else 8)
    make = random_blob if gen == 'mixed' else thin_rod
    blobs = [make(rng) for _ in range(n_cases)]
    refs = [oracle.rect_from_component_pixels(xs, ys)[0] for xs, ys in blobs]
    degen = [is_degenerate(xs, ys) for xs, ys in blobs]
    cx, cy, ok = run_device(blobs)
    assert ok.all(), 'small test shapes must all take the cv2-exact path'
    clean_bad = []
    degen_bad = 0
    for i, ((rcx, rcy), dg) in enumerate(zip(refs, degen)):
        match = (np.float32(rcx) == cx[i]) and (np.float32(rcy) == cy[i])
        if match:
            continue
        if dg:
            degen_bad += 1
        else:
            clean_bad.append((i, (float(rcx), float(rcy)),
                              (float(cx[i]), float(cy[i]))))
    assert not clean_bad, \
        'simple components must be bit-exact: {}'.format(clean_bad[:5])
    # self-touching contours: cv2's own hull is quirky there; fuzz bounds
    # the residual (~0.1% of degenerate shapes historically)
    n_degen = sum(degen)
    assert degen_bad <= max(1, n_degen // 20), \
        '{} of {} degenerate shapes mismatched'.format(degen_bad, n_degen)


def test_line_and_point_components():
    blobs = []
    # single pixel
    blobs.append((np.array([40]), np.array([50])))
    # horizontal line
    blobs.append((np.arange(30, 45), np.full(15, 60)))
    # vertical line
    blobs.append((np.full(12, 33), np.arange(20, 32)))
    # perfect diagonal
    blobs.append((np.arange(10, 22), np.arange(40, 52)))
    refs = [oracle.rect_from_component_pixels(xs, ys)[0] for xs, ys in blobs]
    cx, cy, ok = run_device(blobs)
    assert ok.all()
    for i, (rcx, rcy) in enumerate(refs):
        assert np.float32(rcx) == cx[i] and np.float32(rcy) == cy[i], \
            (i, rcx, rcy, cx[i], cy[i])


def test_wide_component_falls_back():
    xs = np.tile(np.arange(0, 400), 2)
    ys = np.concatenate([np.full(400, 10), np.full(400, 11)])
    cx, cy, ok = run_device([(xs, ys)])
    # 400 px wide with MAX_EDGE_W=256: the inv-len table cannot cover the
    # closing edges -> must be flagged, caller falls back to exact centers
    assert not ok[0]


def test_production_path_matches_standalone():
    """The pipeline integration (corner masks from labeling._hull_edge_data,
    pruning areas from _min_area_rect_exact) must produce the same centers
    as the standalone path — and hence match the oracle."""
    from ysmr_tpu.ops import labeling as lb
    from ysmr_tpu.pipeline.detect_pixels import _cv2_center_override

    rng = np.random.default_rng(99)
    blobs = [random_blob(rng) for _ in range(60)] + \
        [thin_rod(rng) for _ in range(60)]
    # pack all blobs into one synthetic frame's pixel lists, one component
    # per blob (disjoint ids)
    max_det = 128
    xs_all, ys_all, seg_all = [], [], []
    for i, (xs, ys) in enumerate(blobs):
        # offset blobs apart so absolute coords differ per component
        xs_all.append(xs + 200 * (i % 8))
        ys_all.append(ys + 120 * (i // 8))
        seg_all.append(np.full(len(xs), i, np.int32))
    xs_all = np.concatenate(xs_all).astype(np.int32)
    ys_all = np.concatenate(ys_all).astype(np.int32)
    seg_all = np.concatenate(seg_all)
    active = np.ones(len(xs_all), bool)
    tables = lb.component_stats(
        jnp.asarray(xs_all), jnp.asarray(ys_all), jnp.asarray(seg_all),
        jnp.asarray(active), max_det=max_det, max_bh=R, cv2_centers=True)
    rect = lb.min_area_rect(tables['points'], tables['points_valid'],
                            edge_angles=tables['edge_angles'],
                            edge_valid=tables['edge_valid'],
                            edge_dx=tables['edge_dx'],
                            edge_dy=tables['edge_dy'])
    # batched override contract: (T, D, ...) with T=1
    rect_b = {kk: v[None] for kk, v in rect.items()}
    tabs_b = {kk: tables[kk][None] for kk in
              ('row_min_x', 'row_max_x', 'row_valid', 'min_y',
               'corner_l', 'corner_r')}
    rect = _cv2_center_override(rect_b, tabs_b, max_bh=R)
    cx = np.asarray(rect['cx'])[0]
    cy = np.asarray(rect['cy'])[0]
    bad = []
    for i, (xs, ys) in enumerate(blobs):
        (rcx, rcy), _, _ = oracle.rect_from_component_pixels(
            xs + 200 * (i % 8), ys + 120 * (i // 8))
        if not (np.float32(rcx) == cx[i] and np.float32(rcy) == cy[i]):
            if not is_degenerate(xs, ys):
                bad.append((i, float(rcx), float(rcy),
                            float(cx[i]), float(cy[i])))
    assert not bad, bad[:5]

"""Connected-components + minAreaRect equivalence tests vs OpenCV/scipy."""

import cv2
import numpy as np
import pytest
from scipy.ndimage import binary_propagation

from ysmr_tpu.ops import labeling as lb


def _random_blobs(rng, h=96, w=128, n=12, r_max=6):
    """Synthetic mask with elongated blobs (rotated-ellipse strokes)."""
    img = np.zeros((h, w), np.uint8)
    for _ in range(n):
        cx, cy = rng.integers(5, w - 5), rng.integers(5, h - 5)
        ax_a = int(rng.integers(2, r_max + 1))
        ax_b = int(rng.integers(1, max(2, ax_a)))
        ang = int(rng.integers(0, 180))
        cv2.ellipse(img, (int(cx), int(cy)), (ax_a, ax_b), ang, 0, 360, 255, -1)
    return img > 0


def _cc_sets(mask, connectivity):
    n, lab = cv2.connectedComponents(mask.astype(np.uint8), connectivity=connectivity)
    comps = []
    for i in range(1, n):
        ys, xs = np.nonzero(lab == i)
        comps.append(frozenset(zip(xs.tolist(), ys.tolist())))
    return set(comps)


@pytest.mark.parametrize('connectivity', [4, 8])
def test_label_components_matches_cv2(rng, connectivity):
    mask = _random_blobs(rng)
    labels = np.asarray(lb.label_components(mask, connectivity=connectivity))
    ours = {}
    ys, xs = np.nonzero(mask)
    for x, y in zip(xs.tolist(), ys.tolist()):
        ours.setdefault(int(labels[y, x]), set()).add((x, y))
    ours_sets = set(frozenset(s) for s in ours.values())
    assert ours_sets == _cc_sets(mask, connectivity)


def test_label_worst_case_snake():
    """A long serpentine path stresses propagation depth (pointer jumping)."""
    h, w = 64, 64
    mask = np.zeros((h, w), bool)
    for r in range(0, h, 2):
        mask[r, :] = True
        if (r // 2) % 2 == 0 and r + 1 < h:
            mask[r + 1, w - 1] = True
        elif r + 1 < h:
            mask[r + 1, 0] = True
    labels = np.asarray(lb.label_components(mask, connectivity=8, max_iters=256))
    vals = np.unique(labels[mask])
    assert len(vals) == 1  # single component


def test_compact_labels_reverse_raster_order(rng):
    mask = _random_blobs(rng)
    labels = lb.label_components(mask, connectivity=8)
    comp, n = lb.compact_labels(labels, mask, max_det=64)
    comp = np.asarray(comp)
    n = int(n)
    # ids ordered by *descending* raster position of each component's first
    # pixel — cv2.findContours enumeration order
    firsts = []
    flat = comp.reshape(-1)
    for i in range(n):
        firsts.append(np.nonzero(flat == i)[0].min())
    assert firsts == sorted(firsts, reverse=True)
    assert (flat[~mask.reshape(-1)] == 64).all()


def test_propagate_markers_matches_scipy(rng):
    """The detection path's marker propagation (labeling.binary_reconstruct,
    one frame at a time) == scipy's binary_propagation."""
    for seed in range(5):
        r = np.random.default_rng(seed)
        mask = _random_blobs(r)
        strict = _random_blobs(r, n=6) & mask  # markers subset of mask
        ref = binary_propagation(strict, mask=mask)
        ours = np.asarray(lb.binary_reconstruct(mask[None], strict[None]))[0]
        assert np.array_equal(ours, ref)


def _detect_components(mask, max_det=64, max_bh=32):
    labels = lb.label_components(mask, connectivity=8)
    comp, n = lb.compact_labels(labels, mask, max_det=max_det)
    tables = lb.component_tables(comp, mask, max_det=max_det, max_bh=max_bh)
    rect = lb.min_area_rect(tables['points'], tables['points_valid'],
                            edge_angles=tables['edge_angles'],
                            edge_valid=tables['edge_valid'],
                            edge_dx=tables['edge_dx'],
                            edge_dy=tables['edge_dy'])
    return {k: np.asarray(v) for k, v in tables.items() if k != 'points'}, \
        {k: np.asarray(v) for k, v in rect.items()}, int(n)


def test_min_area_rect_matches_cv2(rng):
    for seed in range(8):
        r = np.random.default_rng(100 + seed)
        mask = _random_blobs(r)
        tables, rect, n = _detect_components(mask)
        contours, _ = cv2.findContours(mask.astype(np.uint8) * 255,
                                       cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        assert len(contours) == n
        refs = [cv2.minAreaRect(c) for c in contours]
        # match by centre proximity (enumeration order tested separately)
        used = set()
        for i in range(n):
            c_ours = np.array([rect['cx'][i], rect['cy'][i]])
            best_j, best_d = None, 1e9
            for j, ((rx, ry), _, _) in enumerate(refs):
                if j in used:
                    continue
                d = np.hypot(rx - c_ours[0], ry - c_ours[1])
                if d < best_d:
                    best_j, best_d = j, d
            assert best_d < 0.75, (i, best_d)
            used.add(best_j)
            (_, _), (rw, rh), rang = refs[best_j]
            ours_sides = sorted([rect['w'][i], rect['h'][i]])
            ref_sides = sorted([rw, rh])
            # area parity is what drives the selection gates; it must hold
            # always, including equal-area ties (see min_area_rect docstring)
            a_ours = max(ours_sides[0] * ours_sides[1], 1e-6)
            a_ref = max(ref_sides[0] * ref_sides[1], 1e-6)
            assert a_ours == pytest.approx(a_ref, rel=0.005, abs=0.05)
            tie = abs(ours_sides[0] - ref_sides[0]) > 0.12
            if not tie:  # same representative chosen -> full convention
                # parity with cv2's classic representation: angle in
                # [-90, 0), w along the angle's direction — the _list.csv
                # WIDTH/HEIGHT/DEGREES_ANGLE interchange columns
                assert -90.0 <= rect['angle_deg'][i] < 0.0
                if abs(rw - rh) > 0.12:  # w/h distinguishable, not square
                    assert rect['w'][i] == pytest.approx(rw, abs=0.12)
                    assert rect['h'][i] == pytest.approx(rh, abs=0.12)
                    assert rect['angle_deg'][i] == pytest.approx(
                        rang, abs=1.0), (i, rect['w'][i], rect['h'][i], rw, rh)
                else:
                    assert ours_sides[0] == pytest.approx(ref_sides[0],
                                                          abs=0.12)
                    assert ours_sides[1] == pytest.approx(ref_sides[1],
                                                          abs=0.12)


def test_min_area_rect_degenerate_cases():
    mask = np.zeros((32, 32), bool)
    mask[5, 5] = True                     # single pixel -> w = h = 0
    mask[10, 10:15] = True                # horizontal line -> one side 0
    mask[20:22, 20:22] = True             # 2x2 square -> 1 x 1
    tables, rect, n = _detect_components(mask)
    assert n == 3
    # enumeration is reverse raster order: [square, line, single pixel]
    assert rect['w'][2] == pytest.approx(0.0, abs=1e-4)
    assert rect['h'][2] == pytest.approx(0.0, abs=1e-4)
    sides1 = sorted([rect['w'][1], rect['h'][1]])
    assert sides1[0] == pytest.approx(0.0, abs=1e-3)
    assert sides1[1] == pytest.approx(4.0, abs=1e-2)
    sides2 = sorted([rect['w'][0], rect['h'][0]])
    assert sides2 == pytest.approx([1.0, 1.0], abs=1e-2)


def test_findcontours_enumeration_order():
    """Detection order must match the reference's contour order, which sets
    registration order and therefore TRACK_IDs."""
    for seed in range(4):
        rng = np.random.default_rng(300 + seed)
        mask = _random_blobs(rng, n=8)
        tables, rect, n = _detect_components(mask)
        contours, _ = cv2.findContours(mask.astype(np.uint8) * 255,
                                       cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        ref_centers = np.array([cv2.minAreaRect(c)[0] for c in contours])
        ours_centers = np.stack([rect['cx'][:n], rect['cy'][:n]], axis=1)
        diff = np.linalg.norm(ref_centers - ours_centers, axis=1)
        assert (diff < 0.75).all(), (seed, diff)


def test_min_area_rect_exact_tie_matches_cv2():
    """A blob whose axis-aligned and 45-degree rectangles tie at exactly
    area 36: the exact integer-arithmetic candidate comparison must detect
    the true rational tie and resolve it to the larger angle, as cv2's
    calipers does (it visits edges in increasing rotation and replaces on
    <=). Regression: the float32 sweep's area noise (~3e-3 here) used to
    break the tie the wrong way, which changed the emitted CENTRE and fed a
    different measurement into the tracker (bench-clip frame 7)."""
    pix = [(792, 227), (792, 228), (792, 229), (792, 230), (793, 226),
           (793, 227), (793, 228), (793, 229), (793, 230), (794, 225),
           (794, 226), (794, 227), (794, 228), (794, 229), (794, 230),
           (795, 224), (795, 225), (795, 226), (795, 227), (795, 228),
           (795, 229), (795, 230), (796, 224), (796, 225), (796, 226),
           (796, 227), (796, 228), (796, 229), (797, 224), (797, 225),
           (797, 226), (797, 227), (797, 228), (798, 224), (798, 225),
           (798, 226), (798, 227)]
    mask = np.zeros((232, 800), bool)
    for x, y in pix:
        mask[y, x] = True
    _, rect, n = _detect_components(mask)
    assert n == 1
    ref = cv2.minAreaRect(np.array(pix, np.int32).reshape(-1, 1, 2))
    assert ref[2] == -45.0  # cv2 resolves the tie to the diagonal
    assert rect['angle_deg'][0] == pytest.approx(-45.0, abs=1e-4)
    assert rect['w'][0] == pytest.approx(ref[1][0], abs=1e-4)
    assert rect['h'][0] == pytest.approx(ref[1][1], abs=1e-4)
    assert rect['cx'][0] == pytest.approx(795.0, abs=1e-4)
    assert rect['cy'][0] == pytest.approx(227.0, abs=1e-4)


def test_min_area_rect_diagonal_line_convention():
    """Degenerate diagonal line: cv2 reports ((6, 6), (0, 2.828), -45) —
    zero w along the -45 direction. The exact path must reproduce the full
    convention, not just the sorted sides."""
    mask = np.zeros((16, 16), bool)
    for i in (5, 6, 7):
        mask[i, i] = True
    _, rect, n = _detect_components(mask)
    assert n == 1
    assert rect['w'][0] == pytest.approx(0.0, abs=1e-5)
    assert rect['h'][0] == pytest.approx(2.8284271, abs=1e-4)
    assert rect['angle_deg'][0] == pytest.approx(-45.0, abs=1e-4)
    assert rect['cx'][0] == pytest.approx(6.0, abs=1e-5)
    assert rect['cy'][0] == pytest.approx(6.0, abs=1e-5)


def _sorted_stats_inputs(rng, h, w, n_comp, max_tall=None, f_pad=64):
    """Random (component, lin)-sorted pixel table: contiguous active prefix,
    components in DESCENDING id order (the sorted-compaction ordering),
    y-sorted (lin-sorted) within each component."""
    import numpy as np
    rows = []
    for c in range(n_comp - 1, -1, -1):
        y0 = int(rng.integers(0, h - 12))
        x0 = int(rng.integers(0, w - 12))
        height = int(rng.integers(1, 12 if max_tall is None else max_tall))
        pix = set()
        for dy in range(height):
            n_px = int(rng.integers(1, 8))
            for _ in range(n_px):
                pix.add((y0 + dy, x0 + int(rng.integers(0, 12))))
        pix = sorted(pix, key=lambda p: p[0] * w + p[1])
        for (y, x) in pix:
            rows.append((c, x, y))
    f = len(rows) + f_pad
    seg = np.full((f,), 0, np.int32)
    xs = np.zeros((f,), np.int32)
    ys = np.zeros((f,), np.int32)
    active = np.zeros((f,), bool)
    for i, (c, x, y) in enumerate(rows):
        seg[i], xs[i], ys[i] = c, x, y
        active[i] = True
    return xs, ys, seg, active


@pytest.mark.parametrize('lum', [False, True])
def test_component_stats_sorted_runs_equivalent(rng, lum):
    """sorted_runs=True (segmented scans + one packed scatter) must be
    bit-identical to the segment-reduction path, including components
    TALLER than max_bh (their clipped tail aggregates into the last row
    slot) and ids beyond max_det (dropped)."""
    h, w = 200, 300
    max_det, max_bh = 8, 6
    xs, ys, seg, active = _sorted_stats_inputs(rng, h, w, n_comp=11,
                                               max_tall=14)
    seg = np.where(active, np.minimum(seg, max_det), max_det).astype(np.int32)
    gray = (np.asarray(xs) * 7 + np.asarray(ys) * 3) % 251 if lum else None
    kw = dict(gray_vals=gray, max_det=max_det, max_bh=max_bh)
    ref = lb.component_stats(xs, ys, seg, active, **kw)
    new = lb.component_stats(xs, ys, seg, active, sorted_runs=True,
                             frame_w=w, frame_h=h, **kw)
    for key in ref:
        a, b = np.asarray(ref[key]), np.asarray(new[key])
        # garbage values behind invalid masks may differ; compare valid only
        if key in ('points', 'points_valid'):
            continue
        assert a.shape == b.shape, key
        if key in ('count', 'lum_sum', 'min_x', 'max_x', 'min_y', 'max_y'):
            valid = np.asarray(ref['count']) > 0
            assert (a[valid] == b[valid]).all(), key
        elif key in ('edge_dx', 'edge_dy', 'edge_angles', 'edge_valid'):
            ev = np.asarray(ref['edge_valid'])
            assert (np.asarray(new['edge_valid']) == ev).all()
            assert (a[ev] == b[ev]).all(), key
    pv = np.asarray(ref['points_valid'])
    assert (np.asarray(new['points_valid']) == pv).all()
    assert (np.asarray(new['points'])[pv] == np.asarray(ref['points'])[pv]).all()


def test_component_stats_sorted_runs_empty(rng):
    """All-inactive input: no NaNs, zero counts, no valid rows."""
    f, max_det, max_bh = 64, 4, 4
    z = np.zeros((f,), np.int32)
    out = lb.component_stats(z, z, np.full((f,), max_det, np.int32),
                             np.zeros((f,), bool), sorted_runs=True,
                             frame_w=128, frame_h=128,
                             max_det=max_det, max_bh=max_bh)
    assert (np.asarray(out['count']) == 0).all()
    assert not np.isnan(np.asarray(out['points'])).any()

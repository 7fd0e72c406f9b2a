"""Bit-exact cv2.minAreaRect CENTERS on device, without the caliper loop.

The reference measures every component with ``cv2.minAreaRect(contour)``
(``/root/reference/ysmr/track_eval.py:287``) whose center carries ~3e-4 px
of float32 rounding noise from OpenCV's incremental rotating-calipers
arithmetic.  The device tracker feeds on centers, and that noise — absent
from our exact integer-arithmetic rects (``labeling._min_area_rect_exact``)
— is what flips near-tie greedy assignments at GSFF mode transitions and
permutes a handful of TRACK_IDs at dense scale (2893 vs 2899 tracks on the
3000-rod clip).  This module reproduces cv2's f32 center BIT-EXACTLY as a
vectorized, static-shaped device computation, so the device tracker can see
the same measurement stream as the reference without host rects.

How the sequential caliper collapses into closed form (all verified by
fuzzing against the pure-Python replica ``ops/cv2_exact.py``, which is
itself fuzzed against OpenCV — see tests/test_cv2_centers.py):

* cv2's hull (``convexHull(int pts, clockwise=False)`` on the traced
  contour) equals the strict-corner envelopes of the per-row x-extremes,
  output in reverse-contour order: starting just after the top-left pixel,
  DOWN the right envelope, across the bottom, UP the left envelope, with
  the top-left (contour-start) vertex LAST.
* The caliper's rotation decisions (t1/t2/t3) are cross products of
  integer edge vectors — exact in f32 — so the edge visiting order is a
  pure sort by (canonical in-quadrant angle, caliper index).  Within one
  caliper the visit order equals the cycle order, so the support vertices
  of every caliper at the moment edge E wins are index arithmetic: the
  caliper that consumed E sits at E's far endpoint, every other caliper r
  sits ``count(edges of r visited before E)`` steps past its initial
  (first-occurrence extreme) vertex.
* Only the area comparison is f32-noisy, and it is replicated literally:
  ``area = f32(width*height)`` per edge with replace-on-<= (the
  last-visited minimal edge wins).
* ``inv_len = f32(1/sqrt(f64(dx^2+dy^2)))`` is the one double-precision
  rounding; dx^2+dy^2 is a small exact integer, so a precomputed table
  indexed by it reproduces the f64 rounding without f64 on device.

Performance shape (the first cut ran the full support machinery for every
edge with global sorts and (D, 4, K) gathers — 23 s per 64-frame dense
batch): only edges whose EXACT area is within f32 rounding noise of the
exact minimum can win cv2's f32 area comparison, so the caliper arithmetic
runs for at most ``_N_CAND`` pruned candidates per component.  The
pruning areas come from one broadcast projection over the hull corners;
next-vertex attributes ride packed suffix-cummins and support vertices
resolve through small mask contractions — no (D, K)-output gather or
scatter remains.

Known limits (``ok`` returns False and callers fall back to the exact
center): components wider than the f32 slope-key collision bound
(2^23 / max_bh^2 px), hull edges longer than the inv-len table, or more
near-tie candidate edges than ``_N_CAND`` (pathologically symmetric
shapes).  Self-touching contours (1-px-wide pinches) make cv2's own hull
quirky and irreproducible from row extremes; fuzzing puts the residual at
~0.1% of DEGENERATE shapes (≈1 in 7200 random blobs), which the parity
tests bound.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['inv_sqrt_table', 'cv2_centers_from_tables',
           'cv2_centers_standalone']

#: caliper candidates kept per component; more near-ties than this -> ok
#: False (exact-center fallback)
_N_CAND = 8

#: packed hull-corner slots per component; hulls with more strict corners
#: (tall strictly-convex blobs: every row is a corner) -> ok False
#: (exact-center fallback). Rod-like organisms have <= ~12.
_K_HULL = 32


def inv_sqrt_table(max_w, max_h):
    """Host-built f32 table t[v] = f32(1/sqrt(f64(v))) for v in [0, N).

    v = dx^2 + dy^2 of an integer hull edge: dx bounded by the component
    width (<= frame width), dy by the row-table height. t[0] is unused
    (a hull edge has nonzero length); keep it finite.
    """
    n = int(max_w) ** 2 + int(max_h) ** 2 + 1
    v = np.arange(n, dtype=np.float64)
    v[0] = 1.0
    return jnp.asarray((1.0 / np.sqrt(v)).astype(np.float32))


def _strict_corner_masks(xl, row_valid, *, side):
    """Strict hull-corner mask of the per-row envelope points (x, row).

    Reference implementation for tests and the standalone path; the
    production pipeline gets the identical masks from
    ``labeling._hull_edge_data`` (whose Pallas kernel already holds the
    min-outgoing / max-incoming slopes this computes).

    A point i is a strict corner of the RIGHT envelope (maximal x) iff
    min_{j<i} slope(j,i) > max_{k>i} slope(i,k); of the LEFT envelope
    (minimal x) iff max_{j<i} slope(j,i) < min_{k>i} slope(i,k).  Slopes
    are (xl_k - xl_i)/(k - i): with |dx| < 2^23/R^2 the f32 quotient is a
    collision-free order key for the distinct rationals (spacing >= 1/R^2,
    quotient error < |dx| * 2^-23), so f32 min/max reductions decide the
    comparisons exactly.  Row-span endpoints come out True automatically
    (empty-side reductions are +-inf).
    """
    d, r = xl.shape
    rows = jnp.arange(r, dtype=jnp.int32)
    dyw = rows[None, :] - rows[:, None]                       # (R, R) j - i
    dx = xl[:, None, :] - xl[:, :, None]                      # (D, i, j)
    pair_ok = (row_valid[:, None, :] & row_valid[:, :, None] &
               (dyw != 0)[None])
    slope = dx.astype(jnp.float32) / dyw.astype(jnp.float32)[None]
    big = jnp.float32(3.0e38)
    after = (dyw > 0)[None] & pair_ok                         # k > i
    before = (dyw < 0)[None] & pair_ok                        # j < i
    if side == 'right':
        lo = jnp.min(jnp.where(before, slope, big), axis=2)   # min_{j<i}
        hi = jnp.max(jnp.where(after, slope, -big), axis=2)   # max_{k>i}
        corner = lo > hi
    else:
        lo = jnp.max(jnp.where(before, slope, -big), axis=2)
        hi = jnp.min(jnp.where(after, slope, big), axis=2)
        corner = lo < hi
    return corner & row_valid


def _sel(a, idx, k):
    """Gather-free row-wise selection: out[d, c] = a[d, idx[d, c]].

    A masked compare-select-reduce over the small k axis fuses into one
    pass instead of a gather, and is exact (exactly one mask hit per
    output).
    """
    m = idx[..., None] == jnp.arange(k, dtype=jnp.int32)
    return jnp.sum(jnp.where(m, a[:, None, :] if a.ndim == 2 else a, 0),
                   axis=-1)


def _dot2(x1, y1, x2, y2, one):
    """f32(x1*y1) + f32(x2*y2) with BOTH products rounded separately.

    XLA contracts ``a*b + c*d`` into fma(a, b, round(c*d)) — measured on
    the CPU backend at ~26% of random samples differing from the
    two-rounding result; neither ``optimization_barrier`` nor bitcast
    round-trips survive to code emission. The sound fix: multiply each
    product by ``one`` — a value that is always 1.0 at runtime but that
    the compiler cannot prove constant. The inner multiplies then feed a
    MULTIPLY (never contractible), and if the outer multiply contracts
    into the add, fma(p, 1.0, q) == round(p + q) — the exact two-rounding
    semantics either way. Verified exhaustive-random in
    tests/test_cv2_centers.py.
    """
    return (x1 * y1) * one + (x2 * y2) * one


@partial(jax.jit, static_argnames=('max_bh',))
def cv2_centers_from_tables(row_min_x, row_max_x, row_valid, min_y,
                            corner_l, corner_r, isq_table, *, max_bh):
    """cv2.minAreaRect centers (f32, bit-exact) from row-extreme tables.

    Gather/scatter-free on the wide axes: the hull corners are first
    COMPACTED to ``_K_HULL`` packed slots per component with a fused
    compare-select-reduce (cycle order preserved, so "next vertex" becomes
    a shift and every later tensor shrinks ~6x), pruning areas come from
    one small projection contraction, and support vertices are direct
    indices into the packed table.  Call once per BATCH with components
    flattened into D (the pipeline reshapes (T, D, R) -> (T*D, R)):
    per-frame launches are latency-bound.

    :param row_min_x, row_max_x: (D, R) int32 absolute x extremes per row
    :param row_valid: (D, R) bool (True on the component's bbox rows)
    :param min_y: (D,) int32 absolute top row
    :param corner_l, corner_r: (D, R) STRICT chain-corner masks
        (``labeling._hull_edge_data``)
    :param isq_table: 1-D f32 table from :func:`inv_sqrt_table`
    :param max_bh: R (static)
    :return: (cx, cy, ok) — (D,) f32 centers and a bool mask; where ok is
        False the center is NOT cv2-exact (caller falls back)
    """
    d, r = row_min_x.shape
    assert r == max_bh
    c = _N_CAND
    kk = _K_HULL
    big = jnp.int32(1 << 30)
    inf = jnp.float32(np.inf)
    rows_i = jnp.arange(r, dtype=jnp.int32)
    # runtime 1.0 the compiler cannot prove constant (see _dot2): min_y is
    # int32 input, so |min_y[0]| + 2 >= 2 always and never NaN
    one = jnp.minimum(jnp.float32(1.0),
                      jnp.abs(min_y[0]).astype(jnp.float32) +
                      jnp.float32(2.0))

    valid_any = jnp.any(row_valid, axis=1)
    h = jnp.sum(row_valid.astype(jnp.int32), axis=1)
    contiguous = jnp.all(row_valid == (rows_i[None, :] < h[:, None]), axis=1)

    x0 = jnp.min(jnp.where(row_valid, row_min_x, big), axis=1)
    xmax = jnp.max(jnp.where(row_valid, row_max_x, -big), axis=1)
    width = xmax - x0
    # f32 slope/tan keys are collision-free only below this width
    w_ok = width < (1 << 23) // max(r * r, 1)

    xl_min = jnp.where(row_valid, row_min_x - x0[:, None], 0)
    xl_max = jnp.where(row_valid, row_max_x - x0[:, None], 0)

    corn_r = corner_r & row_valid
    corn_l = corner_l & row_valid
    # seam dedup: single-pixel top row keeps only its LEFT copy (the
    # top-left vertex must be the cycle's last), single-pixel bottom row
    # keeps only its RIGHT copy
    top_single = xl_min[:, 0] == xl_max[:, 0]
    corn_r = corn_r & ((rows_i != 0)[None, :] | ~top_single[:, None])
    last = jnp.clip(h - 1, 0, r - 1)
    row_vals_eq = xl_min == xl_max
    bot_single = jnp.sum(jnp.where(rows_i[None, :] == last[:, None],
                                   row_vals_eq.astype(jnp.int32), 0),
                         axis=1) > 0
    corn_l = corn_l & ((rows_i[None, :] != last[:, None]) |
                       ~bot_single[:, None])

    # hull cycle in order: right corners rows 0..R-1, then left corners
    # rows R-1..0 (down the right side, up the left side; the top-left
    # vertex lands last)
    k2 = 2 * r
    vx_w = jnp.concatenate([xl_max, jnp.flip(xl_min, axis=1)], axis=1)
    vy_w = jnp.concatenate([jnp.broadcast_to(rows_i, (d, r)),
                            jnp.broadcast_to(jnp.flip(rows_i), (d, r))],
                           axis=1)
    vvalid_w = jnp.concatenate([corn_r, jnp.flip(corn_l, axis=1)], axis=1)
    n = jnp.sum(vvalid_w.astype(jnp.int32), axis=1)
    cyc_w = jnp.cumsum(vvalid_w.astype(jnp.int32), axis=1) - \
        vvalid_w.astype(jnp.int32)

    # ---- COMPACT the corners to kk packed slots (cycle order kept) -----
    # fused compare-select-reduce: never materializes the (D, kk, 2R)
    # one-hot; XLA folds the broadcast compare into the reduction loop
    jj = jnp.arange(kk, dtype=jnp.int32)
    sel = vvalid_w[:, None, :] & (cyc_w[:, None, :] == jj[None, :, None])
    vx = jnp.sum(jnp.where(sel, vx_w[:, None, :], 0), axis=2)  # (D, kk)
    vy = jnp.sum(jnp.where(sel, vy_w[:, None, :], 0), axis=2)
    vvalid = jj[None, :] < jnp.minimum(n, kk)[:, None]
    n_ok = n <= kk

    # ---- n <= 2 degenerate branches (single point / line component) ----
    # the two cycle corners are exactly min_area_rect_cv's 2-point hull;
    # its center is the f32 midpoint (order-independent)
    p0x = (vx[:, 0] + x0).astype(jnp.float32)
    p0y = (vy[:, 0] + min_y).astype(jnp.float32)
    p1x = (vx[:, 1] + x0).astype(jnp.float32)
    p1y = (vy[:, 1] + min_y).astype(jnp.float32)
    mid_cx = (p0x + p1x) * jnp.float32(0.5)
    mid_cy = (p0y + p1y) * jnp.float32(0.5)
    deg_cx = jnp.where(n == 1, p0x, mid_cx)
    deg_cy = jnp.where(n == 1, p0y, mid_cy)

    # ---- edges: next vertex is a SHIFT in the packed table -------------
    is_last = jj[None, :] == (jnp.minimum(n, kk) - 1)[:, None]
    ex = jnp.where(is_last, vx[:, :1],
                   jnp.concatenate([vx[:, 1:], vx[:, :1]], axis=1))
    ey = jnp.where(is_last, vy[:, :1],
                   jnp.concatenate([vy[:, 1:], vy[:, :1]], axis=1))
    dx = ex - vx                                             # int, exact
    dy = ey - vy
    evalid = vvalid & (n[:, None] > 2)

    # ---- initial caliper positions: first-occurrence extremes ----------
    # (cv2 scans hull[0..n-1] with strict replacement; packed order IS the
    # hull order, so argmax of the boolean picks the first hit)
    ymax = jnp.max(jnp.where(vvalid, vy, -big), axis=1)
    xvmax = jnp.max(jnp.where(vvalid, vx, -big), axis=1)
    xvmin = jnp.min(jnp.where(vvalid, vx, big), axis=1)
    def first_slot(cond):
        return jnp.argmax(cond, axis=1).astype(jnp.int32)
    bot0 = first_slot(vvalid & (vy == 0))
    right0 = first_slot(vvalid & (vx == xvmax[:, None]))
    top0 = first_slot(vvalid & (vy == ymax[:, None]))
    left0 = first_slot(vvalid & (vx == xvmin[:, None]))
    seq0 = jnp.stack([bot0, right0, top0, left0], axis=1)    # (D, 4)

    # ---- arcs: edge j belongs to caliper q when j lies in the cyclic
    # span [seq0[q], seq0[q+1]) starting from bot0. With duplicate
    # extremes (e.g. left0 == bot0 on a thin diagonal) the raw cyclic
    # offsets are non-monotone: a later caliper whose start coincides with
    # an earlier position must read as the END of the walk, not position 0
    # — unwrap to a monotone sequence first (the sequential caliper walk's
    # semantics: empty arcs claim no edges, earlier q wins starts).
    n1 = jnp.maximum(n, 1)
    rel_s = (jj[None, :] - bot0[:, None]) % n1[:, None]      # (D, kk)
    rel_q = (seq0 - bot0[:, None]) % n1[:, None]             # (D, 4)
    r1_ = rel_q[:, 1]
    r2_ = rel_q[:, 2] + jnp.where(rel_q[:, 2] < r1_, n1, 0)
    r3_ = rel_q[:, 3] + n1 * jnp.where(
        rel_q[:, 3] >= r2_, 0, jnp.where(rel_q[:, 3] + n1 >= r2_, 1, 2))
    rel_mono = jnp.stack([jnp.zeros_like(r1_), r1_, r2_, r3_], axis=1)
    arc = (jnp.sum((rel_mono[:, :, None] <=
                    rel_s[:, None, :]).astype(jnp.int32),
                   axis=1) - 1).astype(jnp.int32)            # (D, kk) 0..3

    # ---- canonical in-quadrant directions & visit keys -----------------
    # R(-90): (x, y) -> (y, -x), applied arc times
    cdx = jnp.select([arc == 0, arc == 1, arc == 2], [dx, dy, -dx], -dy)
    cdy = jnp.select([arc == 0, arc == 1, arc == 2], [dy, -dx, -dy], dx)
    tan_key = cdy.astype(jnp.float32) / cdx.astype(jnp.float32)
    tan_key = jnp.where(evalid, tan_key, inf)
    arc_key = jnp.where(evalid, arc, 4)

    # ---- candidate pruning by (approximate) exact area ------------------
    # projections of every packed vertex onto every edge direction (and
    # its perpendicular); extremes give du, dv and the exact-to-~2^-22
    # area. Only edges within f32 noise of the minimum can win cv2's f32
    # area comparison.
    dxf_all = dx.astype(jnp.float32)
    dyf_all = dy.astype(jnp.float32)
    vxf = vx.astype(jnp.float32)
    vyf = vy.astype(jnp.float32)
    u = dxf_all[:, :, None] * vxf[:, None, :] + \
        dyf_all[:, :, None] * vyf[:, None, :]                # (D, kk, kk)
    v = dxf_all[:, :, None] * vyf[:, None, :] - \
        dyf_all[:, :, None] * vxf[:, None, :]
    pmask = vvalid[:, None, :]
    du = jnp.max(jnp.where(pmask, u, -inf), axis=2) - \
        jnp.min(jnp.where(pmask, u, inf), axis=2)
    dv = jnp.max(jnp.where(pmask, v, -inf), axis=2) - \
        jnp.min(jnp.where(pmask, v, inf), axis=2)
    l2f = (dx * dx + dy * dy).astype(jnp.float32)
    area_sur = du * dv / jnp.maximum(l2f, 1.0)
    area_sur = jnp.where(evalid, area_sur, inf)
    min_sur = jnp.min(area_sur, axis=1, keepdims=True)
    # the f32 caliper area differs from the exact area by <= ~2^-20
    # relative; any edge outside this band cannot win the f32 comparison
    band = min_sur * jnp.float32(1.0 + 2.0 ** -14) + jnp.float32(1e-30)
    in_band = evalid & (area_sur <= band)
    n_in_band = jnp.sum(in_band.astype(jnp.int32), axis=1)
    # top-C smallest surrogate areas ⊇ the band (when it fits)
    _, cand_slot = jax.lax.top_k(-area_sur, c)               # (D, C)
    cand_slot = cand_slot.astype(jnp.int32)
    # every per-candidate pull shares one (D, C, kk) selection mask —
    # gather-free (see _sel)
    cmask = cand_slot[:, :, None] == jj[None, None, :]
    gC = lambda a: jnp.sum(jnp.where(cmask, a[:, None, :], 0), axis=2)
    cvalid = gC(in_band.astype(jnp.int32)) > 0

    # ---- supports for the C candidates ---------------------------------
    # visit comparisons against ALL edges: earlier(s, c) = key_s < key_c
    ctan = gC(tan_key)
    carc = gC(arc_key)
    earlier = (tan_key[:, None, :] < ctan[:, :, None]) | \
        ((tan_key[:, None, :] == ctan[:, :, None]) &
         (arc_key[:, None, :] < carc[:, :, None]))           # (D, C, kk)
    earlier = earlier & evalid[:, None, :]
    cnt = []
    for q in range(4):
        cnt.append(jnp.sum(
            (earlier & (arc[:, None, :] == q)).astype(jnp.int32), axis=2))
    cnt = jnp.stack(cnt, axis=1)                             # (D, 4, C)

    # packed position == packed slot, so supports are direct indices
    tgt = (seq0[:, :, None] + cnt) % n1[:, None, None]       # (D, 4, C)
    cend = gC((jj[None, :] + 1) % n1[:, None])               # E's far end
    arc_oh = carc[:, None, :] == jnp.arange(4)[None, :, None]
    tgt = jnp.where(arc_oh, cend[:, None, :], tgt)
    tgt_flat = tgt.reshape(d, 4 * c)
    sup_x = _sel(vx, tgt_flat, kk).reshape(d, 4, c).astype(jnp.float32)
    sup_y = _sel(vy, tgt_flat, kk).reshape(d, 4, c).astype(jnp.float32)

    # ---- per-candidate f32 caliper arithmetic (cv2's exact op order) ---
    cdx_e = gC(dx)
    cdy_e = gC(dy)
    vlen2 = (cdx_e * cdx_e + cdy_e * cdy_e).astype(jnp.int32)
    tab_n = isq_table.shape[0]
    vlen_ok = (vlen2 < tab_n) | ~cvalid
    iv = isq_table[jnp.clip(vlen2, 0, tab_n - 1)]
    dxf = cdx_e.astype(jnp.float32)
    dyf = cdy_e.astype(jnp.float32)
    lx = dxf * iv
    ly = dyf * iv
    a = jnp.select([carc == 0, carc == 1, carc == 2], [lx, ly, -lx], -ly)
    b = jnp.select([carc == 0, carc == 1, carc == 2], [ly, -lx, -ly], lx)
    # support differences are exact integers in f32
    wdx = sup_x[:, 1] - sup_x[:, 3]
    wdy = sup_y[:, 1] - sup_y[:, 3]
    rwidth = _dot2(wdx, a, wdy, b, one)
    hdx = sup_x[:, 2] - sup_x[:, 0]
    hdy = sup_y[:, 2] - sup_y[:, 0]
    rheight = _dot2(hdy, a, -hdx, b, one)
    area = rwidth * rheight
    area = jnp.where(cvalid, area, inf)

    # winner among candidates: minimal f32 area, ties to the LAST visited
    # (cv2's replace-on-<=). Relative visit order via pairwise key compare.
    min_area = jnp.min(area, axis=1, keepdims=True)
    later_cnt = jnp.sum(
        (((ctan[:, :, None] > ctan[:, None, :]) |
          ((ctan[:, :, None] == ctan[:, None, :]) &
           (carc[:, :, None] > carc[:, None, :]))) &
         cvalid[:, None, :]).astype(jnp.int32), axis=2)      # (D, C)
    tie_rank = jnp.where(area == min_area, later_cnt, -1)
    win = jnp.argmax(tie_rank, axis=1)                       # (D,) candidate

    wmask = win[:, None] == jnp.arange(c, dtype=jnp.int32)[None, :]
    g = lambda arr: jnp.sum(jnp.where(wmask, arr, 0), axis=1)
    g4 = lambda arr: jnp.sum(jnp.where(wmask[:, None, :], arr, 0), axis=2)
    wa = g(a)
    wb = g(b)
    wsx = g4(sup_x)
    wsy = g4(sup_y)
    wwidth = g(rwidth)
    wheight = g(rheight)

    # absolute support coordinates (cv2 computes on absolute hull points)
    x0f = x0.astype(jnp.float32)
    y0f = min_y.astype(jnp.float32)
    lxx = wsx[:, 3] + x0f
    lyy = wsy[:, 3] + y0f
    bxx = wsx[:, 0] + x0f
    byy = wsy[:, 0] + y0f
    nb = -wb
    c1 = _dot2(lxx, wa, lyy, wb, one)
    c2 = _dot2(bxx, nb, byy, wa, one)
    det = _dot2(wa, wa, -nb, wb, one)
    idet = jnp.float32(1.0) / det
    px = _dot2(c1, wa, -c2, wb, one) * idet
    py = _dot2(c2, wa, -c1, nb, one) * idet
    # o1 + o2 must see ROUNDED products too (same contraction hazard)
    osx = _dot2(wa, wwidth, nb, wheight, one)     # o1x + o2x
    osy = _dot2(wb, wwidth, wa, wheight, one)     # o1y + o2y
    cal_cx = osx * jnp.float32(0.5) + px
    cal_cy = osy * jnp.float32(0.5) + py

    cx = jnp.where(n <= 2, deg_cx, cal_cx)
    cy = jnp.where(n <= 2, deg_cy, cal_cy)
    ok = (valid_any & contiguous & w_ok & n_ok & (n_in_band <= c) &
          jnp.all(vlen_ok, axis=1))
    return cx, cy, ok


def cv2_centers_standalone(row_min_x, row_max_x, row_valid, min_y,
                           isq_table, *, max_bh):
    """Self-contained entry (tests / non-pipeline callers): computes the
    strict corner masks and candidate areas itself, then runs
    :func:`cv2_centers_from_tables`."""
    big = jnp.int32(1 << 30)
    x0 = jnp.min(jnp.where(row_valid, row_min_x, big), axis=1)
    xl_min = jnp.where(row_valid, row_min_x - x0[:, None], 0)
    xl_max = jnp.where(row_valid, row_max_x - x0[:, None], 0)
    corn_l = _strict_corner_masks(xl_min, row_valid, side='left')
    corn_r = _strict_corner_masks(xl_max, row_valid, side='right')
    return cv2_centers_from_tables(row_min_x, row_max_x, row_valid, min_y,
                                   corn_l, corn_r, isq_table,
                                   max_bh=max_bh)

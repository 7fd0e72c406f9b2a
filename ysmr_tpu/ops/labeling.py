#!/usr/bin/env python3
"""Connected-components labeling and per-component rotated extents on device.

Replaces the reference's ``cv2.findContours(RETR_EXTERNAL)`` +
``cv2.minAreaRect`` per contour (track_eval.py:273-304) and
``scipy.ndimage.binary_propagation`` (track_eval.py:211-214) with batched,
statically-shaped JAX ops:

* **Labeling**: iterative min-label propagation with pointer jumping
  (label <- min(neighbour labels); label <- label[label]), which converges in
  O(log diameter) iterations inside a ``lax.while_loop``. Components are
  compacted to dense ids ordered by their minimum linear pixel index — i.e.
  raster-scan first-encounter order, matching the contour enumeration order
  of the reference (verified in tests).
* **binary_propagation equivalence**: scipy's reconstruction-by-dilation of
  the marker image under the mask (4-connected structuring element) equals
  "keep every 4-connected mask component containing at least one marker
  pixel" because the markers are a subset of the mask (the marker threshold
  is strictly stricter). One labeling pass + one segment-max.
* **minAreaRect equivalence**: per component the convex hull of the pixel
  set is spanned by the per-row x-extremes, so extents along *any* direction
  computed from those <= 2*max_bbox_h candidate points are exact. The
  min-area angle is found by a coarse-to-fine sweep (exact up to the final
  angular step, ~0.06 deg by default); the rotating-calipers optimum always
  lies at a hull-edge angle, so the sweep bounds the area error tightly.
  Width/height/center match OpenCV to sub-pixel tolerance (tests).

All entry points operate on a single frame; use ``jax.vmap`` for batches.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _neighbor_min(lab, invalid, connectivity):
    """Min label over the 4- or 8-neighbourhood (edges padded with invalid)."""
    big = invalid
    pad = jnp.pad(lab, 1, mode='constant', constant_values=big)
    h, w = lab.shape
    if connectivity == 8:
        # separable 3x3 min (vertical min of horizontal mins): 4 shifted
        # slices instead of 8 — exact for 8-connectivity, every pixel of
        # the 3x3 block is itself an 8-neighbour
        hmin = jnp.minimum(pad[:, 1:w + 1],
                           jnp.minimum(pad[:, 0:w], pad[:, 2:w + 2]))
        return jnp.minimum(hmin[0:h], jnp.minimum(hmin[1:h + 1],
                                                  hmin[2:h + 2]))
    up = pad[0:h, 1:w + 1]
    down = pad[2:h + 2, 1:w + 1]
    left = pad[1:h + 1, 0:w]
    right = pad[1:h + 1, 2:w + 2]
    return jnp.minimum(jnp.minimum(up, down), jnp.minimum(left, right))


@partial(jax.jit, static_argnames=('connectivity', 'max_iters', 'jump_every'))
def label_components(mask, connectivity=8, max_iters=64, jump_every=1):
    """Label connected components of a boolean mask.

    Iterative min-label propagation. With ``jump_every=1`` each iteration
    also applies one pointer-jumping hop (label <- label[label]) for
    O(log diameter) convergence; with ``jump_every=0`` propagation is
    stencil-only (cheap shifted-minimum vector work, no full-image gathers —
    the production choice: bacteria-sized components converge in ~diameter
    iterations and correctness is preserved up to diameter = max_iters).

    :param mask: (H, W) bool
    :param connectivity: 4 or 8 (reference: 8 for contours, 4 for propagation)
    :param max_iters: safety bound on the while loop
    :return: (H, W) int32 labels — for foreground pixels the minimum linear
        index of their component; background pixels hold H*W (invalid)
    """
    with jax.named_scope('cc_label'):
        return _label_components(mask, connectivity, max_iters, jump_every)


def _label_components(mask, connectivity, max_iters, jump_every):
    h, w = mask.shape
    n = h * w
    invalid = jnp.int32(n)
    idx = jnp.arange(n, dtype=jnp.int32).reshape(h, w)
    lab = jnp.where(mask, idx, invalid)

    def body(state):
        lab, _, it = state
        neigh = _neighbor_min(lab, invalid, connectivity)
        new = jnp.where(mask, jnp.minimum(lab, neigh), invalid)
        if jump_every == 1:
            flat = new.reshape(-1)
            hop = flat[jnp.clip(flat, 0, n - 1)]
            new = jnp.where(mask, jnp.minimum(new, hop.reshape(h, w)), invalid)
        # jump_every == 0: stencil-only propagation. A lax.cond for an
        # every-k-th-iteration jump is NOT used because under vmap both
        # branches execute, making the full-image gather run every iteration.
        changed = jnp.any(new != lab)
        return new, changed, it + 1

    def cond(state):
        _, changed, it = state
        return jnp.logical_and(changed, it < max_iters)

    # the initial 'changed' flag must derive from data (not be a constant) so
    # the carry keeps a consistent varying-axes type under shard_map
    any_fg = jnp.any(mask)
    changed0 = any_fg | jnp.logical_not(any_fg)  # data-dependent True
    lab, _, _ = jax.lax.while_loop(cond, body, (lab, changed0, jnp.int32(0)))
    return lab


@partial(jax.jit, static_argnames=('w', 'connectivity', 'max_iters'))
def label_components_table(lin, valid, *, w, connectivity=8, max_iters=32):
    """Component labels for a SPARSE pixel table — no whole-frame arrays.

    Same label semantics as :func:`label_components` (minimum original
    linear index per component) but O(F log F) in the foreground pixel count
    instead of O(H*W*iters): neighbours are resolved by binary search in the
    lin-sorted table, and min-label propagation alternates with pointer
    jumping (label <- label[index_of(label)]) for O(log diameter)
    convergence. This is the natural formulation for the pixels transfer
    mode, where foreground occupies ~0.3 % of the frame.

    :param lin: (F,) int32 linear indices (y*w + x), unique among valid
    :param valid: (F,) bool
    :param w: frame width (needed to mask x-edge wraparound)
    :return: (F,) int32 — min linear index of the pixel's component, or
        2**30 for invalid entries
    """
    f = lin.shape[0]
    big = jnp.int32(2 ** 30)
    lin_v = jnp.where(valid, lin, big)
    order = jnp.argsort(lin_v)            # raster order among valid entries
    sorted_lin = lin_v[order]
    iota = jnp.arange(f, dtype=jnp.int32)

    def lookup(values):
        """Table index holding each (valid-label) value; self-index misses."""
        pos = jnp.clip(jnp.searchsorted(sorted_lin, values), 0, f - 1)
        found = sorted_lin[pos] == values
        return pos, found

    x = lin_v - (lin_v // w) * w
    if connectivity == 8:
        offsets = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
                   (0, 1), (1, -1), (1, 0), (1, 1))
    else:
        offsets = ((-1, 0), (0, -1), (0, 1), (1, 0))
    nbrs = []
    for dy, dx in offsets:
        ok = valid
        if dx == -1:
            ok = ok & (x > 0)
        elif dx == 1:
            ok = ok & (x < w - 1)
        nlin = jnp.where(ok, lin_v + dy * w + dx, jnp.int32(-1))
        pos, found = lookup(nlin)
        nbrs.append(jnp.where(found, order[pos], iota))
    nbr = jnp.stack(nbrs, axis=1)  # (F, K) neighbour table indices

    lab0 = lin_v

    def body(state):
        lab, _, it = state
        m = lab
        for k in range(nbr.shape[1]):
            m = jnp.minimum(m, lab[nbr[:, k]])
        # pointer jump: adopt the current label of my label's own pixel
        pos, found = lookup(m)
        hop = jnp.where(found, lab[order[pos]], m)
        new = jnp.where(valid, jnp.minimum(m, hop), big)
        return new, jnp.any(new != lab), it + 1

    def cond(state):
        _, changed, it = state
        return jnp.logical_and(changed, it < max_iters)

    any_fg = jnp.any(valid)
    changed0 = any_fg | jnp.logical_not(any_fg)  # data-dependent True
    lab, _, _ = jax.lax.while_loop(cond, body, (lab0, changed0, jnp.int32(0)))
    return lab


@partial(jax.jit, static_argnames=('reverse',))
def compact_labels_table(labels, valid, lin, reverse=True):
    """Dense component ids for table labels, raster-rank ordered.

    Counterpart of the whole-frame compaction used by the image path:
    components are numbered by the raster position of their minimum-index
    pixel; ``reverse=True`` flips to reverse raster order (cv2's
    findContours enumeration, see compact_labels).

    :param labels: (F,) int32 from label_components_table
    :param valid: (F,) bool
    :param lin: (F,) int32 original linear indices
    :return: (comp (F,) int32 — dense id or F for invalid, n_comp scalar)
    """
    f = labels.shape[0]
    big = jnp.int32(2 ** 30)
    lin_v = jnp.where(valid, lin, big)
    order = jnp.argsort(lin_v)
    sorted_lin = lin_v[order]
    roots = valid & (labels == lin)
    n_comp = jnp.sum(roots.astype(jnp.int32))
    roots_sorted = roots[order]
    rank_sorted = jnp.cumsum(roots_sorted.astype(jnp.int32)) - 1
    rank = jnp.zeros((f,), jnp.int32).at[order].set(rank_sorted)
    pos = jnp.clip(jnp.searchsorted(sorted_lin, labels), 0, f - 1)
    comp = rank[order[pos]]
    if reverse:
        comp = n_comp - 1 - comp
    return jnp.where(valid, comp, jnp.int32(f)), n_comp


@partial(jax.jit, static_argnames=('max_det', 'reverse'))
def compact_labels(labels, mask, max_det, reverse=True):
    """Map root labels to dense component ids.

    With ``reverse=True`` (default) ids run in *reverse* raster-scan order of
    each component's first pixel — the enumeration order of
    ``cv2.findContours``, whose output list is built head-first (verified in
    tests/test_labeling.py); this order sets detection order, registration
    order, and therefore TRACK_ID assignment parity with the reference.

    :param labels: (H, W) int32 from :func:`label_components`
    :param mask: (H, W) bool foreground
    :param max_det: static capacity; components beyond it and all background
        pixels map to the overflow bucket ``max_det``
    :return: (comp_id (H, W) int32 in [0, max_det], n_components int32)
    """
    h, w = labels.shape
    n = h * w
    flat = labels.reshape(-1)
    idx = jnp.arange(n, dtype=jnp.int32)
    is_root = (flat == idx) & mask.reshape(-1)
    rank = jnp.cumsum(is_root.astype(jnp.int32)) - 1  # rank at root positions
    n_components = rank[-1] + 1
    root_rank = jnp.where(is_root, rank, 0)
    comp = root_rank[jnp.clip(flat, 0, n - 1)]
    if reverse:
        comp = n_components - 1 - comp
    comp = jnp.where(mask.reshape(-1), jnp.minimum(comp, max_det), max_det)
    return comp.reshape(h, w), n_components


@partial(jax.jit, static_argnames=('max_iters', 'check_every'))
def binary_reconstruct(mask, marker, max_iters=64, check_every=8):
    """Batched morphological reconstruction of ``marker`` under ``mask``.

    scipy.ndimage.binary_propagation semantics with the 4-connected
    structuring element (the reference's double-threshold keep rule,
    track_eval.py:211-214): a pixel survives iff it is 4-connected to a
    marker pixel within the mask. Bit-packed: 32 frames share one uint32
    plane, so one dilation step over a 64-frame batch is five shifted ORs
    and an AND over two planes, which XLA fuses into one kernel. Up to
    ``max_iters`` dilation steps (the propagation reach in pixels), with
    convergence tested every ``check_every`` steps — steps past the fixed
    point are idempotent.

    :param mask: (T, H, W) bool
    :param marker: (T, H, W) bool
    :return: (T, H, W) bool kept pixels
    """
    with jax.named_scope('binary_reconstruct'):
        return _binary_reconstruct(mask, marker, max_iters, check_every)


def _binary_reconstruct(mask, marker, max_iters, check_every):
    t, h, w = mask.shape
    g = -(-t // 32)

    def pack(arr):
        planes = jnp.pad(arr, ((0, g * 32 - t), (0, 0), (0, 0)))
        planes = planes.reshape(g, 32, h, w)
        word = planes[:, 0].astype(jnp.uint32)
        for b in range(1, 32):
            word = word | (planes[:, b].astype(jnp.uint32) << b)
        return word

    m = pack(mask)

    def grow(k):
        zr = jnp.zeros_like(k[:, :1])
        zc = jnp.zeros_like(k[:, :, :1])
        up = jnp.concatenate([k[:, 1:], zr], axis=1)
        down = jnp.concatenate([zr, k[:, :-1]], axis=1)
        left = jnp.concatenate([k[:, :, 1:], zc], axis=2)
        right = jnp.concatenate([zc, k[:, :, :-1]], axis=2)
        return (k | up | down | left | right) & m

    def body(state):
        k, _, it = state
        new = k
        for _ in range(check_every):
            new = grow(new)
        return new, jnp.any(new != k), it + check_every

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    k, _, _ = jax.lax.while_loop(
        cond, body, (pack(marker) & m, jnp.bool_(True), jnp.int32(0)))
    bits = jnp.stack([(k >> b) & 1 for b in range(32)], axis=1)
    return bits.reshape(g * 32, h, w)[:t].astype(bool)


def _seg_suffix_scan(vals, run_end, op_name):
    """Segmented SUFFIX scan over a 1-D table: out[i] = vals[i] if
    run_end[i] else op(out[i+1], vals[i]) — i.e. each position reads the
    reduction of its run's tail. At a run's FIRST position this is the whole
    run's reduction, which is what the sorted-run fast paths consume.

    Implemented as an associative scan on (flag, value) pairs (the classic
    segmented-scan monoid), which XLA lowers to log2(N) vector passes instead
    of combiner scatters over the same data.
    """
    if op_name == 'min':
        comb = jnp.minimum
    elif op_name == 'max':
        comb = jnp.maximum
    else:
        comb = jnp.add

    def op(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, comb(va, vb))

    _, out = jax.lax.associative_scan(op, (run_end, vals), reverse=True)
    return out


def _row_tables_sorted(xs, ys, seg, active, gray_vals, *, max_det, max_bh,
                       xbits, ybits):
    """Row-extreme tables from a (component, lin)-SORTED pixel table.

    On the sorted-compaction path pixels arrive ordered by (component id,
    linear index): every component is one contiguous run with non-decreasing
    y, and every (component, clipped-bbox-row) is one contiguous sub-run with
    its pixels' x values covered by the sub-run's min/max. The per-row x
    extremes are therefore segmented suffix reductions read at run starts,
    and ONE packed scatter-set (x_min | x_max << xbits | y << 2*xbits, unique
    indices by construction) places them into the dense (max_det, max_bh)
    table — replacing the three combiner-scatter segment reductions of the
    unsorted path (bit-identical output).

    Requires 2*xbits + ybits <= 32 (checked by the caller).

    :return: (row_min_x, row_max_x, row_valid, min_y[, count, lum_sum])
    """
    f = xs.shape[0]
    iota = jnp.arange(f, dtype=jnp.int32)
    prev_seg = jnp.roll(seg, 1)
    prev_active = jnp.roll(active, 1)
    comp_bound = active & ((iota == 0) | (seg != prev_seg) | (~prev_active))
    # fill-forward of each component's first y (its min — y is sorted within
    # the component): encode (run ordinal, y) so a running max carries the
    # most recent component start
    cnum = jnp.cumsum(comp_bound.astype(jnp.int32))
    enc = jnp.where(comp_bound, cnum * (1 << ybits) + ys, -1)
    y0 = jax.lax.cummax(enc) & ((1 << ybits) - 1)
    rel_y = jnp.clip(ys - y0, 0, max_bh - 1)
    # distinct rows of one component always have distinct rel_y EXCEPT in
    # the clipped tail (rel_y pinned at max_bh - 1), which must stay ONE run
    # so its table slot has a unique writer aggregating the whole tail —
    # exactly the segment-reduction semantics for components taller than
    # max_bh
    row_bound = active & (comp_bound | (rel_y != jnp.roll(rel_y, 1)))
    nxt_row_bound = jnp.concatenate(
        [row_bound[1:], jnp.ones((1,), bool)])
    nxt_active = jnp.concatenate([active[1:], jnp.zeros((1,), bool)])
    run_end = nxt_row_bound | (~nxt_active)
    xm = _seg_suffix_scan(xs, run_end, 'min')
    xM = _seg_suffix_scan(xs, run_end, 'max')
    pk = (xm.astype(jnp.uint32) | (xM.astype(jnp.uint32) << xbits) |
          (ys.astype(jnp.uint32) << (2 * xbits)))
    nrow = max_det * max_bh + 1
    oob = jnp.int32(nrow) + iota
    ok = row_bound & (seg < max_det)
    idx = jnp.where(ok, seg * max_bh + rel_y, oob)
    sentinel = jnp.uint32(0xFFFFFFFF)
    tab = jnp.full((nrow,), sentinel).at[idx].set(
        pk, mode='drop', unique_indices=True)
    tab = tab[:max_det * max_bh].reshape(max_det, max_bh)
    row_valid = tab != sentinel
    big = jnp.int32(1 << 30)
    xmask = jnp.uint32((1 << xbits) - 1)
    row_min_x = jnp.where(row_valid, (tab & xmask).astype(jnp.int32), big)
    row_max_x = jnp.where(row_valid,
                          ((tab >> xbits) & xmask).astype(jnp.int32), -big)
    y_tab = (tab >> (2 * xbits)).astype(jnp.int32)
    # a non-empty component always populates its rel_y = 0 slot, whose packed
    # y is the component's min y
    min_y = jnp.where(row_valid[:, 0], y_tab[:, 0], big)
    out = [row_min_x, row_max_x, row_valid, min_y]
    if gray_vals is not None:
        # exact per-component pixel count and luminosity sum via the same
        # trick: suffix sums over whole-component runs, read at their starts
        comp_end = jnp.concatenate(
            [comp_bound[1:], jnp.ones((1,), bool)]) | (~nxt_active)
        cnt = _seg_suffix_scan(active.astype(jnp.int32), comp_end, 'add')
        lum = _seg_suffix_scan(
            jnp.where(active, gray_vals, 0), comp_end, 'add')
        nseg = max_det + 1
        oob_c = jnp.int32(nseg) + iota
        cidx = jnp.where(comp_bound & (seg < max_det), seg, oob_c)
        count = jnp.zeros((nseg,), jnp.int32).at[cidx].set(
            cnt, mode='drop', unique_indices=True)[:max_det]
        lum_sum = jnp.zeros((nseg,), jnp.int32).at[cidx].set(
            lum, mode='drop', unique_indices=True)[:max_det]
        out += [count, lum_sum]
    return tuple(out)


@partial(jax.jit, static_argnames=('max_det', 'max_bh', 'sorted_runs',
                                   'frame_w', 'frame_h', 'cv2_centers'))
def component_stats(xs, ys, seg, active, gray_vals=None, max_det=1024,
                    max_bh=96, sorted_runs=False, frame_w=0, frame_h=0,
                    cv2_centers=False):
    """Per-component statistics and convex-hull candidates from point lists.

    Shared by the image path (flattened pixel grid) and the compact
    foreground-table path (pixels mode): all inputs are 1-D arrays over
    candidate points.

    :param xs, ys: (N,) int32 coordinates
    :param seg: (N,) int32 dense component ids (invalid/background = max_det)
    :param active: (N,) bool
    :param gray_vals: optional (N,) int32 grayscale for luminosity sums
    :param sorted_runs: inputs are sorted by (component id, linear index)
        with the active pixels forming contiguous runs (the sorted-compaction
        path's ordering) — enables the scan-based row tables
        (_row_tables_sorted; bit-identical to the segment reductions). Requires
        ``frame_w``/``frame_h`` for the packed scatter's bit budget; silently
        falls back to segment reductions when the dims don't fit 32 bits.
    :return: dict of per-component arrays as described in component_tables.
        Without luminosity, 'count' is the row-span upper bound (its only
        consumer is the count > 0 validity test); with luminosity it is the
        exact pixel count needed for the mean.
    """
    ones = active.astype(jnp.int32)
    nseg = max_det + 1
    big = jnp.int32(1 << 30)
    xbits = max(int(frame_w) - 1, 1).bit_length()
    ybits = max(int(frame_h) - 1, 1).bit_length()
    use_sorted = bool(sorted_runs and frame_w and frame_h and
                      2 * xbits + ybits <= 32)
    lum_from_sorted = False
    if use_sorted:
        res = _row_tables_sorted(xs, ys, seg, active, gray_vals,
                                 max_det=max_det, max_bh=max_bh,
                                 xbits=xbits, ybits=ybits)
        row_min_x, row_max_x, row_valid, min_y = res[:4]
        if gray_vals is not None:
            count_exact, lum_sum = res[4], res[5]
            lum_from_sorted = True
    else:
        x_masked_min = jnp.where(ones > 0, xs, big)
        y_masked_min = jnp.where(ones > 0, ys, big)
        x_masked_max = jnp.where(ones > 0, xs, -big)
        min_y = jax.ops.segment_min(y_masked_min, seg, num_segments=nseg)

        # per-(component, bbox-row) x extremes; the remaining per-component
        # stats (count, min/max x, max y) derive from these small tables
        # instead of additional full-length segment reductions
        rel_y = jnp.clip(ys - min_y[seg], 0, max_bh - 1)
        row_key = jnp.where(ones > 0, seg * max_bh + rel_y, max_det * max_bh)
        nrow = max_det * max_bh + 1
        row_min_x = jax.ops.segment_min(x_masked_min, row_key,
                                        num_segments=nrow)
        row_max_x = jax.ops.segment_max(x_masked_max, row_key,
                                        num_segments=nrow)
        row_min_x = row_min_x[:max_det * max_bh].reshape(max_det, max_bh)
        row_max_x = row_max_x[:max_det * max_bh].reshape(max_det, max_bh)
        row_valid = row_min_x < big
        min_y = min_y[:max_det]
    out = _stats_tail_from_tables(row_min_x, row_max_x, row_valid, min_y,
                                  max_det=max_det, max_bh=max_bh,
                                  count=(count_exact if (gray_vals is not None
                                         and lum_from_sorted) else None),
                                  cv2_centers=cv2_centers)
    if gray_vals is not None:
        if lum_from_sorted:
            out['lum_sum'] = lum_sum
        else:
            out['count'] = jax.ops.segment_sum(
                ones, seg, num_segments=nseg)[:max_det]
            lum = jnp.where(ones > 0, gray_vals, 0)
            out['lum_sum'] = jax.ops.segment_sum(
                lum, seg, num_segments=nseg)[:max_det]
    return out


def _stats_tail_from_tables(row_min_x, row_max_x, row_valid, min_y, *,
                            max_det, max_bh, count=None, cv2_centers=False):
    """Row-extreme tables -> the component_stats output dict (shared by the
    pixel-table paths and the run-table fast path).

    With ``cv2_centers`` the dict additionally carries ``cv2_cx``/
    ``cv2_cy``/``cv2_ok``: bit-exact replicas of cv2.minAreaRect's f32
    CENTER (ops/cv2_centers.py) for the device tracker to consume, so its
    measurement stream matches the reference's noisy caliper centers
    instead of our exact ones (the ~3e-4 px delta is what flips near-tie
    greedy assignments; see tracker.py).
    """
    big = jnp.int32(1 << 30)
    abs_y = (min_y[:, None] + jnp.arange(max_bh, dtype=jnp.int32)[None, :])
    min_x = jnp.min(jnp.where(row_valid, row_min_x, big), axis=1)
    max_x = jnp.max(jnp.where(row_valid, row_max_x, -big), axis=1)
    max_y = jnp.max(jnp.where(row_valid, abs_y, -big), axis=1)
    if count is None:
        count = jnp.sum(jnp.where(row_valid, row_max_x - row_min_x + 1, 0),
                        axis=1)
    pts_x = jnp.concatenate([row_min_x, row_max_x], axis=1).astype(jnp.float32)
    pts_y = jnp.concatenate([abs_y, abs_y], axis=1).astype(jnp.float32)
    pts = jnp.stack([pts_x, pts_y], axis=-1)  # (max_det, 2*max_bh, 2)
    pts_valid = jnp.concatenate([row_valid, row_valid], axis=1)

    # exact hull-edge candidates: monotone-chain convex envelopes of the
    # per-row x-extremes give the true hull edges (the row extremes contain
    # every hull vertex); their directions are the only angles at which the
    # minimal rectangle can occur (rotating-calipers theorem), and the
    # integer edge vectors allow exact area comparisons in min_area_rect.
    edge_dx, edge_dy, edge_angles, edge_valid, corner_l, corner_r = \
        _hull_edge_data(row_min_x, row_max_x, row_valid, abs_y)

    out = {
        'count': count[:max_det],
        'min_x': min_x[:max_det], 'max_x': max_x[:max_det],
        'min_y': min_y[:max_det], 'max_y': max_y[:max_det],
        'points': pts, 'points_valid': pts_valid,
        'edge_dx': edge_dx, 'edge_dy': edge_dy,
        'edge_angles': edge_angles, 'edge_valid': edge_valid,
    }
    if cv2_centers:
        # raw inputs for ops/cv2_centers (computed in the detect tail,
        # after min_area_rect provides the pruning areas)
        out['row_min_x'] = row_min_x
        out['row_max_x'] = row_max_x
        out['row_valid'] = row_valid
        out['corner_l'] = corner_l
        out['corner_r'] = corner_r
    return out


# caliper-edge length bound for the cv2-center inv-sqrt table: components
# with hull edges longer than this in x fall back to exact centers
# (cv2_ok=False). 256 px covers any plausible organism at these scales
# while keeping the embedded table small (~0.3 MB).
_CV2_CENTER_MAX_EDGE_W = 256


def component_stats_runs(s_start, s_len, s_comp, *, w, h, max_det, max_bh,
                         cv2_centers=False):
    """component_stats straight from COMPONENT-SORTED run tables (1 frame).

    The run-graph CC path (ops/run_cc.py) already holds every kept
    component as contiguous runs ordered by (component, linear index).
    Each wire run lives inside one image row with x spanning
    ``[start % w, start % w + len - 1]``, so the per-(component, bbox-row)
    x extremes are plain min/max COMBINER scatters over the (R,) run
    table — no pixel expansion and no F-length scans at all: the
    run->pixel expansion (scatter + int cumsum over (T, F)) and three
    suffix scans drop out of the detect hot path, and the program stays
    small to compile at dense capacities.

    Bit-identical to the pixel-table path (pixels of a row covered by its
    runs' intervals); equality is fuzzed in tests/test_detect_pixels.py.

    :param s_start, s_len: (R,) int32 component-sorted run geometry
        (len 0 = padding)
    :param s_comp: (R,) int32 component id per run (any fixed id order;
        ids must be contiguous in the table order — run_cc's tables are)
    :return: component_stats output dict (no luminosity fields)
    """
    r = s_start.shape[0]
    valid = s_len > 0
    rows = s_start // w
    x0 = s_start % w
    x1 = x0 + s_len - 1
    iota = jnp.arange(r, dtype=jnp.int32)
    prev_comp = jnp.roll(s_comp, 1)
    prev_valid = jnp.roll(valid, 1)
    comp_start = valid & ((iota == 0) | (s_comp != prev_comp) |
                          (~prev_valid))
    # per-run component min-y (= the row of the component's FIRST run —
    # runs are lin-sorted within a component): ordinal-encoded cummax
    # fill-forward, the same trick as the sorted pixel path but at run
    # (not pixel) length
    ybits = max(int(h) - 1, 1).bit_length()
    cnum = jnp.cumsum(comp_start.astype(jnp.int32))
    enc = jnp.where(comp_start, cnum * (1 << ybits) + rows, -1)
    y0 = jax.lax.cummax(enc) & ((1 << ybits) - 1)
    rel_y = jnp.clip(rows - y0, 0, max_bh - 1)
    nrow = max_det * max_bh + 1
    oob = jnp.int32(nrow) + iota
    ok = valid & (s_comp >= 0) & (s_comp < max_det)
    idx = jnp.where(ok, s_comp * max_bh + rel_y, oob)
    big = jnp.int32(1 << 30)
    row_min_x = jnp.full((nrow,), big, jnp.int32).at[idx].min(
        x0, mode='drop')[:max_det * max_bh].reshape(max_det, max_bh)
    row_max_x = jnp.full((nrow,), -big, jnp.int32).at[idx].max(
        x1, mode='drop')[:max_det * max_bh].reshape(max_det, max_bh)
    y_tab = jnp.full((nrow,), big, jnp.int32).at[idx].min(
        rows, mode='drop')[:max_det * max_bh].reshape(max_det, max_bh)
    row_valid = row_min_x < big
    min_y = jnp.where(row_valid[:, 0], y_tab[:, 0], big)
    return _stats_tail_from_tables(row_min_x, row_max_x, row_valid, min_y,
                                   max_det=max_det, max_bh=max_bh,
                                   cv2_centers=cv2_centers)


@partial(jax.jit, static_argnames=('max_det', 'max_bh'))
def component_tables(comp_id, mask, gray=None, max_det=1024, max_bh=96):
    """Per-component statistics and convex-hull candidate points (image path).

    :param comp_id: (H, W) int32 dense ids (overflow/background = max_det)
    :param mask: (H, W) bool
    :param gray: optional (H, W) int32 grayscale for luminosity sums
    :param max_det: static detection capacity
    :param max_bh: static max bounding-box height used for the per-row
        x-extremes table (components taller than this lose hull candidates
        in the clipped rows; bacteria are far smaller)
    :return: dict with per-component arrays of shape (max_det, ...):
        count, min_x/max_x/min_y/max_y, candidate points (max_det, 2*max_bh, 2)
        float32 with validity mask, hull-edge angles, optional lum_sum
    """
    h, w = comp_id.shape
    ys, xs = jnp.meshgrid(jnp.arange(h, dtype=jnp.int32),
                          jnp.arange(w, dtype=jnp.int32), indexing='ij')
    return component_stats(xs.reshape(-1), ys.reshape(-1), comp_id.reshape(-1),
                           mask.reshape(-1),
                           gray_vals=None if gray is None else gray.reshape(-1),
                           max_det=max_det, max_bh=max_bh)


def _chain_hull(xs, ys, valid, lower):
    """Monotone-chain convex envelope of per-row extreme points, vectorised
    over components.

    Points are ordered by increasing y with at most one point per row. The
    left boundary of a component is the lower hull of its (y, x_min) points,
    the right boundary the upper hull of (y, x_max).

    :param xs, ys: (D, R) float32 point coordinates (garbage where invalid)
    :param valid: (D, R) bool
    :return: (hull_x, hull_y, hull_size) with shapes (D, R), (D, R), (D,)
    """
    d, r = xs.shape
    sign = jnp.float32(1.0 if lower else -1.0)

    def cross(ox, oy, ax, ay, bx, by):
        # orientation in the (y, x) plane: y plays the abscissa role
        return (ay - oy) * (bx - ox) - (ax - ox) * (by - oy)

    def get(h, idx):
        return jnp.take_along_axis(h, jnp.maximum(idx, 0)[:, None], axis=1)[:, 0]

    # the stack's top two entries live in registers (ax/ay = s[-2],
    # bx/by = s[-1]) so the pop condition needs no gathers at all and a pop
    # costs exactly one gather (refilling s[-2] from the stack)
    def push_step(i, state):
        hx, hy, size, ax, ay, bx, by = state
        px = xs[:, i]
        py = ys[:, i]
        v = valid[:, i]

        def pop_cond(st):
            _, _, size, ax, ay, bx, by = st
            c = cross(ax, ay, bx, by, px, py) * sign
            return jnp.any(v & (size >= 2) & (c <= 0))

        def pop_body(st):
            hx, hy, size, ax, ay, bx, by = st
            c = cross(ax, ay, bx, by, px, py) * sign
            pop = v & (size >= 2) & (c <= 0)
            new_size = size - pop.astype(jnp.int32)
            nax = get(hx, new_size - 2)
            nay = get(hy, new_size - 2)
            ax2 = jnp.where(pop, nax, ax)
            ay2 = jnp.where(pop, nay, ay)
            bx2 = jnp.where(pop, ax, bx)
            by2 = jnp.where(pop, ay, by)
            return hx, hy, new_size, ax2, ay2, bx2, by2

        hx, hy, size, ax, ay, bx, by = jax.lax.while_loop(
            pop_cond, pop_body, (hx, hy, size, ax, ay, bx, by))
        onehot = (jnp.arange(r, dtype=jnp.int32)[None, :] == size[:, None]) & v[:, None]
        hx = jnp.where(onehot, px[:, None], hx)
        hy = jnp.where(onehot, py[:, None], hy)
        ax = jnp.where(v & (size >= 1), bx, ax)
        ay = jnp.where(v & (size >= 1), by, ay)
        bx = jnp.where(v, px, bx)
        by = jnp.where(v, py, by)
        size = size + v.astype(jnp.int32)
        return hx, hy, size, ax, ay, bx, by

    # initial carries derive from the inputs (not constants) so their
    # varying-axes types stay consistent under shard_map
    hx0 = xs * 0.0
    hy0 = ys * 0.0
    size0 = jnp.sum(jnp.zeros_like(valid, dtype=jnp.int32) *
                    valid.astype(jnp.int32), axis=1)
    reg0 = hx0[:, 0]
    hx, hy, size, *_ = jax.lax.fori_loop(
        0, r, push_step, (hx0, hy0, size0, reg0, reg0, reg0, reg0))
    return hx, hy, size


def _hull_edge_angles_chain(row_min_x, row_max_x, row_valid, abs_y):
    """Exact hull-edge candidate angles via sequential monotone chains.

    Reference implementation: a fori_loop over rows with an inner pop
    while_loop per push. Kept for equivalence testing of the vectorised
    slope-matrix version below (the production path: the chain's row-serial
    loop with nested pop loops is many small dependent steps, the slope
    matrix one fused pass).

    :return: (angles (D, 2*(R-1)) float32 in [0, pi/2), valid bool); a
        zero-angle candidate (the horizontal closing edges) is always
        included via the first slot of each chain's edge list when present.
    """
    ys = abs_y.astype(jnp.float32)
    lx = jnp.where(row_valid, row_min_x.astype(jnp.float32), 0.0)
    rx = jnp.where(row_valid, row_max_x.astype(jnp.float32), 0.0)

    def chain_angles(xs, lower):
        hx, hy, size = _chain_hull(xs, ys, row_valid, lower)
        r = hx.shape[1]
        dx = jnp.concatenate([hx[:, 1:] - hx[:, :-1], hx[:, :1] * 0], axis=1)
        dy = jnp.concatenate([hy[:, 1:] - hy[:, :-1], hy[:, :1] * 0], axis=1)
        idx = jnp.arange(r, dtype=jnp.int32)[None, :]
        has_edge = idx < (size[:, None] - 1)
        # pad slot: the first column doubles as the horizontal closing edge
        _, _, ang, valid = _edge_vector_finish(dx, dy, has_edge, r)
        return ang, valid

    la, lv = chain_angles(lx, lower=True)
    ra, rv = chain_angles(rx, lower=False)
    return (jnp.concatenate([la, ra], axis=1),
            jnp.concatenate([lv, rv], axis=1))


def _fold_edge_vector(dx, dy):
    """Fold an integer edge vector to the quadrant dx > 0, dy >= 0 (the
    [0, 90) direction representing its rectangle orientation class).

    Rotations by multiples of 90 degrees keep the components integers, so
    projections onto the folded vector stay exact. A zero vector folds to
    the horizontal (1, 0).
    """
    neg = (dy < 0) | ((dy == 0) & (dx < 0))
    dx = jnp.where(neg, -dx, dx)
    dy = jnp.where(neg, -dy, dy)
    rot = (dx <= 0) & (dy > 0)           # rotate -90: (dx, dy) <- (dy, -dx)
    dx, dy = jnp.where(rot, dy, dx), jnp.where(rot, -dx, dy)
    dx = jnp.where((dx == 0) & (dy == 0), 1.0, dx)
    return dx, dy


def _edge_vector_finish(dx_e, dy_e, has_edge, r):
    """Shared finishing for both hull implementations: fold the integer edge
    vector to [0, 90) and derive its angle; slot 0 doubles as the
    always-present horizontal (closing-edge) candidate."""
    iota = jnp.arange(r - 1, dtype=jnp.int32)
    dx, dy = _fold_edge_vector(dx_e[:, :r - 1], dy_e[:, :r - 1])
    keep = has_edge[:, :r - 1]
    dx = jnp.where(keep, dx, 1.0)
    dy = jnp.where(keep, dy, 0.0)
    ang = jnp.where(keep, jnp.arctan2(dy, dx), 0.0)
    valid = keep | (iota[None, :] == 0)
    return dx, dy, ang, valid


def _hull_edge_data(row_min_x, row_max_x, row_valid, abs_y):
    """Exact hull-edge candidate vectors and angles, fully vectorised.

    The per-row extreme points of a component are sorted by strictly
    increasing y (one point per row), so its left/right hull chains admit a
    closed form with no sequential stack: a point i lies on the chain iff
    the maximum slope into it from below does not exceed the minimum slope
    out of it upward (reversed inequality for the right chain), and its
    outgoing hull edge's slope IS that extremal slope. One (D, R, R) slope
    matrix per chain — built and reduced in a single fused pass — replaces
    the row-serial monotone-chain loops.

    Slope comparisons are exact here: coordinates are integers with
    |dx| <= w and 0 < dy < R, so distinct slopes differ by at least
    1/R^2 while two f32 quotient roundings err by at most ~2*w*2^-23 —
    smaller for any frame width below ~16k/R^2 px (1228*64^2 ~ 4k here).

    :return: (dx, dy, angles, valid, corner_l, corner_r): the first four are
        (D, 2*(R-1)) folded integer edge vectors (dx > 0, dy >= 0 — exact
        projections), their float32 angles in [0, pi/2), and validity; a
        zero-angle candidate (the horizontal closing edges) is always
        included via the first slot of each chain's edge list when present.
        ``corner_l``/``corner_r`` are (D, R) STRICT per-row chain-corner
        masks (collinear mid-points excluded — the cv2 hull vertex set,
        consumed by ops/cv2_centers).
    """
    with jax.named_scope('hull_edges'):
        return _hull_edge_slopes(row_min_x, row_max_x, row_valid, abs_y)


def _hull_edge_slopes(row_min_x, row_max_x, row_valid, abs_y):
    d, r = row_min_x.shape
    ys = abs_y.astype(jnp.float32)
    big = jnp.float32(3.0e38)
    iota = jnp.arange(r, dtype=jnp.int32)
    upper_tri = iota[None, :] > iota[:, None]              # j > i
    pair = (row_valid[:, :, None] & row_valid[:, None, :] &
            upper_tri[None, :, :])                         # (D, R, R) i<j

    def chain_edges(xs, right):
        """Outgoing hull-edge angle per chain vertex.

        ``right=False``: left boundary (x minima) — the hull keeps slope
        dx/dy non-decreasing, so vertex i is on it iff
        max_{j<i} s(j,i) <= min_{j>i} s(i,j) and its outgoing edge has the
        min outgoing slope. ``right=True`` mirrors both extrema.
        """
        x = xs.astype(jnp.float32)
        dy = ys[:, None, :] - ys[:, :, None]               # y_j - y_i
        s = (x[:, None, :] - x[:, :, None]) / jnp.where(pair, dy, 1.0)
        sgn = jnp.float32(-1.0 if right else 1.0)
        s = jnp.where(pair, sgn * s, big)                  # masked pairs
        out_min = jnp.min(s, axis=2)                       # (D, R) over j>i
        in_max = jnp.max(jnp.where(s < big, s, -big), axis=1)  # over j<i
        on_hull = row_valid & (out_min >= in_max)
        strict = row_valid & (out_min > in_max)
        # actual edge endpoint: the FARTHEST j attaining the min slope, so
        # collinear runs collapse to one edge per vertex like the chain
        att = pair & (s <= out_min[:, :, None])
        j_star = jnp.max(jnp.where(att, iota[None, None, :], -1), axis=2)
        has_edge = on_hull & (j_star >= 0)
        jc = jnp.clip(j_star, 0, r - 1)
        dx_e = jnp.take_along_axis(x, jc, axis=1) - x
        dy_e = jnp.take_along_axis(ys, jc, axis=1) - ys
        return _edge_vector_finish(dx_e, dy_e, has_edge, r) + (strict,)

    lx, ly, la, lv, cl = chain_edges(row_min_x, right=False)
    rx, ry, ra, rv, cr = chain_edges(row_max_x, right=True)
    return (jnp.concatenate([lx, rx], axis=1),
            jnp.concatenate([ly, ry], axis=1),
            jnp.concatenate([la, ra], axis=1),
            jnp.concatenate([lv, rv], axis=1), cl, cr)


def _hull_edge_angles(row_min_x, row_max_x, row_valid, abs_y):
    """Back-compat wrapper returning only (angles, valid)."""
    _, _, ang, valid, _, _ = _hull_edge_data(row_min_x, row_max_x, row_valid,
                                             abs_y)
    return ang, valid


def _sweep_extents(pts, valid, angles):
    """Extents of candidate points along a set of directions.

    :param pts: (D, P, 2) float32; valid (D, P) bool; angles (K,) radians
    :return: (min_u, max_u, min_v, max_v) each (D, K)
    """
    cos = jnp.cos(angles)
    sin = jnp.sin(angles)
    # u = (cos, sin), v = (-sin, cos)
    proj_u = pts[..., 0][:, None, :] * cos[None, :, None] + \
        pts[..., 1][:, None, :] * sin[None, :, None]     # (D, K, P)
    proj_v = -pts[..., 0][:, None, :] * sin[None, :, None] + \
        pts[..., 1][:, None, :] * cos[None, :, None]
    big = jnp.float32(3.0e38)
    vmask = valid[:, None, :]
    min_u = jnp.min(jnp.where(vmask, proj_u, big), axis=-1)
    max_u = jnp.max(jnp.where(vmask, proj_u, -big), axis=-1)
    min_v = jnp.min(jnp.where(vmask, proj_v, big), axis=-1)
    max_v = jnp.max(jnp.where(vmask, proj_v, -big), axis=-1)
    return min_u, max_u, min_v, max_v


def _projected_extents(pts, valid, ux, uy, big):
    """Per-component extents of the points along K directions.

    Projections ``u = x*ux + y*uy`` and ``v = y*ux - x*uy`` onto each
    component's own (ux, uy) direction and its normal. The (D, K, P)
    projections are an elementwise producer of the reductions, so XLA fuses
    them and nothing of that size reaches device memory.

    :param pts: (D, P, 2) float32; valid (D, P) bool
    :param ux, uy: (D, K) float32 direction components (unnormalised
        integer edge vectors, or cos/sin of angles)
    :return: (min_u, max_u, min_v, max_v), each (D, K); all-invalid
        components give +big/-big
    """
    with jax.named_scope('rotated_extents'):
        dxb = ux[:, :, None]
        dyb = uy[:, :, None]
        px = pts[..., 0][:, None, :]
        py = pts[..., 1][:, None, :]
        pu = px * dxb + py * dyb
        pv = py * dxb - px * dyb
        vm = valid[:, None, :]
        return (jnp.min(jnp.where(vm, pu, big), axis=-1),
                jnp.max(jnp.where(vm, pu, -big), axis=-1),
                jnp.min(jnp.where(vm, pv, big), axis=-1),
                jnp.max(jnp.where(vm, pv, -big), axis=-1))


def _min_area_rect_exact(pts, valid, edge_dx, edge_dy, edge_angles,
                         edge_valid):
    """Exact minimum-area rectangle over integer hull-edge candidates.

    The minimal enclosing rectangle always has a side collinear with a hull
    edge (rotating calipers), and the hull edges of integer pixel centres
    have integer direction vectors — so projections U = x*dx + y*dy and
    V = y*dx - x*dy are *exact* float32 integers (|U| < 2^24 for any frame
    below ~4k px on a side), the scaled area (dU * dV) is an exact
    double-single product, and the true area dU*dV/(dx^2+dy^2) is a
    double-single quotient accurate to ~1e-13 relative. Candidate areas are
    therefore compared exactly: no coarse/fine sweep, no angular epsilon.
    Equal-area ties are true rational ties and resolve to the largest-angle
    candidate (cv2's calipers visits edges in increasing rotation and
    replaces on <=; verified against cv2 in tests/test_labeling.py).
    """
    from ysmr_tpu.ops import ds
    d = edge_dx.shape[0]
    rows = jnp.arange(d)
    big = jnp.float32(3.0e38)
    # the hull's closing edges (top/bottom row) are horizontal and are NOT
    # emitted by the left/right chains — append an always-valid (1, 0)
    # candidate so the axis-aligned rectangle is always considered
    one = jnp.ones((d, 1), edge_dx.dtype)
    edge_dx = jnp.concatenate([edge_dx, one], axis=1)
    edge_dy = jnp.concatenate([edge_dy, one * 0.0], axis=1)
    edge_angles = jnp.concatenate([edge_angles, one * 0.0], axis=1)
    edge_valid = jnp.concatenate(
        [edge_valid, jnp.ones((d, 1), bool)], axis=1)
    k = edge_dx.shape[1]
    min_u, max_u, min_v, max_v = _projected_extents(pts, valid, edge_dx,
                                                    edge_dy, big)
    # all-invalid components give inverted +-big extents; clamp to keep the
    # arithmetic NaN-free (their outputs are masked by det_valid downstream)
    du = jnp.maximum(max_u - min_u, 0.0)
    dv = jnp.maximum(max_v - min_v, 0.0)
    l2 = edge_dx * edge_dx + edge_dy * edge_dy
    a_h, a_l = ds.two_prod(du, dv)
    area_h, area_l = ds.div_by_f32(a_h, a_l, l2)
    area_h = jnp.where(edge_valid, area_h, big)
    area_l = jnp.where(edge_valid, area_l, 0.0)

    # double-single minimum over candidates (pairwise halving)
    mh, ml = area_h, area_l
    n = k
    while n > 1:
        half = n // 2
        if n % 2:
            lt = (mh[:, n - 1] < mh[:, 0]) | \
                 ((mh[:, n - 1] == mh[:, 0]) & (ml[:, n - 1] < ml[:, 0]))
            mh = mh.at[:, 0].set(jnp.where(lt, mh[:, n - 1], mh[:, 0]))
            ml = ml.at[:, 0].set(jnp.where(lt, ml[:, n - 1], ml[:, 0]))
        ah_, al_ = mh[:, :half], ml[:, :half]
        bh_, bl_ = mh[:, half:2 * half], ml[:, half:2 * half]
        lt = (bh_ < ah_) | ((bh_ == ah_) & (bl_ < al_))
        mh = jnp.where(lt, bh_, ah_)
        ml = jnp.where(lt, bl_, al_)
        n = half
    # ties: double-single noise is ~1e-13 relative while distinct rational
    # areas differ by >= 1/(l2_i * l2_j) — 1e-9 relative separates them for
    # any realistic component scale
    diff_h, _ = ds.sub(area_h, area_l, mh, ml)
    tie = edge_valid & (diff_h <= mh * jnp.float32(1e-9) + jnp.float32(1e-9))
    ebest = jnp.argmax(jnp.where(tie, edge_angles, -1.0), axis=1)

    bdx = edge_dx[rows, ebest]
    bdy = edge_dy[rows, ebest]
    bl2 = l2[rows, ebest]
    bl = jnp.sqrt(bl2)
    w_side = du[rows, ebest] / bl
    h_side = dv[rows, ebest] / bl
    cu2 = min_u[rows, ebest] + max_u[rows, ebest]   # 2 * scaled centre
    cv2_ = min_v[rows, ebest] + max_v[rows, ebest]
    t1h, t1l = ds.two_prod(cu2, bdx)
    t2h, t2l = ds.two_prod(cv2_, bdy)
    nxh, nxl = ds.sub(t1h, t1l, t2h, t2l)
    t3h, t3l = ds.two_prod(cu2, bdy)
    t4h, t4l = ds.two_prod(cv2_, bdx)
    nyh, nyl = ds.add(t3h, t3l, t4h, t4l)
    inv = 1.0 / (2.0 * bl2)
    cx = nxh * inv + nxl * inv
    cy = nyh * inv + nyl * inv
    ang_deg = jnp.degrees(edge_angles[rows, ebest])
    # cv2's classic representation: angle in [-90, 0), w along its direction
    return {'cx': cx, 'cy': cy, 'w': h_side, 'h': w_side,
            'angle_deg': ang_deg - 90.0}


@partial(jax.jit, static_argnames=('coarse_k', 'fine_k'))
def min_area_rect(pts, valid, edge_angles=None, edge_valid=None,
                  edge_dx=None, edge_dy=None, coarse_k=96, fine_k=17):
    """Minimum-area enclosing rectangle.

    Semantics of cv2.minAreaRect on the component's pixel-centre point set
    (track_eval.py:287): returns centre (cx, cy), side lengths (w, h) as
    point-extents, and the angle in cv2's classic convention — degrees in
    [-90, 0) with w being the extent along the reported angle's direction
    (an axis-aligned rect reports -90 with w = the vertical extent).

    With integer hull-edge vectors (``edge_dx``/``edge_dy`` from
    component_stats) the selection is EXACT — see _min_area_rect_exact.
    Without them a coarse-to-fine float32 angle sweep is used (exact up to
    90 deg / coarse_k / fine_k angular resolution).

    Known deviation: when several hull edges yield exactly the minimal area
    (common for tiny symmetric integer blobs), OpenCV's choice among them is
    decided by float32 rounding noise in its incremental caliper arithmetic
    and is not deterministically reproducible; this build picks the
    largest-angle tying edge (the calipers' last-visited on exact ties),
    which matches cv2 in the overwhelming majority of cases. The enclosed
    area — which drives the selection gates — is always identical; only the
    (w, h, angle) decomposition can differ on such ties.

    :param pts: (D, P, 2) float32 hull candidates; valid (D, P) bool
    :return: dict of (D,) arrays: cx, cy, w, h, angle_deg
    """
    d = pts.shape[0]
    half_pi = jnp.float32(np.pi / 2)
    coarse = jnp.arange(coarse_k, dtype=jnp.float32) * (half_pi / coarse_k)

    if edge_dx is not None:
        return _min_area_rect_exact(pts, valid, edge_dx, edge_dy,
                                    edge_angles, edge_valid)

    def fine_extents(p, vmask, ang):
        return _projected_extents(p, vmask, jnp.cos(ang), jnp.sin(ang),
                                  jnp.float32(3.0e38))

    min_u, max_u, min_v, max_v = _sweep_extents(pts, valid, coarse)
    area = (max_u - min_u) * (max_v - min_v)
    best = jnp.argmin(area, axis=1)  # (D,)
    best_angle = coarse[best]
    step = half_pi / coarse_k
    half = (fine_k - 1) // 2

    # iterative zoom: each stage re-centres a (fine_k)-point grid on the
    # current optimum and shrinks the span by (fine_k-1)/2; the grid always
    # contains the previous optimum so area never regresses
    rows = jnp.arange(d)
    ang = best_angle
    cur_step = step
    for _ in range(3):
        offs = (jnp.arange(fine_k, dtype=jnp.float32) - half) * \
            (cur_step / max(half, 1))
        fine = ang[:, None] + offs[None, :]  # (D, K2)
        fmin_u, fmax_u, fmin_v, fmax_v = fine_extents(pts, valid, fine)
        farea = (fmax_u - fmin_u) * (fmax_v - fmin_v)
        fbest = jnp.argmin(farea, axis=1)
        ang = fine[rows, fbest]
        cur_step = cur_step / max(half, 1)
    mu0, mu1 = fmin_u[rows, fbest], fmax_u[rows, fbest]
    mv0, mv1 = fmin_v[rows, fbest], fmax_v[rows, fbest]

    if edge_angles is not None:
        # evaluate hull-edge candidate angles and prefer them whenever they
        # tie (or beat) the sweep optimum — cv2's calipers always returns a
        # hull-edge-aligned rectangle. The calipers starts axis-aligned and
        # visits edges in increasing angle, replacing the best on <=, so
        # among tying edges the LAST visited — the largest angle in (0, 90)
        # — wins, and an axis-aligned candidate (angle 0) loses all ties
        # (verified against cv2 in tests on tie-rich integer blobs).
        big = jnp.float32(3.0e38)
        ea = jnp.where(edge_valid, edge_angles, 0.0)
        emin_u, emax_u, emin_v, emax_v = fine_extents(pts, valid, ea)
        earea = (emax_u - emin_u) * (emax_v - emin_v)
        earea = jnp.where(edge_valid, earea, big)
        e_area_min = jnp.min(earea, axis=1, keepdims=True)
        tie = earea <= e_area_min * (1 + 1e-5) + 1e-5
        ebest = jnp.argmax(jnp.where(tie, ea, -1.0), axis=1)
        e_area_best = earea[rows, ebest]
        f_area_best = farea[rows, fbest]
        take_edge = e_area_best <= f_area_best * (1 + 1e-5) + 1e-5
        ang = jnp.where(take_edge, ea[rows, ebest], ang)
        mu0 = jnp.where(take_edge, emin_u[rows, ebest], mu0)
        mu1 = jnp.where(take_edge, emax_u[rows, ebest], mu1)
        mv0 = jnp.where(take_edge, emin_v[rows, ebest], mv0)
        mv1 = jnp.where(take_edge, emax_v[rows, ebest], mv1)
    w_side = mu1 - mu0
    h_side = mv1 - mv0
    cu = (mu0 + mu1) * 0.5
    cv_ = (mv0 + mv1) * 0.5
    cos = jnp.cos(ang)
    sin = jnp.sin(ang)
    cx = cu * cos - cv_ * sin
    cy = cu * sin + cv_ * cos
    # normalise the sweep angle into [0, 90) keeping w along it...
    ang_deg = jnp.degrees(ang)
    neg = ang_deg < 0
    ang_deg = jnp.where(neg, ang_deg + 90.0, ang_deg)
    w_out = jnp.where(neg, h_side, w_side)
    h_out = jnp.where(neg, w_side, h_side)
    over = ang_deg >= 90.0
    ang_deg = jnp.where(over, ang_deg - 90.0, ang_deg)
    w_out2 = jnp.where(over, h_out, w_out)
    h_out2 = jnp.where(over, w_out, h_out)
    # ...then emit cv2's own representation (verified against cv2 5.0 on
    # this host, tests/test_labeling.py): angle in [-90, 0) with w = the
    # extent along the reported angle's direction. An internal angle a in
    # [0, 90) with w along a describes the same rectangle as cv2's
    # (w', h', a') = (h, w, a - 90) — the interchange _list.csv columns
    # WIDTH/HEIGHT/DEGREES_ANGLE match the reference row-for-row this way
    # (track_eval.py:287,313-316).
    return {'cx': cx, 'cy': cy, 'w': h_out2, 'h': w_out2,
            'angle_deg': ang_deg - 90.0}

#!/usr/bin/env python3
"""Run-graph connected components on compact run tables.

Thresholded masks arrive over the wire as horizontal runs (native
``encode_runs_batch``: per frame a raster-ordered list of (start, length,
marker) with runs never crossing row boundaries). Connected-components
labeling — the dominant device cost of the detect stage — is then a graph
problem over the runs themselves: two runs in ADJACENT rows connect iff
their x-intervals overlap (dilated by one pixel for 8-connectivity), and
same-row wire runs connect iff exactly consecutive (the encoder splits
maximal runs at marker changes, at 31 pixels, and at row ends). Min-label
propagation over the (T, R) run tables replaces whole-frame stencil
labeling over (T, H*W) pixel planes — at the reference geometry runs are
~60x fewer elements than pixels, and every op here is a table sort, a
shifted elementwise min, or a compact-table gather (reference hot loop:
track_eval.py:273-283 via cv2.findContours).

Edge set and exactness
----------------------
Each run carries four window pointers: the FIRST and LAST run of its
overlap window in the row above and below (windows are contiguous index
ranges because runs are raster-ordered). The propagation graph links each
run to those four endpoints, to its exactly-consecutive same-row
neighbours, and to its same-row successor whenever their windows into a
common adjacent row intersect (a valid shortcut: intersecting windows
share an overlapping run, so a real two-hop path exists). Interior window
members are then reachable: consecutive members of run i's window all
overlap i, hence are chained by shortcuts, and i touches the chain at its
endpoints. Endpoint links alone are NOT connectivity-preserving (fuzzed
counterexamples exist); with the shortcut links the fixpoint partition is
exact — fuzzed against scipy.ndimage.label in tests/test_run_cc.py.

The same propagation kernel performs the double-threshold marker
reconstruction (scipy.ndimage.binary_propagation semantics, 4-connected:
keep mask components containing a marker pixel — reference
track_eval.py:211-214): marked runs start at their own index, unmarked at
index + R, and a component survives iff its minimum drops below R.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

#: sentinel larger than any real sort key (keys are < 2^22 after packing)
_BIG = np.int32(1 << 28)  # numpy, not jnp: keep imports backend-free


def decode_runs(px_runs, run_counts, w):
    """Unpack the run wire into per-run geometry tables.

    :param px_runs: (T, R) uint32 — bits 0..25 start ``y*w+x``, bit 26
        marker, bits 27..31 length 1..31 (native encode_runs_batch)
    :param run_counts: (T,) int32 valid runs per frame (valid = prefix)
    :param w: frame width (runs never cross row boundaries)
    :return: dict of (T, R) int32 ``rows, xs, xe, lens`` + bool
        ``rmark, valid``
    """
    t, r = px_runs.shape
    runs = px_runs.astype(jnp.uint32)
    starts = (runs & jnp.uint32(0x03FFFFFF)).astype(jnp.int32)
    rmark = ((runs >> 26) & jnp.uint32(1)) > 0
    lens = (runs >> 27).astype(jnp.int32)
    valid = jnp.arange(r, dtype=jnp.int32)[None, :] < run_counts[:, None]
    valid = valid & (lens > 0)
    rows = starts // w
    xs = starts % w
    return {'rows': rows, 'xs': xs, 'xe': xs + lens - 1, 'lens': lens,
            'rmark': rmark & valid, 'valid': valid}


def _searchsorted_batch(data_key, query_key, *, right):
    """Batched searchsorted via one sort-merge (no per-element gathers).

    For each query, the number of data elements with key < q (``right`` =
    False) or key <= q (True). Data keys must be non-decreasing per row
    wherever they matter (invalid entries use keys sorted to the end);
    the merge itself only needs a stable combined sort, so this holds by
    construction. Vmapped jnp.searchsorted lowers to a per-element gather
    loop; two lax.sorts replace it.

    :param data_key: (T, R) int32
    :param query_key: (T, Q) int32
    :return: (T, Q) int32 counts in [0, R]
    """
    t, r = data_key.shape
    q = query_key.shape[1]
    # tie order: 'left' sorts queries before equal data keys, 'right' after
    tie = jnp.int32(0 if right else 1)
    k_data = data_key * 2 + tie
    k_query = query_key * 2 + (1 - tie)
    keys = jnp.concatenate([k_data, k_query], axis=1)
    is_data = jnp.concatenate(
        [jnp.ones((t, r), jnp.int32), jnp.zeros((t, q), jnp.int32)], axis=1)
    pos = jnp.broadcast_to(jnp.arange(r + q, dtype=jnp.int32)[None, :],
                           (t, r + q))
    _, s_data, s_pos = jax.lax.sort((keys, is_data, pos), dimension=1,
                                    num_keys=1)
    # each query's answer = number of data elements before it in the merged
    # order; the tie encoding above makes 'before' mean < or <= respectively
    counts = jnp.cumsum(s_data, axis=1) - s_data
    # unsort: bring per-element counts back to combined order, slice queries
    _, back = jax.lax.sort((s_pos, counts), dimension=1, num_keys=1)
    return back[:, r:]


def run_windows_multi(geo, *, dilates):
    """Overlap-window endpoints into the adjacent rows, per run.

    All requested dilations share one sort-merge pair (the searchsorted
    sorts are the windows' whole cost, so batching the 4-conn and 8-conn
    queries halves it).

    :param geo: decode_runs output
    :param dilates: tuple of dilations (1 for 8-connectivity, 0 for 4)
    :return: one dict per dilation with lo_up, hi_up, ok_up, lo_dn, hi_dn,
        ok_dn — (T, R) int32 / bool; indices point into the same
        (raster-ordered) run table
    """
    rows, xs, xe, valid = geo['rows'], geo['xs'], geo['xe'], geo['valid']
    # pack (row, x) into one monotone key; +2 margin covers xs-1 / xe+1
    m = geo['key_m']
    base = rows * m
    key_e = jnp.where(valid, base + xe, _BIG)
    key_s = jnp.where(valid, base + xs, _BIG)
    q_lo = jnp.concatenate(
        [q for d in dilates
         for q in ((base - m) + (xs - d), (base + m) + (xs - d))], axis=1)
    q_hi = jnp.concatenate(
        [q for d in dilates
         for q in ((base - m) + (xe + d), (base + m) + (xe + d))], axis=1)
    r = rows.shape[1]
    lo_all = _searchsorted_batch(key_e, q_lo, right=False)
    hi_all = _searchsorted_batch(key_s, q_hi, right=True) - 1
    outs = []
    for k, _ in enumerate(dilates):
        lo_up, lo_dn = lo_all[:, 2 * k * r:(2 * k + 1) * r], \
            lo_all[:, (2 * k + 1) * r:(2 * k + 2) * r]
        hi_up, hi_dn = hi_all[:, 2 * k * r:(2 * k + 1) * r], \
            hi_all[:, (2 * k + 1) * r:(2 * k + 2) * r]
        ok_up = valid & (lo_up <= hi_up)
        ok_dn = valid & (lo_dn <= hi_dn)
        outs.append({'lo_up': lo_up, 'hi_up': hi_up, 'ok_up': ok_up,
                     'lo_dn': lo_dn, 'hi_dn': hi_dn, 'ok_dn': ok_dn})
    return outs


def run_windows(geo, *, dilate):
    """Single-dilation convenience wrapper over run_windows_multi."""
    return run_windows_multi(geo, dilates=(dilate,))[0]


def chain_mask(geo, win):
    """(T, R) bool: run i is linked to run i+1 (last column False).

    Links: exactly-consecutive same-row runs (wire splits of one maximal
    run), plus the window-intersection shortcut described in the module
    docstring (both directions).
    """
    rows, xs, xe, valid = geo['rows'], geo['xs'], geo['xe'], geo['valid']

    def nxt(a):
        return jnp.concatenate([a[:, 1:], a[:, :1] * 0 - 1], axis=1)

    def nxt_b(a):
        return jnp.concatenate([a[:, 1:], jnp.zeros_like(a[:, :1])], axis=1)

    same_row = valid & nxt_b(valid) & (nxt(rows) == rows)
    consec = same_row & (nxt(xs) == xe + 1)
    cut_up = same_row & win['ok_up'] & nxt_b(win['ok_up']) & \
        (win['hi_up'] >= nxt(win['lo_up']))
    cut_dn = same_row & win['ok_dn'] & nxt_b(win['ok_dn']) & \
        (win['hi_dn'] >= nxt(win['lo_dn']))
    return consec | cut_up | cut_dn


@partial(jax.jit, static_argnames=('max_iters', 'check_every'))
def propagate_min(init, win, link, *, max_iters=64, check_every=2):
    """Min-label fixpoint over the run graph.

    Labels are per-frame run indices, possibly offset by +R to encode a
    'weak' class (marker reconstruction); the pointer jump reads through
    ``label mod R``, which is always a run index inside the same component.

    Each step relaxes one hop along the same-row chain edges (two shifted
    mins), takes the four adjacent-row window endpoints (one flat gather
    with step-invariant indices), and path-halves (one flat gather). At
    (T, R) table sizes every XLA op is launch-overhead-bound on this chip,
    so the cheap constant-op step beats per-step segmented chain scans
    (log-width associative scans were ~5x the per-step cost); path halving
    keeps the total logarithmic in the component's run-graph diameter.
    Batching both gathers into ONE five-plane gather (Jacobi form) was
    TRIED and is ~40% slower — the concatenation with the dynamic
    path-halving indices defeats XLA's specialization of the
    static-index window gather. Convergence on bacteria-scale blobs lands
    in ~5 steps, so ``check_every`` defaults low: wasted post-convergence
    steps cost more than the extra convergence checks (measured 54 vs 64
    vs 102 ms/batch for check_every 2/4/8 on the bench clip).

    :param init: (T, R) int32 initial labels
    :param win: run_windows output
    :param link: chain_mask output
    :return: (T, R) int32 converged labels
    """
    t, r = init.shape
    t_off = jnp.arange(t, dtype=jnp.int32)[:, None] * r
    idx4 = jnp.concatenate([win['lo_up'], win['hi_up'],
                            win['lo_dn'], win['hi_dn']], axis=1)
    idx4 = jnp.clip(idx4, 0, r - 1) + t_off
    ok4 = jnp.concatenate([win['ok_up'], win['ok_up'],
                           win['ok_dn'], win['ok_dn']], axis=1)
    big = jnp.int32(2 ** 30)
    # link[i] joins i and i+1 (last column False by construction)
    link_l = jnp.concatenate([jnp.zeros_like(link[:, :1]), link[:, :-1]],
                             axis=1)

    def step(lab):
        nxt = jnp.concatenate([lab[:, 1:], jnp.full_like(lab[:, :1], big)],
                              axis=1)
        prv = jnp.concatenate([jnp.full_like(lab[:, :1], big), lab[:, :-1]],
                              axis=1)
        lab = jnp.minimum(lab, jnp.minimum(jnp.where(link, nxt, big),
                                           jnp.where(link_l, prv, big)))
        flat = lab.reshape(-1)
        v4 = jnp.where(ok4, flat[idx4.reshape(-1)].reshape(t, 4 * r), big)
        lab = jnp.minimum(lab, v4.reshape(t, 4, r).min(axis=1))
        # pointer jump (path halving): label mod R names a run inside my
        # own component; adopting that run's current label is monotone and
        # in-component (for the +R weak encoding the target's label already
        # carries the right strong/weak class, so no offset is re-applied)
        flat2 = lab.reshape(-1)
        tgt = jnp.where(lab >= r, lab - r, lab)
        jmp = flat2[(jnp.clip(tgt, 0, r - 1) + t_off).reshape(-1)]
        return jnp.minimum(lab, jmp.reshape(t, r))

    def body(state):
        lab, _, it = state
        new = lab
        for _ in range(check_every):
            new = step(new)
        return new, jnp.any(new != lab), it + check_every

    def cond(state):
        _, changed, it = state
        return changed & (it < max_iters)

    with jax.named_scope('run_cc_fixpoint'):
        lab, _, _ = jax.lax.while_loop(
            cond, body, (init, jnp.bool_(True), jnp.int32(0)))
    return lab


def _prepare(px_runs, run_counts, *, w):
    geo = decode_runs(px_runs, run_counts, w)
    geo['key_m'] = w + 2
    return geo


@partial(jax.jit, static_argnames=('w', 'connectivity', 'max_iters',
                                   'check_every'))
def label_runs(px_runs, run_counts, *, w, connectivity=8, max_iters=64,
               check_every=2):
    """Connected-component root (min run index) per run; invalid = self."""
    geo = _prepare(px_runs, run_counts, w=w)
    win = run_windows(geo, dilate=1 if connectivity == 8 else 0)
    link = chain_mask(geo, win)
    t, r = geo['rows'].shape
    iota = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :], (t, r))
    return propagate_min(iota, win, link, max_iters=max_iters,
                         check_every=check_every)


@partial(jax.jit, static_argnames=('w', 'double_threshold', 'max_iters',
                                   'check_every'))
def run_cc_components(px_runs, run_counts, *, w, double_threshold,
                      max_iters=64, check_every=2):
    """Full detect labeling on run tables: reconstruction + 8-conn CC.

    Pipeline (all on (T, R) tables): optional marker reconstruction
    (4-connected, keep mask components containing a marker — reference
    track_eval.py:211-214) -> stable compaction of surviving runs ->
    8-connected components -> ascending raster-rank component ids (the
    caller reverses them to cv2's contour enumeration order,
    track_eval.py:273-283).

    :return: dict with
        ``run_comp`` (T, R) int32 — ascending component id per ORIGINAL
        wire run (-1 = dropped by reconstruction / invalid),
        ``n_components`` (T,) int32,
        plus the kept-run geometry in component-sorted order for the pixel
        expansion: ``s_start, s_len, s_comp`` (T, R) int32 (slots beyond
        the frame's kept-run count carry len 0), and ``n_px`` (T,) int32
        total kept pixels per frame.
    """
    geo = _prepare(px_runs, run_counts, w=w)
    t, r = geo['rows'].shape
    iota = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :], (t, r))
    t_off = jnp.arange(t, dtype=jnp.int32)[:, None] * r
    prop = partial(propagate_min, check_every=check_every)
    if double_threshold:
        # both connectivities' windows in ONE sort-merge pair; the 8-conn
        # windows are remapped onto the compacted table below instead of
        # being rebuilt with another four sorts
        win4, win8o = run_windows_multi(geo, dilates=(0, 1))
        link4 = chain_mask(geo, win4)
        init = jnp.where(geo['rmark'], iota, iota + r)
        lab4 = prop(init, win4, link4, max_iters=max_iters)
        keep = geo['valid'] & (lab4 < r)

        # stable compaction: surviving runs first, raster order preserved
        ckey = jnp.where(keep, iota, iota + r)
        _, c_rows, c_xs, c_xe, c_len, c_orig = jax.lax.sort(
            (ckey, geo['rows'], geo['xs'], geo['xe'], geo['lens'], iota),
            dimension=1, num_keys=1)
        n_kept = jnp.sum(keep.astype(jnp.int32), axis=1)
        c_valid = iota < n_kept[:, None]

        # window remap: compaction is a stable subset, so kept runs with
        # original index in [lo, hi] occupy the contiguous compacted range
        # [#kept strictly before lo, #kept through hi - 1] — two prefix-sum
        # lookups replace the four searchsorted sorts of a rebuild. All
        # lookups batch into two flat gathers (window fields at c_orig,
        # then prefix sums at the window endpoints).
        kc = jnp.cumsum(keep.astype(jnp.int32), axis=1)
        before = (kc - keep.astype(jnp.int32)).reshape(-1)  # kept before i
        through = kc.reshape(-1)                            # kept through i
        fields = jnp.stack(
            [win8o['lo_up'], win8o['hi_up'], win8o['lo_dn'], win8o['hi_dn'],
             win8o['ok_up'].astype(jnp.int32),
             win8o['ok_dn'].astype(jnp.int32)]).reshape(6, -1)
        j = (c_orig + t_off).reshape(-1)
        g = fields[:, j].reshape(6, t, r)
        lo_up_o, hi_up_o, lo_dn_o, hi_dn_o = g[0], g[1], g[2], g[3]
        ok_up_o, ok_dn_o = g[4] > 0, g[5] > 0
        lo_idx = (jnp.clip(jnp.stack([lo_up_o, lo_dn_o]), 0, r - 1) +
                  t_off[None]).reshape(2, -1)
        hi_idx = (jnp.clip(jnp.stack([hi_up_o, hi_dn_o]), 0, r - 1) +
                  t_off[None]).reshape(2, -1)
        lo2 = before[lo_idx.reshape(-1)].reshape(2, t, r)
        hi2 = (through[hi_idx.reshape(-1)] - 1).reshape(2, t, r)
        win8 = {'lo_up': lo2[0], 'hi_up': hi2[0],
                'ok_up': c_valid & ok_up_o & (lo2[0] <= hi2[0]),
                'lo_dn': lo2[1], 'hi_dn': hi2[1],
                'ok_dn': c_valid & ok_dn_o & (lo2[1] <= hi2[1])}
        geo8 = {'rows': c_rows, 'xs': c_xs, 'xe': c_xe, 'valid': c_valid,
                'key_m': geo['key_m']}
    else:
        # valid runs are a prefix, so the compaction is the identity
        keep = geo['valid']
        c_rows, c_xs, c_xe, c_len, c_orig = (
            geo['rows'], geo['xs'], geo['xe'], geo['lens'], iota)
        c_valid = keep
        geo8 = dict(geo)
        win8 = run_windows(geo8, dilate=1)
    link8 = chain_mask(geo8, win8)
    lab8 = prop(iota, win8, link8, max_iters=max_iters)

    # component ids: ascending rank of roots in raster order (root = run of
    # minimum index = the component's topmost-leftmost run)
    roots = c_valid & (lab8 == iota)
    rank = jnp.cumsum(roots.astype(jnp.int32), axis=1) - 1
    n_components = jnp.sum(roots.astype(jnp.int32), axis=1)
    flat_rank = rank.reshape(-1)
    asc = flat_rank[(jnp.clip(lab8, 0, r - 1) + t_off).reshape(-1)]
    asc = asc.reshape(t, r)
    comp_c = jnp.where(c_valid, asc, -1)

    # map ids back to original wire-run order (c_orig is a permutation)
    run_comp = jnp.zeros((t * r,), jnp.int32).at[
        (c_orig + t_off).reshape(-1)].set(
        comp_c.reshape(-1), mode='drop', unique_indices=True).reshape(t, r)

    # component-sorted kept runs for the pixel expansion: components
    # contiguous, linear index ascending within (component order itself is
    # irrelevant to the consumers — _row_tables_sorted is table-indexed)
    c_start = c_xs + c_rows * w
    skey = jnp.where(c_valid, asc, jnp.int32(2 ** 30))
    c_len_v = jnp.where(c_valid, c_len, 0)
    _, _, s_start, s_len, s_comp = jax.lax.sort(
        (skey, c_start, c_start, c_len_v, comp_c), dimension=1, num_keys=2)
    n_px = jnp.sum(c_len_v, axis=1)
    return {'run_comp': run_comp, 'n_components': n_components,
            's_start': s_start, 's_len': s_len, 's_comp': s_comp,
            'n_px': n_px}


@partial(jax.jit, static_argnames=('f', 'w', 'max_det'))
def expand_sorted_runs(s_start, s_len, s_comp_rev, *, f, w, max_det):
    """Component-sorted runs -> (T, F) pixel tables for the stats path.

    Linear indices are reconstructed with the jump-delta trick (one 1-per-run
    scatter + a cumsum; no per-pixel gathers): within a run lin increments by
    one, and at each run start it jumps by (start - prev_end + 1) — the
    deltas may be negative across component boundaries, which the cumsum
    handles exactly. Component ids expand through a run-ordinal cummax.

    :param s_start, s_len: (T, R) int32 sorted-run geometry (len 0 = pad)
    :param s_comp_rev: (T, R) int32 reverse (cv2-order) component id per run
    :return: (px_x, px_y, seg, active) — (T, F) tables ordered by
        (component, lin), matching component_stats(sorted_runs=True)
    """
    t, r = s_start.shape
    lens = s_len
    ends = jnp.cumsum(lens, axis=1)
    offs = ends - lens
    n_px = ends[:, -1]
    t_off_f = jnp.arange(t, dtype=jnp.int32)[:, None] * f
    oob = (jnp.int32(t * f) +
           jnp.arange(t * r, dtype=jnp.int32).reshape(t, r))
    ok = lens > 0
    flat_idx = jnp.where(ok & (offs < f), offs + t_off_f, oob)
    prev_end = jnp.concatenate(
        [jnp.ones((t, 1), jnp.int32), (s_start + lens)[:, :-1]], axis=1)
    jumps = s_start - prev_end + 1
    d_flat = jnp.ones((t * f,), jnp.int32).at[flat_idx.reshape(-1)].add(
        (jumps - 1).reshape(-1), mode='drop', unique_indices=True)
    lin = jnp.cumsum(d_flat.reshape(t, f), axis=1)
    rid_flat = jnp.zeros((t * f,), jnp.int32).at[flat_idx.reshape(-1)].set(
        jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :],
                         (t, r)).reshape(-1),
        mode='drop', unique_indices=True)
    rid = jax.lax.cummax(rid_flat.reshape(t, f), axis=1)
    comp_at = jnp.take_along_axis(s_comp_rev, rid, axis=1)
    active = jnp.arange(f, dtype=jnp.int32)[None, :] < n_px[:, None]
    seg = jnp.where(active, jnp.minimum(jnp.maximum(comp_at, 0), max_det),
                    max_det)
    return lin % w, lin // w, seg, active


@partial(jax.jit, static_argnames=('f', 'max_det'))
def det_px_from_runs(px_runs, run_counts, comp_rev_run, *, f, max_det):
    """Wire-order per-pixel detection index from per-run component ids.

    Feeds the host-side cv2-bit-exact rect measurement (same contract as
    the sorted path's det_px_idx: -1 = background / dropped / >= max_det).
    """
    t, r = px_runs.shape
    runs = px_runs.astype(jnp.uint32)
    lens = (runs >> 27).astype(jnp.int32)
    rvalid = jnp.arange(r, dtype=jnp.int32)[None, :] < run_counts[:, None]
    lens = jnp.where(rvalid, lens, 0)
    ends = jnp.cumsum(lens, axis=1)
    offs = ends - lens
    n_px = ends[:, -1]
    t_off_f = jnp.arange(t, dtype=jnp.int32)[:, None] * f
    oob = (jnp.int32(t * f) +
           jnp.arange(t * r, dtype=jnp.int32).reshape(t, r))
    flat_idx = jnp.where((lens > 0) & (offs < f), offs + t_off_f, oob)
    rid_flat = jnp.zeros((t * f,), jnp.int32).at[flat_idx.reshape(-1)].set(
        jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :],
                         (t, r)).reshape(-1),
        mode='drop', unique_indices=True)
    rid = jax.lax.cummax(rid_flat.reshape(t, f), axis=1)
    g = jnp.take_along_axis(comp_rev_run, rid, axis=1)
    active = jnp.arange(f, dtype=jnp.int32)[None, :] < n_px[:, None]
    return jnp.where(active & (g >= 0) & (g < max_det), g, -1)


@partial(jax.jit, static_argnames=('w', 'max_iters', 'check_every'))
def keep_marked_runs(px_runs, run_counts, *, w, max_iters=64, check_every=2):
    """Marker reconstruction on runs (binary_propagation semantics).

    A run survives iff its 4-connected mask component contains at least
    one marker pixel (reference track_eval.py:211-214; the encoder splits
    runs at marker transitions, so marker membership is per-run).

    :return: (T, R) bool keep flags
    """
    geo = _prepare(px_runs, run_counts, w=w)
    win = run_windows(geo, dilate=0)
    link = chain_mask(geo, win)
    t, r = geo['rows'].shape
    iota = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :], (t, r))
    init = jnp.where(geo['rmark'], iota, iota + r)
    lab = propagate_min(init, win, link, max_iters=max_iters,
                        check_every=check_every)
    return geo['valid'] & (lab < r)

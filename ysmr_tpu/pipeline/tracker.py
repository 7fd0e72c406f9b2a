#!/usr/bin/env python3
"""Device-resident centroid tracker: a lax.scan over frames of detections.

Replaces the reference's ``CentroidTracker`` (tracker.py:27-230) — an
OrderedDict-of-objects updated per frame in Python — with a padded slot table
updated by pure vectorised ops and scanned over a batch of frames:

* rows of the distance matrix are the active slots in ascending-object-id
  order (the reference's OrderedDict insertion order, tracker.py:144-151);
* matching is the reference's greedy first-come rule (ops/assignment.py);
* if rows >= detections, unmatched rows age (disappeared++, side info
  zeroed, deregistration past max_disappeared — tracker.py:198-211); if
  detections exceed rows, unmatched detections register in ascending column
  order and receive consecutive ids (tracker.py:215-217 — CPython iterates
  the small-int set in ascending order);
* an empty frame ages every object but still runs the GSFF block
  (tracker.py:95-107, 219-227);
* with GSFF enabled the emitted position is ``correct()``'s estimate and the
  stored position for the next frame's distance matrix is ``predict()``'s
  one-step-ahead estimate (tracker.py:219-227); disappeared-but-alive objects
  feed their own prediction back as the measurement.

Emissions are (T, S) padded tables the host compacts into _list.csv rows.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ysmr_tpu.ops import assignment as asg
from ysmr_tpu.ops import gsff as gsff_ops

INT_MAX = np.int32(2 ** 31 - 1)  # numpy, not jnp: keep imports backend-free


class ReferenceOrderRenumberer:
    """Rewrites device-tracker TRACK_IDs into the reference's numbering.

    The reference registers unmatched detections by iterating
    ``set(range(n_det)).difference(used_cols)`` (reference tracker.py:73-91)
    — the slot order of CPython's small-int hash table, which deviates from
    ascending once indices wrap the table. The device scan registers the
    same detections in ascending column order (a fixed, compiler-friendly
    rule) and additionally emits which detection column each slot consumed
    (``det_col``) plus the per-frame detection count (``n_det``). This
    helper replays every frame's registrations through the real CPython set
    machinery at readback and accumulates an id remap — the renumbered ids
    are exact by construction, with zero device-side cost beyond the two
    extra emission columns. Batches must be observed in frame order.

    Scope: the remap makes REGISTRATION order exact. After a permuted
    registration block, the device's distance-matrix row order (ascending
    device id) no longer equals the reference's OrderedDict insertion
    order (ascending renumbered id), so greedy matching can still diverge
    from the reference on EXACT distance ties in later frames — the same
    class of residual as the documented near-tie greedy flips. Id-level
    exactness therefore does not imply match-level exactness; the float64
    host tracker (native/tracker64.cpp) remains the bit-exact path.
    """

    def __init__(self):
        self._remap = np.arange(0, dtype=np.int64)
        self._seen_max = -1

    def _grow(self, n):
        if n > self._remap.shape[0]:
            old = self._remap
            self._remap = np.arange(max(n, 2 * old.shape[0]), dtype=np.int64)
            self._remap[:old.shape[0]] = old

    def observe_batch(self, mask, ids, det_col, n_det, frame_valid):
        """Fold one batch's padded emissions into the remap; returns the
        remapped ids (same shape as ``ids``, entries under ``mask`` valid).
        """
        mask = np.asarray(mask)
        ids = np.asarray(ids)
        det_col = np.asarray(det_col)
        n_det = np.asarray(n_det)
        live_ids = np.where(mask, ids, -1)
        self._grow(int(live_ids.max(initial=-1)) + 1)
        frame_max = live_ids.max(axis=1, initial=-1)
        # only frames that registered something need the set replay
        for t in np.nonzero(frame_valid & (frame_max > self._seen_max))[0]:
            row_live = mask[t]
            row_ids = ids[t][row_live]
            row_cols = det_col[t][row_live]
            # _seen_max moves inside this loop; the nonzero() pre-filter
            # used its entry value, so re-check per frame
            fresh = row_ids > self._seen_max
            if not fresh.any():
                continue
            used_cols = set(
                int(c) for c in row_cols[~fresh] if c >= 0)
            # the real CPython iteration order the reference registers in
            order = list(set(range(int(n_det[t]))).difference(used_cols))
            rank = {d: i for i, d in enumerate(order)}
            new_ids = np.sort(row_ids[fresh])
            # ascending device ids correspond to ascending detection columns
            new_cols = np.sort(row_cols[fresh])
            base = int(new_ids[0])
            for j, d in enumerate(new_cols):
                # rank defaults to j if a column is unexpectedly absent
                # (capacity drops break reference parity anyway)
                self._remap[new_ids[j]] = base + rank.get(int(d), j)
            self._seen_max = int(frame_max[t]) \
                if frame_max[t] > self._seen_max else self._seen_max
        out = self._remap[np.clip(ids, 0, self._remap.shape[0] - 1)]
        return np.where(mask, out, ids).astype(ids.dtype)


def init_tracker_state(max_slots, dims=2, use_gsff=False, gsff_params=None):
    """Fresh tracker state pytree. ``dims`` is 2 or 3 (with luminosity)."""
    state = {
        'active': jnp.zeros((max_slots,), dtype=bool),
        'ids': jnp.zeros((max_slots,), dtype=jnp.int32),
        'pos': jnp.zeros((max_slots, dims), dtype=jnp.float32),
        'info': jnp.zeros((max_slots, 3), dtype=jnp.float32),
        'disappeared': jnp.zeros((max_slots,), dtype=jnp.int32),
        'next_id': jnp.int32(0),
        'dropped_registrations': jnp.int32(0),
    }
    if use_gsff:
        state['gsff'] = gsff_ops.init_state(gsff_params, max_slots)
    return state


def _tracker_frame_update(state, det_xy, det_info, det_valid, *,
                          max_disappeared, use_gsff, gsff_gains, gsff_n_i,
                          gsff_n_f, gsff_n_i0, assign_mesh=None):
    """One frame of CentroidTracker.update semantics over the slot table."""
    active = state['active']
    ids = state['ids']
    pos = state['pos']
    info = state['info']
    disappeared = state['disappeared']
    next_id = state['next_id']
    s = active.shape[0]
    c = det_valid.shape[0]

    n_obj = jnp.sum(active.astype(jnp.int32))
    n_det = jnp.sum(det_valid.astype(jnp.int32))
    has_det = n_det > 0

    # rows = active slots in ascending-id order
    sortkey = jnp.where(active, ids, INT_MAX)
    perm = jnp.argsort(sortkey, stable=True)          # row -> slot
    row_valid = active[perm]
    if assign_mesh is not None:
        # dense-scene path: the slots x detections distance matrix is
        # row-sharded over the mesh; only O(slots) min/argmin summaries
        # cross the interconnect (parallel/sharding.py)
        from ysmr_tpu.parallel.sharding import sharded_greedy_assign
        res = sharded_greedy_assign(assign_mesh, pos[perm], row_valid,
                                    det_xy, det_valid)
    else:
        with jax.named_scope('greedy_assign'):
            d = asg.pairwise_distances(pos[perm], row_valid, det_xy,
                                       det_valid)
            res = asg.greedy_assign(d, row_valid, det_valid)
    slot_to_col = jnp.full((s,), -1, jnp.int32).at[perm].set(res['row_to_col'])
    col_matched = res['col_matched']

    matched = has_det & (slot_to_col >= 0)
    col_idx = jnp.clip(slot_to_col, 0, c - 1)
    pos_new = jnp.where(matched[:, None], det_xy[col_idx], pos)
    info_new = jnp.where(matched[:, None], det_info[col_idx], info)
    dis_new = jnp.where(matched, 0, disappeared)

    # ageing: all active slots when the frame is empty (tracker.py:95-107);
    # unmatched active slots when rows >= cols (tracker.py:198-211)
    age_mask = jnp.where(
        has_det,
        active & ~matched & (n_obj >= n_det),
        active)
    dis_new = dis_new + age_mask.astype(jnp.int32)
    info_new = jnp.where(age_mask[:, None], 0.0, info_new)
    dereg = age_mask & (dis_new.astype(jnp.float32) > max_disappeared)
    active_new = active & ~dereg

    # registration: unmatched detections when cols > rows (tracker.py:215-217)
    # in ASCENDING column order. The reference iterates a CPython set here,
    # whose slot order deviates from ascending once unmatched indices wrap
    # the hash table — the float64 host tracker (native/tracker64.cpp,
    # cpython_set_order) replicates that exactly. This device scan registers
    # in deterministic ascending order and EMITS the per-slot detection
    # column + per-frame detection count, from which the host renumbers the
    # ids into the reference's order at readback (ReferenceOrderRenumberer —
    # it runs the real CPython set machinery, so the order is exact by
    # construction).
    do_register = has_det & (n_det > n_obj)
    unmatched_col = det_valid & ~col_matched & do_register
    col_rank = jnp.cumsum(unmatched_col.astype(jnp.int32)) - 1
    n_new = jnp.sum(unmatched_col.astype(jnp.int32))
    free = ~active_new
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    # col_of_rank[k] = the column holding the k-th registration
    col_of_rank = jnp.zeros((c,), jnp.int32).at[
        jnp.where(unmatched_col, col_rank, c)].set(
            jnp.arange(c, dtype=jnp.int32), mode='drop')
    reg_slot = free & (free_rank < n_new)
    reg_col = col_of_rank[jnp.clip(free_rank, 0, c - 1)]
    n_registered = jnp.sum(reg_slot.astype(jnp.int32))
    dropped = state['dropped_registrations'] + (n_new - n_registered)

    active_new = active_new | reg_slot
    ids_new = jnp.where(reg_slot, next_id + free_rank, ids)
    pos_new = jnp.where(reg_slot[:, None], det_xy[reg_col], pos_new)
    info_new = jnp.where(reg_slot[:, None], det_info[reg_col], info_new)
    dis_new = jnp.where(reg_slot, 0, dis_new)
    next_id_new = next_id + n_new  # reference increments per registration

    new_state = {
        'active': active_new,
        'ids': ids_new,
        'pos': pos_new,
        'info': info_new,
        'disappeared': dis_new,
        'next_id': next_id_new,
        'dropped_registrations': dropped,
    }

    if use_gsff:
        g = state['gsff']
        m = pos_new[:, :2].astype(jnp.float32)
        # a coasting slot (active, unmatched, not newly registered) feeds its
        # own stored prediction back as the measurement (tracker.py:219-227);
        # the stored pos is only the hi half of the double-single prediction,
        # so re-attach the lo half to keep the feedback loop full-precision
        coasting = active_new & ~matched & ~reg_slot
        m_lo = jnp.where(coasting[:, None], g['pred_lo'], 0.0)
        # fresh state for newly-registered slots: previous_measurements is
        # [m] * n_i[0] (gsff.py:279-281); the whole ring is filled with m
        gstate = {
            'buf': jnp.where(reg_slot[:, None, None],
                             jnp.broadcast_to(m[:, None, :], g['buf'].shape),
                             g['buf']),
            'buf_lo': jnp.where(reg_slot[:, None, None], 0.0, g['buf_lo']),
            'len': jnp.where(reg_slot, jnp.int32(gsff_n_i0), g['len']),
            'mode': jnp.where(reg_slot, 0, g['mode']),
            'log_w': jnp.where(reg_slot[:, None], gsff_ops.NEG_INF, g['log_w']),
            'pred_lo': jnp.where(reg_slot[:, None], 0.0, g['pred_lo']),
        }
        gstate, corrected, predicted = gsff_ops._step(
            gsff_gains, gsff_n_i, gsff_n_f, gstate, m, active_new,
            measurements_lo=m_lo)
        emit_pos = jnp.where(active_new[:, None],
                             jnp.concatenate([corrected, pos_new[:, 2:]], axis=1),
                             pos_new)
        stored_pos = jnp.where(active_new[:, None],
                               jnp.concatenate([predicted, pos_new[:, 2:]], axis=1),
                               pos_new)
        new_state['gsff'] = gstate
        new_state['pos'] = stored_pos
    else:
        emit_pos = pos_new

    emission = {
        'mask': active_new,
        'ids': jnp.where(active_new, ids_new, 0),
        'pos': emit_pos,
        'info': info_new,
        # the detection column each live slot consumed this frame (-1 while
        # coasting) and the frame's detection count: together they let the
        # host reconstruct the reference's set-difference registration order
        'det_col': jnp.where(matched, slot_to_col,
                             jnp.where(reg_slot, reg_col, jnp.int32(-1))),
        'n_det': n_det,
    }
    return new_state, emission


@partial(jax.jit,
         static_argnames=('max_disappeared', 'use_gsff', 'gsff_n_f', 'gsff_n_i0',
                          'assign_mesh'))
def run_tracker_scan(state, det_xy, det_info, det_valid, *, max_disappeared,
                     use_gsff=False, gsff_gains=None, gsff_n_i=None, gsff_n_f=3,
                     gsff_n_i0=10, assign_mesh=None):
    """Scan the tracker over a batch of frames.

    :param state: tracker state pytree (carried between batches)
    :param det_xy: (T, C, K) float32 detection positions
    :param det_info: (T, C, 3) float32 (w, h, angle) per detection
    :param det_valid: (T, C) bool
    :return: (new_state, emissions) — emissions are (T, S) padded arrays
    """
    def step(st, frame):
        xy, inf, valid = frame
        return _tracker_frame_update(
            st, xy, inf, valid, max_disappeared=max_disappeared,
            use_gsff=use_gsff, gsff_gains=gsff_gains, gsff_n_i=gsff_n_i,
            gsff_n_f=gsff_n_f, gsff_n_i0=gsff_n_i0, assign_mesh=assign_mesh)

    return jax.lax.scan(step, state, (det_xy, det_info, det_valid))


@partial(jax.jit, static_argnames=('bucket',))
def compact_emissions_device(emissions, n_components, *, bucket):
    """Pack each frame's live slots into ONE (T, bucket+1, 2+K+3) buffer.

    Two wire problems at once. (a) Volume: at dense capacities the padded
    emissions are (T, S) x ~25 bytes/slot — ~6.5 MB per 16-frame batch at
    S=16384 while only ~2-3k slots are live; a stable multi-operand
    ``lax.sort`` on the dead/live key moves live slots to the front in
    slot order (instead of a generic (T, S) scatter).
    (b) Round trips: every host fetch pays the link's latency, so counts,
    ids, pos, info, and the detection counts ride a single
    int32 buffer the host fetches in ONE transfer. The buffer is int32
    with the float payloads bitcast INTO it — not the other way round:
    small ints bitcast to f32 are denormals, and XLA flushes denormals to
    zero in some data-movement ops (measured: ``jnp.stack`` on CPU),
    while every f32 bit pattern is a valid int32 that no int op touches.
    Layout: head ``[:, 0, 0]`` per-frame live count, ``[:, 0, 1]``
    n_components, ``[:, 0, 2]`` per-frame detection count (n_det, for the
    renumberer); payload rows ``[:, 1:, 0]`` ids, ``[:, 1:, 1]`` det_col
    (which detection column the slot consumed this frame, -1 = none),
    ``[:, 1:, 2:2+K]`` position bits, ``[:, 1:, 2+K:5+K]`` (w, h, angle)
    bits. Slots beyond ``bucket`` are
    dropped on device — the caller compares counts against ``bucket`` and
    falls back to the padded arrays for the (rare, once-per-upgrade)
    overflowing batch.
    """
    mask = emissions['mask']
    t = mask.shape[0]
    counts = jnp.sum(mask, axis=1, dtype=jnp.int32)
    key = jnp.where(mask, jnp.int32(0), jnp.int32(1))
    pos = emissions['pos']
    info = emissions['info']
    k = pos.shape[2]
    ops = [key, emissions['ids'], emissions['det_col']]
    ops += [pos[:, :, i] for i in range(k)]
    ops += [info[:, :, i] for i in range(3)]
    sorted_ops = jax.lax.sort(ops, dimension=1, is_stable=True, num_keys=1)
    float_bits = [jax.lax.bitcast_convert_type(o[:, :bucket], jnp.int32)
                  for o in sorted_ops[3:]]
    payload = jnp.stack([sorted_ops[1][:, :bucket],
                         sorted_ops[2][:, :bucket]] + float_bits,
                        axis=-1)  # (T, bucket, 2+K+3) int32
    head = jnp.zeros((t, 1, 5 + k), jnp.int32)
    head = head.at[:, 0, 0].set(counts)
    head = head.at[:, 0, 1].set(n_components.astype(jnp.int32))
    head = head.at[:, 0, 2].set(emissions['n_det'])
    return jnp.concatenate([head, payload], axis=1)

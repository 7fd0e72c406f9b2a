#!/usr/bin/env python3
"""Greedy nearest-neighbour assignment over padded slot tables.

Replicates the reference tracker's association semantics exactly
(tracker.py:151-217):

* ``D = cdist(object_centroids, input_centroids)`` — rows are tracked objects
  in ascending-object-id order, columns are detections in detection order.
* ``rows = D.min(axis=1).argsort()`` (stable on ties in this build),
  ``cols = D.argmin(axis=1)[rows]`` — each row's candidate column is fixed
  *before* matching; a row whose candidate column was already consumed is
  skipped entirely (it is NOT re-matched to its second-nearest detection),
  and there is no maximum-distance gate.
* if rows >= cols: unmatched rows get disappeared++ (and zeroed side info);
  otherwise unmatched columns register new objects.

Although the reference's matcher is written as a sequential first-come loop,
it has no true sequential dependence: a row only ever claims its precomputed
argmin column (skipped rows are never re-matched), so column c is won by the
earliest-ranked row claiming c and everyone else claiming c is skipped. The
whole pass is therefore one rank computation plus one per-column segment-min
— fully parallel on device, no O(R) scan. (A scan-based oracle in the tests
cross-checks this equivalence.)
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BIG = np.float32(3.0e38)  # plain numpy: a module-level jnp constant
# would initialise the XLA backend at import time (breaking
# jax.distributed.initialize, which must run before any backend use)


def pairwise_distances(obj_xy, obj_valid, det_xy, det_valid):
    """Euclidean distance matrix with invalid rows/cols pushed to +BIG.

    :param obj_xy: (R, K) float32 tracked positions (K = 2 or 3 with luminosity)
    :param det_xy: (C, K) float32 detections
    :return: (R, C) float32
    """
    diff = obj_xy[:, None, :] - det_xy[None, :, :]
    d = jnp.sqrt(jnp.sum(diff * diff, axis=-1))
    valid = obj_valid[:, None] & det_valid[None, :]
    return jnp.where(valid, d, BIG)


@partial(jax.jit, static_argnames=())
def greedy_assign(distance_matrix, obj_valid, det_valid):
    """Reference-exact greedy matching.

    :param distance_matrix: (R, C) float32 with BIG at invalid entries
    :param obj_valid: (R,) bool — active track slots (rows)
    :param det_valid: (C,) bool — valid detections (columns)
    :return: dict with
        ``row_to_col``: (R,) int32, matched column per row or -1
        ``col_matched``: (C,) bool
    """
    row_min = jnp.min(distance_matrix, axis=1)
    cand_col = jnp.argmin(distance_matrix, axis=1).astype(jnp.int32)
    return greedy_assign_from_candidates(row_min, cand_col, obj_valid,
                                         det_valid)


def greedy_assign_from_candidates(row_min, cand_col, obj_valid, det_valid):
    """Greedy matching from per-row (min distance, argmin column) — the
    only projections of the distance matrix the matcher consumes (the
    row-sharded matcher computes them per shard, parallel/sharding.py)."""
    r = row_min.shape[0]
    c = det_valid.shape[0]
    row_min = jnp.where(obj_valid, row_min, BIG)
    # rank = position in the stable sort by row minimum (ties keep row order,
    # matching the ascending-object-id row layout of the reference)
    order = jnp.argsort(row_min, stable=True)
    rank = jnp.zeros((r,), dtype=jnp.int32).at[order].set(
        jnp.arange(r, dtype=jnp.int32))
    claim_ok = obj_valid & det_valid[cand_col]
    seg = jnp.where(claim_ok, cand_col, c)  # invalid claims -> overflow bucket
    winner_rank = jax.ops.segment_min(jnp.where(claim_ok, rank, r), seg,
                                      num_segments=c + 1)
    matched = claim_ok & (rank == winner_rank[cand_col])
    row_to_col = jnp.where(matched, cand_col, -1)
    col_matched = jax.ops.segment_max(
        matched.astype(jnp.int32), seg, num_segments=c + 1)[:c] > 0
    return {'row_to_col': row_to_col, 'col_matched': col_matched}

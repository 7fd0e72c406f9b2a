#!/usr/bin/env python3
"""Device-mesh parallelism for the tracking pipeline.

The reference's only parallelism is a process pool with one worker per video
(main.py:281-313). The device-mesh equivalents (SURVEY.md section 2.2):

* **Video-batch data parallelism** — a batch of videos sharded over the
  ``videos`` mesh axis with ``shard_map``; each device runs the full fused
  detect + tracker scan on its own videos. Per-video independence means no
  collectives on the hot path; results gather at the end of a batch.
* **Dense-scene assignment sharding** — for scenes whose R x C distance
  matrix dwarfs one device (BASELINE config 5: 10k+ objects), rows of the
  matrix are sharded over the mesh: each device computes the distance block
  for its row shard and reduces it to per-row (min, argmin); those O(R)
  vectors are all-gathered and the greedy winner resolution —
  O(R + C) — runs replicated. The O(R*C*K) compute and memory are fully
  sharded; only O(R) crosses the interconnect.
"""

import os

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ysmr_tpu.ops import assignment as asg


_DISTRIBUTED = False


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Join a multi-process (multi-controller) JAX cluster.

    The multi-host counterpart of the single-process mesh (SURVEY.md section
    5, "Distributed communication backend"): every host process calls this
    before any device use, the coordinator wires the processes together,
    and ``jax.devices()`` then lists the GLOBAL device set — ``make_mesh``
    meshes over it unchanged, with the host network carrying the
    cross-process axis.

    Parameters default to the ``YSMR_DIST_COORDINATOR`` (host:port),
    ``YSMR_DIST_NPROCS`` and ``YSMR_DIST_PROCESS_ID`` environment
    variables, so launchers can opt whole process trees in without code
    changes. No-ops (returns False) when no coordinator is configured;
    idempotent once joined.

    :return: True when distributed mode is active
    """
    global _DISTRIBUTED
    if _DISTRIBUTED:
        return True
    coordinator = coordinator or os.environ.get('YSMR_DIST_COORDINATOR')
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ['YSMR_DIST_NPROCS'])
    if process_id is None:
        process_id = int(os.environ['YSMR_DIST_PROCESS_ID'])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=int(num_processes),
                               process_id=int(process_id))
    _DISTRIBUTED = True
    return True


def make_mesh(n_devices=None, axis='videos', platform=None, hosts=None):
    """A device mesh over the first ``n_devices`` devices.

    With ``hosts=None`` this is the 1-axis single-host mesh (the devices
    of one host reach each other all to all). With ``hosts=H`` the same
    devices are laid out as a 2-axis ``(hosts, devices)`` mesh — the
    multi-host shape: the leading axis maps to host groups (devices of one
    process stay contiguous in ``jax.devices()`` order, so each row is one
    host's devices and the slower host network only ever carries the hosts
    axis). The video batch shards over the FLATTENED product of all axes
    (:func:`video_pspec`), so per-video work needs no cross-host
    collectives at all; only the dense-scene assignment reduces over the
    mesh, and its O(R) row summaries are the only cross-host traffic.

    Multi-process runs initialise ``jax.distributed`` first and build this
    mesh from the global device list (single-controller JAX); on one
    process the hosts axis simply partitions the local devices and is
    exercised by the virtual-device tests.

    :param platform: optional backend to draw devices from (e.g. 'cpu' for
        the virtual-device dry run in a process whose default backend is
        an accelerator)
    :param hosts: optional host-group count; must divide the device count
    """
    init_distributed()  # joins a configured multi-process cluster (no-op
    # otherwise), so the device list below is the global one
    devices = jax.devices(platform) if platform else jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError('Requested a %d-device mesh but the %s backend '
                             'has only %d devices' %
                             (n_devices, platform or 'default', len(devices)))
        devices = devices[:n_devices]
    import numpy as np
    if hosts is None:
        return Mesh(np.array(devices), (axis,))
    if len(devices) % hosts:
        raise ValueError('%d devices do not split over %d host groups' %
                         (len(devices), hosts))
    arr = np.array(devices).reshape(hosts, -1)
    return Mesh(arr, ('hosts', axis))


def video_pspec(mesh, ndim=1):
    """PartitionSpec sharding the leading (video) dim over EVERY mesh axis."""
    return P(tuple(mesh.axis_names), *([None] * (ndim - 1)))


def shard_videos(mesh, frames):
    """Place a (V, ...) video-major array sharded over the video axes."""
    return jax.device_put(frames,
                          NamedSharding(mesh, video_pspec(mesh, frames.ndim)))


def make_multi_video_step(mesh, *, detect_kwargs, tracker_kwargs,
                          emit_counts=False):
    """Build the jitted sharded detect+track step for a batch of videos.

    The returned callable maps ``(frames (V, T, H, W, 3) uint8,
    frame_valid (V, T) bool, tracker_state with leading dim V)`` to
    ``(new_tracker_state, emissions)`` — all (V, ...) sharded over the
    ``videos`` axis. Build it ONCE per run and call it per frame batch:
    the tracker state threads through, so a long video is scanned in
    batches under the mesh without recompilation.

    :param emit_counts: also return the per-frame component counts
        (V, T) so the host can warn about detection-table overflow
    """
    from ysmr_tpu.ops import preprocess as pp
    from ysmr_tpu.pipeline import detect as det
    from ysmr_tpu.pipeline import tracker as trk

    def per_video(video_frames, video_valid, state):
        gray = pp.bgr_to_gray(video_frames)
        blurred = pp.blur3(gray)
        thresholds = jnp.zeros((video_frames.shape[0],), jnp.int32)
        tables = det.detect_from_blurred(gray, blurred, video_valid, thresholds,
                                         **detect_kwargs)
        new_state, emissions = trk.run_tracker_scan(
            state, tables['det_xy'], tables['det_info'], tables['det_valid'],
            **tracker_kwargs)
        if emit_counts:
            emissions = dict(emissions, n_components=tables['n_components'])
        return new_state, emissions

    def sharded(video_frames, video_valid, state):
        # each device owns V/n videos; vmap over its local shard
        return jax.vmap(per_video)(video_frames, video_valid, state)

    vspec = video_pspec(mesh)
    fn = shard_map(sharded, mesh=mesh,
                   in_specs=(vspec, vspec, vspec),
                   out_specs=(vspec, vspec), check_vma=False)
    return jax.jit(fn)


def multi_video_detect_track(mesh, frames, frame_valid, *, detect_kwargs,
                             tracker_state, tracker_kwargs):
    """One sharded detect+track step (see :func:`make_multi_video_step`).

    Convenience wrapper for single-shot callers; loops should build the
    step once with ``make_multi_video_step`` and reuse it.
    """
    fn = make_multi_video_step(mesh, detect_kwargs=detect_kwargs,
                               tracker_kwargs=tracker_kwargs)
    return fn(frames, frame_valid, tracker_state)


def sharded_greedy_assign(mesh, obj_xy, obj_valid, det_xy, det_valid):
    """Reference-exact greedy assignment with the distance matrix row-sharded.

    Equivalent to ``ops.assignment.greedy_assign`` on the full matrix
    (tests verify against the single-device path) but computes the R x C
    distances in row shards across the mesh.

    :param obj_xy: (R, K) float32, R divisible by mesh size
    :param det_xy: (C, K) float32, replicated
    :return: same contract as greedy_assign
    """
    def local2(obj_xy_l, obj_valid_l, det_xy_r, det_valid_r):
        # the (R/n, C) distance block is an elementwise producer of the two
        # row reductions; XLA fuses it, so no block reaches device memory
        d = asg.pairwise_distances(obj_xy_l, obj_valid_l, det_xy_r, det_valid_r)
        row_min = jnp.min(d, axis=1)
        cand_col = jnp.argmin(d, axis=1).astype(jnp.int32)
        return row_min, cand_col

    vspec = video_pspec(mesh)
    fn = shard_map(local2, mesh=mesh,
                   in_specs=(vspec, vspec, P(), P()),
                   out_specs=(vspec, vspec), check_vma=False)
    row_min, cand_col = fn(obj_xy, obj_valid, det_xy, det_valid)
    # winner resolution on the gathered O(R) vectors (replicated, cheap);
    # shared with the single-device matcher so the two paths cannot diverge
    return asg.greedy_assign_from_candidates(row_min, cand_col, obj_valid,
                                             det_valid)

#!/usr/bin/env python3
"""Detection from compact foreground-pixel tables (bandwidth-adaptive mode).

When the host-to-device link is slow, streaming raw frames caps throughput
far below one device's compute. In
"pixels" transfer mode the host decode thread runs the threshold recipes
(bit-exact with the device kernels — both are verified against OpenCV) and
ships only the foreground pixels (~2-4 bytes/pixel, typically hundreds of KB/s
instead of ~100 MB/s). The device then rasterizes, labels, reconstructs
markers, computes rotated extents, and tracks — identical results to the
frames path (tests/test_detect_pixels.py asserts equality).

All segment reductions run over the compact (T, F) tables instead of the
(T, H*W) pixel grid, which also removes the large-scatter hot spots of the
image path.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ysmr_tpu.ops import labeling as lb

#: rasterize the mask/marker image from run boundary deltas + cumsum
#: instead of the per-pixel scatter (benchmark knob; see
#: rasterize_values_runs for the measured trade-off)
_RUNS_DELTA_RASTER = True


@partial(jax.jit, static_argnames=('h', 'w', 'double_threshold', 'max_det',
                                   'max_bh', 'cc_iters', 'include_luminosity',
                                   'lum_win', 'sort_compact', 'use_table',
                                   'return_det_px', 'skip_rect',
                                   'expanded_f', 'use_run_cc',
                                   'det_px_as_runs', 'cv2_centers'))
def detect_from_pixels(px_x, px_y, px_counts, px_marker, frame_valid, *, h, w,
                       double_threshold, max_det, max_bh, cc_iters,
                       include_luminosity=False, px_gray=None, lum_win=48,
                       gray_frames=None, sort_compact=False, use_table=False,
                       px_packed=None, return_det_px=False, skip_rect=False,
                       px_runs=None, run_counts=None, expanded_f=None,
                       use_run_cc=False, det_px_as_runs=False,
                       cv2_centers=False):
    """Detection tables from per-frame foreground pixel lists.

    Inputs arrive in the host's compact wire format (int16 coordinates,
    uint8 markers, per-frame counts) and are widened on device — over a slow
    host-device link the transfer size is the throughput bound.

    :param px_x, px_y: (T, F) int16/int32 pixel coordinates (raster order);
        may be None when ``px_packed`` is given
    :param px_counts: (T,) int32 number of valid pixels per frame
    :param px_marker: (T, F) bool/uint8 — stricter-threshold membership;
        may be None when ``px_packed`` is given
    :param frame_valid: (T,) bool
    :param px_gray: optional (T, F) int grayscale at the pixels — the
        component-pixel-mean luminosity fallback when no full frames are
        available
    :param gray_frames: optional (T, H, W) uint8 full grayscale frames;
        when given with ``include_luminosity``, the ILLUMINATION value is
        the reference-exact filled-rotated-rect mean (ops/luminosity.py)
    :param px_packed: optional (T, F) uint32 packed wire format
        (bits 0..30 = y*w + x, bit 31 = marker) replacing px_x/px_y/px_marker
        — 20 % less host-device traffic
    :param px_runs: optional (T, R) uint32 run-length wire (bits 0..25 =
        start y*w+x, bit 26 = marker, bits 27..31 = length 1..31; native
        encode_runs_batch). Raster-order blobs are horizontal runs, so
        this cuts host->device traffic a further ~4-5x at dense scale; the
        device expands it to the identical (T, F) pixel table with a
        start-offset scatter + cummax scan. Requires ``run_counts`` (T,)
        and the static ``expanded_f`` (= the pixel-table width F)
    :param return_det_px: also return ``det_px_idx`` (T, F) int16 — the
        detection index of every WIRE-ORDER input pixel (-1 = background /
        dropped / beyond max_det). Feeds the host-side cv2-bit-exact rect
        measurement (native cv2_rects_batch).
    :param det_px_as_runs: with ``return_det_px`` + ``skip_rect`` on the
        run-CC path, return ``det_run_idx`` (T, R) int16 — the detection
        index PER RUN — instead of the (T, F) per-pixel table. Exact by
        construction (a run is horizontally connected, so it has one
        component); cuts the host-rect readback ~5x and skips the device
        run->pixel expansion.
    :param sort_compact: compact components with one (label, lin) sort and
        build the stats row tables with segmented scans, reconstructing
        markers by bit-packed binary propagation (instead of the
        scatter/gather compaction and a 4-connected labeling pass);
        identical output, chosen per backend by
        track_bacteria.device_path_flags
    :param skip_rect: skip the device hull/caliper rectangle entirely
        (det_xy/det_info return zeros); used when the host computes the
        cv2-exact rects so the device only labels and counts. Ignored when
        the exact rotated-rect luminosity needs the device rect.
    :return: dict with det_xy (T, D, K), det_info (T, D, 3), det_valid (T, D),
        n_components (T,) [, det_px_idx (T, F)]
    """
    n = h * w
    if px_runs is not None and use_run_cc and not include_luminosity:
        # run-graph CC: labeling + marker reconstruction directly on the
        # (T, R) run tables (ops/run_cc.py) — no whole-frame raster, no
        # stencil passes, no (T, F) label sort. Pixel tables materialize
        # only where a consumer needs them (det_px expansion / stats path).
        from ysmr_tpu.ops import run_cc as rcc
        f = expanded_f
        rc_eff = jnp.where(frame_valid, run_counts.astype(jnp.int32), 0)
        cc_out = rcc.run_cc_components(px_runs, rc_eff, w=w,
                                       double_threshold=double_threshold,
                                       max_iters=cc_iters)
        n_components = cc_out['n_components']
        det_px = det_run = None
        if return_det_px:
            comp_rev_run = jnp.where(
                cc_out['run_comp'] >= 0,
                n_components[:, None] - 1 - cc_out['run_comp'], -1)
            if det_px_as_runs:
                # a run is horizontally contiguous foreground, so every
                # pixel of a run belongs to ONE component: the per-RUN det
                # index carries the full per-pixel assignment at ~1/5 the
                # bytes (the host expands against the run table it already
                # holds from the wire encode) and skips the on-device
                # (T, F) scatter+cummax expansion entirely
                det_run = jnp.where(comp_rev_run < max_det, comp_rev_run,
                                    -1).astype(jnp.int16)
            else:
                det_px = rcc.det_px_from_runs(px_runs, rc_eff, comp_rev_run,
                                              f=f, max_det=max_det)
        if skip_rect:
            t = px_runs.shape[0]
            det_valid = jnp.arange(max_det, dtype=jnp.int32)[None, :] < \
                jnp.minimum(n_components, max_det)[:, None]
            out = {'det_xy': jnp.zeros((t, max_det, 2), jnp.float32),
                   'det_info': jnp.zeros((t, max_det, 3), jnp.float32),
                   'det_valid': det_valid, 'n_components': n_components}
            if det_run is not None:
                out['det_run_idx'] = det_run
            elif return_det_px:
                out['det_px_idx'] = det_px.astype(jnp.int16)
            return out
        # stats/rect tables straight from the component-sorted RUN tables —
        # no run->pixel expansion and no F-length scans on the hot path
        # (see labeling.component_stats_runs)
        comp_rev_s = jnp.where(
            cc_out['s_comp'] >= 0,
            n_components[:, None] - 1 - cc_out['s_comp'], -1)
        return _stats_outputs_runs(
            cc_out['s_start'], cc_out['s_len'], comp_rev_s,
            n_components, det_px,
            h=h, w=w, max_det=max_det, max_bh=max_bh,
            cv2_centers=cv2_centers)
    if px_runs is not None:
        # expand the run wire to the (T, F) pixel table. The linear index
        # needs NO per-pixel gather: within a run lin increments by one,
        # and at each run start it jumps by (start_i - prev_end + 1), so
        # one 2-per-run scatter of jump deltas + a cumsum over the slot
        # axis reconstructs lin exactly (one scatter and one scan, no
        # full-length gather). Pixels come out in the encoder's input (raster)
        # order, so downstream semantics — and the wire-order det_px_idx
        # contract — are identical to the pixel wire.
        t, r = px_runs.shape
        f = expanded_f
        runs = px_runs.astype(jnp.uint32)
        starts = (runs & jnp.uint32(0x03FFFFFF)).astype(jnp.int32)
        rmark = ((runs >> 26) & jnp.uint32(1)) > 0
        lens = (runs >> 27).astype(jnp.int32)
        rvalid = jnp.arange(r, dtype=jnp.int32)[None, :] < run_counts[:, None]
        lens = jnp.where(rvalid, lens, 0)
        ends = jnp.cumsum(lens, axis=1)
        offs = ends - lens
        t_off_f = jnp.arange(t, dtype=jnp.int32)[:, None] * f
        oob_r = (jnp.int32(t * f) +
                 jnp.arange(t * r, dtype=jnp.int32).reshape(t, r))
        run_ok = lens > 0
        flat_idx = jnp.where(run_ok & (offs < f), offs + t_off_f, oob_r)
        prev_end = jnp.concatenate(
            [jnp.ones((t, 1), jnp.int32),
             (starts + lens)[:, :-1]], axis=1)
        jumps = starts - prev_end + 1
        d_flat = jnp.ones((t * f,), jnp.int32).at[flat_idx.reshape(-1)].add(
            (jumps - 1).reshape(-1), mode='drop', unique_indices=True)
        lin_raw = jnp.cumsum(d_flat.reshape(t, f), axis=1)
        px_x = lin_raw % w
        px_y = lin_raw // w
        runs_data = (starts, lens, rmark) if _RUNS_DELTA_RASTER else None

        def _marker_from_runs():
            # per-pixel marker, only for the paths that consume it (the
            # delta-rasterized image already encodes it): run id per slot
            # via start-offset scatter + cummax, then one gather
            rid_flat = jnp.zeros((t * f,), jnp.int32).at[
                flat_idx.reshape(-1)].set(
                jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :],
                                 (t, r)).reshape(-1),
                mode='drop', unique_indices=True)
            rid = jax.lax.cummax(rid_flat.reshape(t, f), axis=1)
            return jnp.take_along_axis(rmark, rid, axis=1)

        _sorted_path = sort_compact and not use_table
        _marker_needed = double_threshold and not (
            _sorted_path and runs_data is not None)
        px_marker = _marker_from_runs() if _marker_needed \
            else jnp.zeros((t, f), bool)
    elif px_packed is not None:
        t, f = px_packed.shape
        packed = px_packed.astype(jnp.uint32)
        lin_raw = (packed & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        px_marker = (packed >> 31) > 0
        px_x = lin_raw % w
        px_y = lin_raw // w
    else:
        t, f = px_x.shape
        px_x = px_x.astype(jnp.int32)
        px_y = px_y.astype(jnp.int32)
        px_marker = px_marker.astype(jnp.int32) > 0
        lin_raw = px_y * w + px_x
    if px_runs is None:
        runs_data = None
    px_valid = jnp.arange(f, dtype=jnp.int32)[None, :] < px_counts[:, None]
    valid = px_valid & frame_valid[:, None]
    lin = jnp.where(valid, lin_raw, n)

    t_off = jnp.arange(t, dtype=jnp.int32)[:, None] * (n + 1)
    # out-of-range (dropped) yet unique indices for invalid entries, so the
    # scatters can carry unique_indices=True (vastly cheaper lowering)
    oob = (jnp.int32(t * (n + 1)) +
           jnp.arange(t * f, dtype=jnp.int32).reshape(t, f))

    def rasterize_all(lin_b):
        """(T, F) linear indices -> (T, H, W) masks via one flat scatter."""
        idx = jnp.where(lin_b < n, lin_b + t_off, oob)
        flat = jnp.zeros((t * (n + 1),), bool).at[idx.reshape(-1)].set(
            True, mode='drop', unique_indices=True)
        return flat.reshape(t, n + 1)[:, :n].reshape(t, h, w)

    def rasterize_values(lin_b, val):
        """(T, F) linear indices + int8 values -> (T, H, W) image, one flat
        scatter: the mask and marker rasterizations share one valued
        scatter instead of two."""
        idx = jnp.where(lin_b < n, lin_b + t_off, oob)
        flat = jnp.zeros((t * (n + 1),), jnp.int8).at[idx.reshape(-1)].set(
            val.reshape(-1), mode='drop', unique_indices=True)
        return flat.reshape(t, n + 1)[:, :n].reshape(t, h, w)

    def rasterize_values_runs():
        """(T, H, W) valued image from the run wire via boundary deltas:
        +v at each run start, -v one past its end, then an int8 cumsum
        along the flat raster axis. ~2 scattered updates per RUN instead
        of one per PIXEL — the per-pixel scatter is the single largest
        labels-stage cost at dense scale (runs are disjoint and cannot
        cross the per-frame n+1 boundary, so partial sums stay exact)."""
        starts_r, lens_r, rmark_r = runs_data
        lens_e = jnp.where(frame_valid[:, None], lens_r, 0)
        rr = starts_r.shape[1]
        t_off_r = jnp.arange(t, dtype=jnp.int32)[:, None] * (n + 1)
        vals = jnp.where(rmark_r, jnp.int8(2), jnp.int8(1))
        ok = lens_e > 0
        oob0 = (jnp.int32(t * (n + 1)) +
                jnp.arange(t * rr, dtype=jnp.int32).reshape(t, rr))
        idx0 = jnp.where(ok, starts_r + t_off_r, oob0)
        idx1 = jnp.where(ok, starts_r + lens_e + t_off_r, oob0)
        flat = jnp.zeros((t * (n + 1),), jnp.int8)
        flat = flat.at[idx0.reshape(-1)].add(vals.reshape(-1), mode='drop',
                                             unique_indices=True)
        flat = flat.at[idx1.reshape(-1)].add((-vals).reshape(-1),
                                             mode='drop', unique_indices=True)
        img = jnp.cumsum(flat.reshape(t, n + 1), axis=1, dtype=jnp.int8)
        return img[:, :n].reshape(t, h, w)

    def gather_all(img_b, lin_b):
        """(T, H, W) images gathered at (T, F) linear indices, one flat op."""
        flat = img_b.reshape(-1)
        idx = jnp.clip(lin_b, 0, n - 1) + jnp.arange(t, dtype=jnp.int32)[:, None] * n
        return flat[idx.reshape(-1)].reshape(t, f)

    def compact_ids(lab_fg, act, lin_b, reverse):
        """Dense component ids at the foreground pixels (raster-rank based);
        batched over frames with flat scatters/gathers."""
        roots = act & (lab_fg == lin_b)
        rank = jnp.cumsum(roots.astype(jnp.int32), axis=1) - 1
        n_comp = jnp.sum(roots.astype(jnp.int32), axis=1)  # (T,)
        idx = jnp.where(roots, lin_b + t_off, oob)
        rank_img = jnp.zeros((t * (n + 1),), jnp.int32).at[
            idx.reshape(-1)].set(rank.reshape(-1), mode='drop',
                                 unique_indices=True)
        comp = rank_img[(jnp.clip(lab_fg, 0, n) + t_off).reshape(-1)].reshape(t, f)
        if reverse:
            comp = n_comp[:, None] - 1 - comp
        return jnp.where(act, comp, f), n_comp

    def cc(m, conn):
        return jax.vmap(lambda a: lb.label_components(
            a, connectivity=conn, max_iters=cc_iters, jump_every=0))(m)

    valid_b = valid
    if use_table:
        # fully sparse path: CC + compaction on the (T, F) tables directly —
        # no whole-frame arrays anywhere (O(F log F) instead of O(H*W*iters))
        lin_t = jnp.where(valid_b, lin, jnp.int32(2 ** 30))
        cc_t = partial(lb.label_components_table, w=w, max_iters=cc_iters)
        if double_threshold:
            lab4 = jax.vmap(partial(cc_t, connectivity=4))(lin_t, valid_b)
            comp4, _ = jax.vmap(
                partial(lb.compact_labels_table, reverse=False))(
                    lab4, valid_b, lin_t)
            marked = jax.vmap(lambda mk, c: jax.ops.segment_max(
                mk.astype(jnp.int32), jnp.minimum(c, f), num_segments=f + 1))(
                    px_marker & valid_b, comp4)
            keep = valid_b & (jnp.take_along_axis(
                marked, jnp.minimum(comp4, f), axis=1) > 0)
        else:
            keep = valid_b
        lin_kept = jnp.where(keep, lin, jnp.int32(2 ** 30))
        lab8 = jax.vmap(partial(cc_t, connectivity=8))(lin_kept, keep)
        comp, n_components = jax.vmap(
            partial(lb.compact_labels_table, reverse=True))(
                lab8, keep, lin_kept)
        comp = jnp.where(keep, comp, f)
    elif sort_compact:
        # sorted-run compaction: one (label, lin) sort replaces the
        # full-image compact scatters/gathers with cheap vector scans —
        # pixels sorted by label form contiguous per-component runs in
        # root-raster order, which is exactly the compaction order of
        # compact_ids
        gray0 = px_gray.astype(jnp.int32) if px_gray is not None \
            else jnp.zeros_like(px_x)
        iota_f = jnp.arange(f, dtype=jnp.int32)[None, :]
        if double_threshold:
            # marker reconstruction as BIT-PACKED binary propagation
            # (32 frames per uint32 plane, labeling.binary_reconstruct)
            # — replaces an entire min-label labeling phase plus a
            # 4-operand sort. One valued scatter rasterizes mask AND marker
            # (marker pixels are a subset of the mask by construction), and
            # the reconstruct output IS the kept-pixel image — every kept
            # pixel is a listed mask pixel — so it feeds the 8-connectivity
            # labeling directly with no re-rasterization. Dropped pixels
            # read the background label (h*w) from the label image, so the
            # keep flags come for free from the label gather.
            if runs_data is not None:
                img = rasterize_values_runs()
            else:
                val = jnp.where(px_marker & valid_b, jnp.int8(2), jnp.int8(1))
                img = rasterize_values(lin, val)
            keep_img = lb.binary_reconstruct(img > 0, img > 1,
                                             max_iters=cc_iters)
            lab8 = cc(keep_img, 8)
        else:
            lab8 = cc(rasterize_values_runs() > 0 if runs_data is not None
                      else rasterize_all(lin), 8)
        lab8_fg = jnp.where(valid_b, gather_all(lab8, lin), n)
        lin_kept = jnp.where(lab8_fg < n, lin, n)
        slab8, slin8, sgray8 = jax.lax.sort((lab8_fg, lin_kept, gray0),
                                            dimension=1, num_keys=2)
        keep = slab8 < n
        new_run = keep & ((iota_f == 0) |
                          (slab8 != jnp.roll(slab8, 1, axis=1)))
        n_components = jnp.sum(new_run.astype(jnp.int32), axis=1)
        comp_asc = jnp.cumsum(new_run.astype(jnp.int32), axis=1) - 1
        comp = jnp.where(keep, n_components[:, None] - 1 - comp_asc, f)
        px_x = slin8 % w
        px_y = slin8 // w
        gray_in = sgray8
        seg = jnp.where(keep, jnp.minimum(comp, max_det), max_det)
        if return_det_px:
            # map labels -> det ids at the run roots, then read the map at
            # every wire-order pixel's label (the sort destroyed wire order)
            root_idx = jnp.where(new_run, slab8 + t_off, oob)
            det_map = jnp.full((t * (n + 1),), -1, jnp.int32).at[
                root_idx.reshape(-1)].set(comp.reshape(-1), mode='drop',
                                          unique_indices=True)
            g = det_map[(lab8_fg + t_off).reshape(-1)].reshape(t, f)
            det_px = jnp.where((g >= 0) & (g < max_det), g, -1)
    else:
        mask = rasterize_values_runs() > 0 if runs_data is not None \
            else rasterize_all(lin)
        if double_threshold:
            lab4 = cc(mask, 4)
            lab4_fg = gather_all(lab4, lin)
            comp4, _ = compact_ids(lab4_fg, valid_b, lin, reverse=False)
            marked = jax.vmap(lambda mk, c: jax.ops.segment_max(
                mk.astype(jnp.int32), jnp.minimum(c, f), num_segments=f + 1))(
                    px_marker & valid_b, comp4)
            keep = valid_b & (jnp.take_along_axis(
                marked, jnp.minimum(comp4, f), axis=1) > 0)
            lin_kept = jnp.where(keep, lin, n)
            mask = rasterize_all(lin_kept)
        else:
            keep = valid_b
            lin_kept = lin
        lab8 = cc(mask, 8)
        lab8_fg = gather_all(lab8, lin_kept)
        comp, n_components = compact_ids(lab8_fg, keep, lin_kept, reverse=True)
    if use_table or not sort_compact:
        seg = jnp.where(keep, jnp.minimum(comp, max_det), max_det)
        gray_in = px_gray.astype(jnp.int32) if px_gray is not None \
            else jnp.zeros_like(px_x)
        if return_det_px:
            # comp is already in wire order on these paths
            det_px = jnp.where(keep & (comp < max_det), comp, -1)

    exact_lum = include_luminosity and gray_frames is not None

    if skip_rect and not exact_lum:
        # host computes the cv2-bit-exact rects from the wire pixels +
        # det_px_idx (native cv2_rects_batch); the device only labels. The
        # compacted ids are dense 0..n_components-1, so slot validity is a
        # simple iota compare — identical to the count>0 rule of the stats
        # path.
        det_valid = jnp.arange(max_det, dtype=jnp.int32)[None, :] < \
            jnp.minimum(n_components, max_det)[:, None]
        if include_luminosity:
            # component-pixel-mean luminosity via plain segment sums — no
            # hull/caliper work (the rects come from the host)
            def lum_frame(seg_f, keep_f, gray_f):
                cnt = jax.ops.segment_sum(keep_f.astype(jnp.int32), seg_f,
                                          num_segments=max_det + 1)[:max_det]
                s = jax.ops.segment_sum(
                    jnp.where(keep_f, gray_f, 0), seg_f,
                    num_segments=max_det + 1)[:max_det]
                return s.astype(jnp.float32) / jnp.maximum(cnt, 1) / 100.0
            lum = jax.vmap(lum_frame)(seg, keep, gray_in)
            det_xy = jnp.stack(
                [jnp.zeros_like(lum), jnp.zeros_like(lum), lum], axis=-1)
            det_xy = jnp.where(det_valid[..., None], det_xy, 0.0)
        else:
            det_xy = jnp.zeros((t, max_det, 2), jnp.float32)
        out = {'det_xy': det_xy,
               'det_info': jnp.zeros((t, max_det, 3), jnp.float32),
               'det_valid': det_valid, 'n_components': n_components}
        if return_det_px:
            out['det_px_idx'] = det_px.astype(jnp.int16)
        return out

    # the sorted-compaction path orders pixels by (component id, linear
    # index) — component_stats can then build its row tables with segmented
    # scans + one packed scatter instead of combiner-scatter segment
    # reductions (bit-identical)
    stats_sorted = bool(sort_compact and not use_table)
    return _stats_outputs(
        seg, keep, px_x, px_y, gray_in,
        gray_frames if exact_lum else None, n_components,
        det_px if return_det_px else None,
        h=h, w=w, max_det=max_det, max_bh=max_bh,
        include_luminosity=include_luminosity, exact_lum=exact_lum,
        lum_win=lum_win, stats_sorted=stats_sorted,
        cv2_centers=cv2_centers)




_CV2_TABLE_KEYS = ('row_min_x', 'row_max_x', 'row_valid', 'min_y',
                   'corner_l', 'corner_r')


def _cv2_center_override(rect, tables, *, max_bh):
    """Replace rect centers with the bit-exact cv2 caliper centers
    (ops/cv2_centers.py) where derivable; exact centers elsewhere.

    Called ONCE PER BATCH on (T, D, ...) tables with components flattened
    into the leading axis — per-frame invocations under vmap were
    latency-bound (dozens of small kernels per frame)."""
    from ysmr_tpu.ops import labeling as _lb
    from ysmr_tpu.ops.cv2_centers import (cv2_centers_from_tables,
                                          inv_sqrt_table)
    isq = inv_sqrt_table(_lb._CV2_CENTER_MAX_EDGE_W, max_bh)
    t, dd = rect['cx'].shape
    flat = {kk: tables[kk].reshape((t * dd,) + tables[kk].shape[2:])
            for kk in _CV2_TABLE_KEYS}
    ccx, ccy, cok = cv2_centers_from_tables(
        flat['row_min_x'], flat['row_max_x'], flat['row_valid'],
        flat['min_y'], flat['corner_l'], flat['corner_r'],
        isq, max_bh=max_bh)
    ccx = ccx.reshape(t, dd)
    ccy = ccy.reshape(t, dd)
    cok = cok.reshape(t, dd)
    return dict(rect,
                cx=jnp.where(cok, ccx, rect['cx']),
                cy=jnp.where(cok, ccy, rect['cy']))


def _stats_outputs_runs(s_start, s_len, s_comp, n_components, det_px, *,
                        h, w, max_det, max_bh, cv2_centers=False):
    """Detect tail over component-sorted run tables (no luminosity).

    Same output contract as _stats_outputs; consumes (T, R) run geometry
    directly (labeling.component_stats_runs).
    """
    def per_frame(ss, sl, sc):
        tables = lb.component_stats_runs(
            ss, sl, sc, w=w, h=h, max_det=max_det, max_bh=max_bh,
            cv2_centers=cv2_centers)
        rect = lb.min_area_rect(tables['points'], tables['points_valid'],
                                edge_angles=tables['edge_angles'],
                                edge_valid=tables['edge_valid'],
                                edge_dx=tables['edge_dx'],
                                edge_dy=tables['edge_dy'])
        cv2_tabs = {kk: tables[kk] for kk in _CV2_TABLE_KEYS} \
            if cv2_centers else {}
        return rect, tables['count'] > 0, cv2_tabs

    rect, det_valid, cv2_tabs = jax.vmap(per_frame)(s_start, s_len, s_comp)
    if cv2_centers:
        # the tracker's measurement stream becomes cv2's f32 caliper
        # center bit-for-bit (ops/cv2_centers.py); W/H/angle keep the
        # exact decomposition. One batched call, not per-frame.
        rect = _cv2_center_override(rect, cv2_tabs, max_bh=max_bh)
    det_xy = jnp.stack([rect['cx'], rect['cy']], axis=-1)
    det_info = jnp.stack([rect['w'], rect['h'], rect['angle_deg']], axis=-1)
    det_xy = jnp.where(det_valid[..., None], det_xy, 0.0)
    det_info = jnp.where(det_valid[..., None], det_info, 0.0)
    out = {'det_xy': det_xy, 'det_info': det_info, 'det_valid': det_valid,
           'n_components': n_components}
    if det_px is not None:
        out['det_px_idx'] = det_px.astype(jnp.int16)
    return out


def _stats_outputs(seg, keep, px_x, px_y, gray_in, gray_frames, n_components,
                   det_px, *, h, w, max_det, max_bh, include_luminosity,
                   exact_lum, lum_win, stats_sorted,
                   cv2_centers=False):
    """Shared detect tail: per-component rect/luminosity tables -> out dict.

    Consumes (T, F) pixel tables (``seg`` = dense component id, background =
    max_det) in any order — or (component, lin)-sorted order when
    ``stats_sorted`` (cheaper scan-based row tables).
    """
    t = seg.shape[0]

    def per_frame_stats(seg_f, keep_f, px_x_f, px_y_f, gray_f, frame_gray):
        tables = lb.component_stats(
            px_x_f, px_y_f, seg_f, keep_f,
            gray_vals=gray_f if (include_luminosity and not exact_lum)
            else None,
            max_det=max_det, max_bh=max_bh,
            sorted_runs=stats_sorted, frame_w=w, frame_h=h,
            cv2_centers=cv2_centers)
        rect = lb.min_area_rect(tables['points'], tables['points_valid'],
                                edge_angles=tables['edge_angles'],
                                edge_valid=tables['edge_valid'],
                                edge_dx=tables['edge_dx'],
                                edge_dy=tables['edge_dy'])
        det_valid = tables['count'] > 0
        if exact_lum:
            # reference-exact filled-rotated-rect mean (track_eval.py:290-300)
            from ysmr_tpu.ops.luminosity import rect_mean_luminosity
            lum = rect_mean_luminosity(frame_gray, rect['cx'], rect['cy'],
                                       rect['w'], rect['h'],
                                       rect['angle_deg'], det_valid,
                                       win=lum_win)
        elif include_luminosity:
            lum = tables['lum_sum'].astype(jnp.float32) / \
                jnp.maximum(tables['count'], 1) / 100.0
        else:
            lum = jnp.zeros_like(rect['cx'])
        cv2_tabs = {kk: tables[kk] for kk in _CV2_TABLE_KEYS} \
            if cv2_centers else {}
        return rect, det_valid, lum, cv2_tabs

    gray_frames_in = gray_frames if exact_lum else jnp.zeros((t, 1, 1),
                                                             jnp.int32)
    rect, det_valid, lum, cv2_tabs = jax.vmap(per_frame_stats)(
        seg, keep, px_x, px_y, gray_in, gray_frames_in)
    if cv2_centers:
        # bit-exact cv2 caliper centers for the tracker stream; one
        # batched call (per-frame invocations are latency-bound). Note the
        # exact-luminosity rect mean above used the exact centers — the
        # difference is below its integer-pixel fill granularity in all
        # but ulp-rare cases; the reference parity tests gate it.
        rect = _cv2_center_override(rect, cv2_tabs, max_bh=max_bh)
    xy = [rect['cx'], rect['cy']]
    if include_luminosity:
        xy.append(lum)
    det_xy = jnp.stack(xy, axis=-1)
    det_info = jnp.stack([rect['w'], rect['h'], rect['angle_deg']], axis=-1)
    det_xy = jnp.where(det_valid[..., None], det_xy, 0.0)
    det_info = jnp.where(det_valid[..., None], det_info, 0.0)
    out = {'det_xy': det_xy, 'det_info': det_info, 'det_valid': det_valid,
           'n_components': n_components}
    if det_px is not None:
        out['det_px_idx'] = det_px.astype(jnp.int16)
    return out

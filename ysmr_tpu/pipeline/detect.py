#!/usr/bin/env python3
"""Fused per-batch detection: frames -> padded detection tables on device.

One jitted pass replaces the reference's per-frame OpenCV chain
(track_eval.py:180-304): grayscale -> 3x3 blur -> threshold (one of three
modes) -> [marker reconstruction] -> connected components -> per-component
minAreaRect-equivalent (centre, w, h, angle) -> fixed-capacity detection
table. All stages are batched over T frames; XLA fuses the elementwise
chain, and labeling/segment stats run per frame under vmap.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ysmr_tpu.ops import labeling as lb
from ysmr_tpu.ops import preprocess as pp


class DetectorConfig:
    """Static detection parameters derived from tracking.ini settings."""

    def __init__(self, settings, fps):
        self.mode, self.offset = pp.resolve_detection_rule(settings)
        self.white_on_dark = settings['white bacteria on dark background']
        self.double_delta = settings['adaptive double threshold']
        self.max_det = settings['max detections per frame']
        self.max_bh = settings.get('max bounding box height', 96)
        self.cc_iters = settings['connected components max iterations']
        self.include_luminosity = settings['include luminosity in tracking calculation']
        self.lum_win = settings.get('luminosity window size', 48)
        self.fps = fps

    def static_key(self):
        return (self.mode, self.white_on_dark, self.offset, self.double_delta,
                self.max_det, self.max_bh, self.cc_iters,
                self.include_luminosity, self.lum_win)


@partial(jax.jit, static_argnames=('needs_sums',))
def prepare_batch(frames_bgr, needs_sums=False):
    """BGR frames -> (gray, blurred[, meanStdDev integer sums]).

    Runs as its own jit so mean-threshold mode can compute per-frame
    thresholds on host (the 5 s moving-average state, track_eval.py:221-253)
    between this pass and :func:`detect_from_blurred` without re-decoding.
    """
    gray = pp.bgr_to_gray(frames_bgr)
    blurred = pp.blur3(gray)
    if needs_sums:
        total, hi, lo = pp.frame_mean_std_sums(gray)
        return gray, blurred, total, hi, lo
    return gray, blurred


@partial(jax.jit, static_argnames=('mode', 'white_on_dark', 'offset',
                                   'double_delta', 'max_det', 'max_bh',
                                   'cc_iters', 'include_luminosity',
                                   'lum_win'))
def detect_from_blurred(gray, blurred, frame_valid, thresholds, *,
                        mode, white_on_dark, offset, double_delta,
                        max_det, max_bh, cc_iters, include_luminosity,
                        lum_win=48):
    """Detection tables from preprocessed frames.

    :param gray: (T, H, W) int32
    :param blurred: (T, H, W) int32
    :param frame_valid: (T,) bool — padding frames yield no detections
    :param thresholds: (T,) int32 per-frame global thresholds (mean mode;
        ignored for adaptive modes)
    :return: dict with det_xy (T, D, K), det_info (T, D, 3) [w, h, angle_deg],
        det_valid (T, D), n_components (T,)
    """
    mask, markers = pp.detect_masks(blurred, mode, offset, double_delta,
                                    white_on_dark, global_thresholds=thresholds)
    mask = mask & frame_valid[:, None, None]

    if markers is not None:
        # keep the 4-connected mask components that hold a marker pixel
        # (bit-packed reconstruction: 32 frames per uint32 plane)
        markers = markers & frame_valid[:, None, None]
        mask = lb.binary_reconstruct(mask, markers, max_iters=cc_iters)

    labels8 = jax.vmap(lambda a: lb.label_components(
        a, connectivity=8, max_iters=cc_iters))(mask)

    def per_frame(m, g, labels):
        comp, n = lb.compact_labels(labels, m, max_det=max_det)
        tables = lb.component_tables(comp, m, gray=None,
                                     max_det=max_det, max_bh=max_bh)
        rect = lb.min_area_rect(tables['points'], tables['points_valid'],
                                edge_angles=tables['edge_angles'],
                                edge_valid=tables['edge_valid'],
                                edge_dx=tables['edge_dx'],
                                edge_dy=tables['edge_dy'])
        valid = tables['count'] > 0
        if include_luminosity:
            # reference-exact: mean gray over the FILLED ROTATED RECTANGLE
            # (cv2.boxPoints + fillPoly + cv2.mean / 100,
            # track_eval.py:290-300) — see ops/luminosity.py
            from ysmr_tpu.ops.luminosity import rect_mean_luminosity
            lum = rect_mean_luminosity(g, rect['cx'], rect['cy'], rect['w'],
                                       rect['h'], rect['angle_deg'], valid,
                                       win=lum_win)
        else:
            lum = None
        return rect, valid, n, lum

    rect, valid, n_components, lum = jax.vmap(per_frame)(mask, gray, labels8)
    xy = [rect['cx'], rect['cy']]
    if include_luminosity:
        xy.append(lum)
    det_xy = jnp.stack(xy, axis=-1)
    det_info = jnp.stack([rect['w'], rect['h'], rect['angle_deg']], axis=-1)
    det_xy = jnp.where(valid[..., None], det_xy, 0.0)
    det_info = jnp.where(valid[..., None], det_info, 0.0)
    return {'det_xy': det_xy, 'det_info': det_info, 'det_valid': valid,
            'n_components': n_components}


def detect_batch(frames_bgr, frame_valid, config, threshold_state=None):
    """Full host-coordinated detection for one frame batch.

    For mean-threshold mode this performs the two-phase flow: device stats ->
    host moving-average thresholds -> device detection. ``threshold_state``
    is a :class:`ysmr_tpu.ops.preprocess.MovingAverageThreshold` carried
    across batches.
    """
    import numpy as np
    needs_sums = config.mode == 'mean'
    t = frames_bgr.shape[0]
    if needs_sums:
        gray, blurred, total, hi, lo = prepare_batch(frames_bgr, needs_sums=True)
        n_pix = frames_bgr.shape[1] * frames_bgr.shape[2]
        mean, std = pp.combine_mean_std(n_pix, np.asarray(total),
                                        np.asarray(hi), np.asarray(lo))
        valid_np = np.asarray(frame_valid)
        thr = np.zeros((t,), np.int32)
        for i in range(t):
            if valid_np[i]:
                thr[i] = threshold_state.update(mean[i], std[i])
        thresholds = jnp.asarray(thr)
    else:
        gray, blurred = prepare_batch(frames_bgr, needs_sums=False)
        thresholds = jnp.zeros((t,), jnp.int32)
    return detect_from_blurred(
        gray, blurred, frame_valid, thresholds,
        mode=config.mode, white_on_dark=config.white_on_dark,
        offset=config.offset, double_delta=config.double_delta,
        max_det=config.max_det, max_bh=config.max_bh,
        cc_iters=config.cc_iters,
        include_luminosity=config.include_luminosity,
        lum_win=config.lum_win)

#!/usr/bin/env python3
"""Frame preprocessing: grayscale, blur, and the three threshold modes.

Replaces the reference's per-frame OpenCV calls (track_eval.py:180-253):
``cv2.cvtColor`` BGR->gray, ``cv2.GaussianBlur(gray, (3,3), 0)``,
``cv2.adaptiveThreshold`` (Gaussian, 11x11), and the mean+stddev global
threshold — as batched JAX ops that XLA fuses into a single device pass.

All integer paths are **bit-exact** with OpenCV (verified empirically in
tests/test_preprocess.py):

* gray  = (B*3735 + G*19235 + R*9798 + 2^14) >> 15           (BGR2GRAY 8U)
* blur3 = separable [64,128,64]/256 fixed point, reflect-101 border,
          rounded as (acc + 2^15) >> 16                      (GaussianBlur 3x3)
* adaptive mean = float32 separable Gaussian (getGaussianKernel(11, sigma=2)),
          replicate border, rounded half away from zero — this is the float
          path cv2.adaptiveThreshold uses internally (NOT the bit-exact
          fixed-point GaussianBlur)
* adaptive rule: THRESH_BINARY:     src - mean + ceil(C)  > 0
                 THRESH_BINARY_INV: src - mean + floor(C) <= 0
"""

import math

import jax.numpy as jnp
import numpy as np

# OpenCV 8U BGR2GRAY fixed-point coefficients at shift 15 (sum == 2^15).
_B2Y, _G2Y, _R2Y = 3735, 19235, 9798


def _gaussian_kernel_11():
    """cv2.getGaussianKernel(11, 0) — sigma = 0.3*((11-1)*0.5 - 1) + 0.8 = 2.0."""
    sigma = 0.3 * ((11 - 1) * 0.5 - 1) + 0.8
    xs = np.arange(11) - 5
    k = np.exp(-(xs.astype(np.float64) ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


_K11_F32 = _gaussian_kernel_11()


def bgr_to_gray(frames_bgr):
    """Batched OpenCV-exact BGR->gray for uint8 frames.

    :param frames_bgr: (..., H, W, 3) uint8
    :return: (..., H, W) int32 grayscale in [0, 255]
    """
    f = frames_bgr.astype(jnp.int32)
    acc = f[..., 0] * _B2Y + f[..., 1] * _G2Y + f[..., 2] * _R2Y + (1 << 14)
    return acc >> 15


def blur3(gray):
    """OpenCV-exact 3x3 Gaussian blur (sigma 0) on integer grayscale.

    Separable [64,128,64] fixed-point kernel, BORDER_DEFAULT (reflect-101),
    result = (acc + 2^15) >> 16. Input/output int32, batched over leading dims.
    """
    g = gray.astype(jnp.int32)
    p = jnp.pad(g, [(0, 0)] * (g.ndim - 2) + [(1, 1), (1, 1)], mode='reflect')
    w = p.shape[-1]
    h = p.shape[-2]
    tmp = (p[..., :, 0:w - 2] * 64 + p[..., :, 1:w - 1] * 128 + p[..., :, 2:w] * 64)
    acc = (tmp[..., 0:h - 2, :] * 64 + tmp[..., 1:h - 1, :] * 128 + tmp[..., 2:h, :] * 64)
    return (acc + (1 << 15)) >> 16


def adaptive_gaussian_mean(img):
    """The 11x11 Gaussian-weighted local mean used by cv2.adaptiveThreshold.

    float32 separable convolution with the CV_32F kernel, BORDER_REPLICATE,
    rounded half to even. Input int32, output int32. The host recipe
    (native/ysmr_native.cpp) accumulates each pass as one product and ten
    fused multiply-adds; this sum rounds each product unless the compiler
    contracts it, so the two can differ where the accumulator lands within
    an ulp of a rounding tie (seen on pure-noise frames, never on the
    bacteria clips).
    """
    k = jnp.asarray(_K11_F32)
    p = jnp.pad(img.astype(jnp.float32),
                [(0, 0)] * (img.ndim - 2) + [(5, 5), (5, 5)], mode='edge')
    w = p.shape[-1]
    h = p.shape[-2]
    tmp = sum(p[..., :, i:w - 10 + i] * k[i] for i in range(11))
    acc = sum(tmp[..., i:h - 10 + i, :] * k[i] for i in range(11))
    # cv2 (and the native host recipe) round with rint: half to even
    return jnp.round(acc).astype(jnp.int32)


def adaptive_threshold(img, c_offset, white_on_dark):
    """cv2.adaptiveThreshold(ADAPTIVE_THRESH_GAUSSIAN_C, blockSize=11) as bool.

    ``c_offset`` is the C parameter as the reference passes it
    (track_eval.py:189-208: C = -offset, already sign-adjusted for dark
    backgrounds). ``white_on_dark`` selects THRESH_BINARY vs BINARY_INV.

    :param img: (..., H, W) int32 blurred grayscale
    :param c_offset: python float, static
    :return: (..., H, W) bool foreground mask
    """
    mean = adaptive_gaussian_mean(img)
    diff = img.astype(jnp.int32) - mean
    if white_on_dark:
        return diff > -int(math.ceil(c_offset))
    return diff <= -int(math.floor(c_offset))


def global_threshold(img, thresh, white_on_dark):
    """cv2.threshold(img, T, 255, BINARY/BINARY_INV) as bool mask.

    ``thresh`` may be a traced per-frame scalar (broadcast over H, W).
    cv2 floors the double threshold for 8U sources; callers pass ints.
    """
    t = jnp.asarray(thresh, dtype=jnp.int32)
    while t.ndim < img.ndim:
        t = t[..., None]
    if white_on_dark:
        return img > t
    return img <= t


def frame_mean_std_sums(gray):
    """Exact integer sums for cv2.meanStdDev parity on uint8 grayscale.

    Returns (sum, sumsq_hi, sumsq_lo) per frame as int32, where
    sum(x^2) = sumsq_hi * 2^16 + sumsq_lo. The host combines these in float64
    and applies the reference's 5-second moving-average threshold logic
    (track_eval.py:221-253) without any float32 precision loss.

    :param gray: (..., H, W) int32 in [0, 255]
    :return: tuple of (...,) int32 arrays
    """
    g = gray.astype(jnp.int32)
    total = jnp.sum(g, axis=(-2, -1))
    sq = g * g  # <= 65025, fits easily
    row_sums = jnp.sum(sq, axis=-1)  # <= W * 65025 ~ 8e7, fits int32
    hi = jnp.sum(row_sums >> 16, axis=-1)
    lo_rows = row_sums & 0xFFFF
    lo = jnp.sum(lo_rows, axis=-1)  # <= H * 65535 ~ 6e7, fits int32
    return total, hi, lo


def combine_mean_std(n_pixels, total, hi, lo):
    """Host-side float64 mean/std from frame_mean_std_sums outputs.

    Matches cv2.meanStdDev: std = sqrt(E[x^2] - mean^2) (population std).
    """
    total = np.asarray(total, dtype=np.float64)
    sumsq = np.asarray(hi, dtype=np.float64) * 65536.0 + np.asarray(lo, dtype=np.float64)
    mean = total / n_pixels
    var = sumsq / n_pixels - mean * mean
    return mean, np.sqrt(np.maximum(var, 0.0))


class MovingAverageThreshold:
    """The reference's 5-second moving-average global threshold state.

    Mirrors track_eval.py:221-253: per frame, threshold_i = mean + std + offset
    (white bacteria) or mean - std - offset (dark), appended to a window of at
    most ``fps * 5`` values; the applied threshold is ``int(window mean)``
    (truncation toward zero, as Python ``int()`` does).
    """

    def __init__(self, fps, offset, white_on_dark):
        self.window = []
        self.max_len = fps * 5
        self.offset = offset
        self.white_on_dark = white_on_dark

    def update(self, mean, std):
        """Feed one frame's mean/std; returns the int threshold to apply."""
        if self.white_on_dark:
            value = mean + std + self.offset
        else:
            value = mean - std - self.offset
        self.window.append(float(value))
        threshold = int(sum(self.window) / len(self.window))
        if len(self.window) > self.max_len:
            del self.window[0]
        return threshold

    def update_batch(self, means, stds):
        """Vector of thresholds for a batch of frames (sequential semantics)."""
        return np.array([self.update(m, s) for m, s in zip(means, stds)],
                        dtype=np.int32)


def detect_masks(blurred, mode, c_offset, double_delta, white_on_dark,
                 global_thresholds=None):
    """Compute (mask, markers) for a frame batch under the configured mode.

    ``mode`` is one of 'adaptive' (single adaptive threshold), 'adaptive_double'
    (adaptive + stricter marker threshold; caller reconstructs via labeling),
    or 'mean' (global threshold per frame from ``global_thresholds``).
    Thresholds follow track_eval.py:185-253 semantics, including the
    negation of the offset for dark-background videos (track_eval.py:127-132).

    :return: (mask_bool, markers_bool_or_None)
    """
    if mode == 'mean':
        if global_thresholds is None:
            raise ValueError('mean mode requires per-frame thresholds')
        return global_threshold(blurred, global_thresholds, white_on_dark), None
    # reference passes C = -offset (offset already negated for dark bg)
    mask = adaptive_threshold(blurred, -c_offset, white_on_dark)
    if mode == 'adaptive_double':
        markers = adaptive_threshold(blurred, -(c_offset + double_delta), white_on_dark)
        return mask, markers
    return mask, None


def detect_mode_from_settings(settings):
    """Map the 'adaptive double threshold' setting to a mode string.

    track_eval.py:185-253: > 0 double, == 0 single adaptive, < 0 mean mode.
    """
    adt = settings['adaptive double threshold']
    if adt > 0:
        return 'adaptive_double'
    if adt == 0:
        return 'adaptive'
    return 'mean'


def resolve_detection_rule(settings):
    """(mode, offset) with the reference's dark-mode double-threshold
    degeneration resolved.

    For dark bacteria the reference negates the offset in place
    (track_eval.py:125-131) and then ADDS the double-threshold delta to the
    negated value (track_eval.py:200-208), which makes the marker threshold
    WEAKER than the mask. The two rules are always nested, and scipy's
    binary_propagation keeps input pixels (dilation is extensive), so the
    reconstruction then equals the marker threshold alone — the pipeline
    must run a single adaptive threshold at the marker offset to reproduce
    the reference bit for bit (verified e2e on dark clips). Bright-mode
    semantics (marker a strict subset) are unchanged.
    """
    mode = detect_mode_from_settings(settings)
    offset = effective_threshold_offset(settings)
    if mode != 'adaptive_double':
        return mode, offset
    delta = settings['adaptive double threshold']
    c_mask = -offset
    c_marker = -(offset + delta)
    if settings['white bacteria on dark background']:
        marker_subset = -math.ceil(c_marker) >= -math.ceil(c_mask)
    else:
        marker_subset = -math.floor(c_marker) <= -math.floor(c_mask)
    if marker_subset:
        return mode, offset
    return 'adaptive', offset + delta


def effective_threshold_offset(settings):
    """Offset with the dark-background negation applied (track_eval.py:127-132).

    The reference mutates the settings dict in place; this build computes the
    effective value without mutation.
    """
    offset = settings['threshold offset for detection']
    if not settings['white bacteria on dark background']:
        offset = -offset
    return offset

#!/usr/bin/env python3
"""Batched Gaussian-Sum FIR filter bank over padded track slots.

Re-derivation of the reference's per-object GaussianSumFIR (gsff.py:28-347;
Pak JM, "Gaussian Sum FIR Filtering for 2D Target Tracking",
DOI 10.1007/s12555-018-0938-4) as fully vectorised slot-table updates:

* Filter-bank horizons n_i (Eq. 17, gsff.py:86-109) and least-squares gains
  (Eq. 13/14, gsff.py:111-153) are precomputed once in float64 on host.
* Each track slot carries a ring of the last n_max+1 measurements, the mode
  (number of active filters), and the weight vector. The per-call
  ``x_hat_array`` of the reference needs no carried state: the array the
  reference's ``correct()`` consumes always equals the LS estimates computed
  from the pre-append window, whether it was written by the previous
  ``predict()`` or re-filled on a mode transition — so this build recomputes
  it, which keeps the scan state small.
* ``correct`` output (Eq. 12/20, gsff.py:155-202,251-347) is the weighted sum
  of pre-append filter estimates under the *updated* weights; ``predict``
  output is the weighted sum of post-append estimates and becomes the stored
  position for the next frame's distance matrix (tracker.py:219-227).

Weights live in log space: the reference's multiplicative update
``w_i <- lik_i * w_i / sum`` (gsff.py:320-334) becomes
``log_w_i <- log_w_i + max(-0.5*d_i^2, log(1e-20)) - logsumexp(...)``, which
is the same recursion in exact arithmetic but cannot underflow — in linear
float32 a weight that reaches 0 is dead forever (the reference's float64
weights survive at 1e-300 and recover), and no ``exp`` is needed in the
update at all.

Precision: the FIR estimates, the measurement ring, and the emitted
corrected/predicted positions are computed in **double-single arithmetic**
(each value an unevaluated sum of two float32, ~48-bit effective mantissa;
Dekker/Knuth error-free transformations, no float64 anywhere).
Plain float32 is NOT enough here: a disappeared-but-alive track feeds its own
prediction back as the measurement (tracker.py:219-227), and that closed loop
amplifies float32 rounding into a systematic coasting drift of ~0.02 px/frame
— enough to flip near-tie greedy assignments against the reference's float64
trajectories and permute TRACK_ID numbering from there on. Double-single
keeps the coasting trajectory within ~0.01 px of the reference's float64 one
for the full `max_disappeared` grace period (the residual comes from the
float32 log-space weights, whose rounding the mixture amplifies at mode
transitions — see tests/test_gsff.py::test_coasting_self_feedback_parity).

Luminosity note: the reference's GSFF cannot consume 3-component
(x, y, luminosity) measurements (its gains are sized for 2-D observations;
gsff.py:155-177 would raise on a 3-dim flatten). This build filters x/y and
passes luminosity through unfiltered, which is the behaviour a user of
luminosity + GSFF needs.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ysmr_tpu.ops.ds import (add as _ds_add, dot_tree as _ds_dot_tree,
                             mul as _ds_mul, sub as _ds_sub)

LIKELIHOOD_MINIMUM = 1e-20


def generate_n_i(n_min=0, n_max=30, n_f=3):
    """Filter horizon sizes, Eq. 17 (gsff.py:86-109)."""
    p = (n_max - n_min) / n_f
    return [int(n_min + p * i) for i in range(1, n_f + 1)]


def compute_lsf_gain(filter_size, delta_time, a=None, c=None):
    """Least-squares FIR gain for one horizon, Eq. 13/14 (gsff.py:111-153).

    Constant-velocity state model A (4x4) and position observation C (2x4).
    :return: (4, 2*filter_size) float64 gain
    """
    if a is None:
        a = np.array([[1, 0, delta_time, 0],
                      [0, 1, 0, delta_time],
                      [0, 0, 1, 0],
                      [0, 0, 0, 1]], dtype=np.float64)
    if c is None:
        c = np.array([[1, 0, 0, 0],
                      [0, 1, 0, 0]], dtype=np.float64)
    h_bar = c
    a_n = a
    for _ in range(filter_size - 1):
        h_bar = np.concatenate((h_bar, np.dot(c, a_n)), axis=0)
        a_n = np.dot(a_n, a)
    l_bar = np.dot(h_bar, np.linalg.matrix_power(np.linalg.inv(a), filter_size))
    return np.dot(np.linalg.inv(np.dot(l_bar.T, l_bar)), l_bar.T)


class GSFFParams:
    """Precomputed, padded filter-bank parameters (static per video)."""

    def __init__(self, fps, n_min=0, n_max=None, n_f=3):
        if n_max is None:
            n_max = int(fps)
        self.n_f = n_f
        self.n_i = generate_n_i(n_min=n_min, n_max=n_max, n_f=n_f)
        self.n_max = self.n_i[-1]
        self.buf_len = self.n_max + 1
        delta_t = 1.0 / fps
        # gains right-aligned into (n_f, 2, 2*n_max): gain_i consumes the last
        # n_i measurements of the flattened oldest-first window; only the
        # first two state rows (position) are ever used downstream.
        gains = np.zeros((n_f, 2, 2 * self.n_max), dtype=np.float64)
        for i, n in enumerate(self.n_i):
            if n < 1:
                continue
            g = compute_lsf_gain(n, delta_t)
            gains[i, :, 2 * (self.n_max - n):] = g[:2]
        #: float64 right-aligned gains, consumed directly by the native f64
        #: host tracker (native/tracker64.cpp)
        self.gains_f64 = gains
        # double-single representation: stacked (hi, lo) f32 pair carrying
        # the full float64 coefficients (lo = residual after f32 rounding)
        g_hi = gains.astype(np.float32)
        g_lo = (gains - g_hi.astype(np.float64)).astype(np.float32)
        self.gains = jnp.asarray(np.stack([g_hi, g_lo]))  # (2, n_f, 2, 2n_max)
        self.n_i_arr = jnp.asarray(self.n_i, dtype=jnp.int32)


NEG_INF = np.float32(-1e30)  # numpy, not jnp: keep imports backend-free


def init_state(params, max_slots):
    """Fresh per-slot GSFF state pytree (weights kept as logs).

    ``buf``/``buf_lo`` and ``pred_lo`` are the double-single pairs of the
    measurement ring and of the last prediction (the hi half of the
    prediction is the tracker's stored ``pos``).
    """
    return {
        'buf': jnp.zeros((max_slots, params.buf_len, 2), dtype=jnp.float32),
        'buf_lo': jnp.zeros((max_slots, params.buf_len, 2),
                            dtype=jnp.float32),
        'len': jnp.zeros((max_slots,), dtype=jnp.int32),
        'mode': jnp.zeros((max_slots,), dtype=jnp.int32),
        'log_w': jnp.full((max_slots, params.n_f), NEG_INF, dtype=jnp.float32),
        'pred_lo': jnp.zeros((max_slots, 2), dtype=jnp.float32),
    }


def register_slots(state, params, register_mask, measurements):
    """Initialise newly-registered slots with their first measurement.

    Reference semantics: previous_measurements = [m] * n_i[0]
    (gsff.py:279-281); the whole buffer is filled with m, which is equivalent
    because only the last n_i[mode] entries are ever consumed. Detection
    measurements are exact float32 values, so their lo halves are zero.
    """
    m = measurements.astype(jnp.float32)
    buf_new = jnp.broadcast_to(m[:, None, :], state['buf'].shape)
    reg = register_mask[:, None, None]
    buf = jnp.where(reg, buf_new, state['buf'])
    buf_lo = jnp.where(reg, 0.0, state['buf_lo'])
    length = jnp.where(register_mask, jnp.int32(params.n_i[0]), state['len'])
    mode = jnp.where(register_mask, 0, state['mode'])
    log_w = jnp.where(register_mask[:, None], NEG_INF, state['log_w'])
    pred_lo = jnp.where(register_mask[:, None], 0.0, state['pred_lo'])
    return {'buf': buf, 'buf_lo': buf_lo, 'len': length, 'mode': mode,
            'log_w': log_w, 'pred_lo': pred_lo}


def _ds_estimates(gains_h, gains_l, center_h, center_l, buf_h, buf_l):
    """LS estimates ``center + gains @ (window - center)`` in double-single.

    The position-row gain coefficients sum to 1 (the estimate is
    affine-equivariant), so estimates are computed relative to the newest
    window entry — equal to the reference's absolute-coordinate
    ``np.dot(gain, window)`` (gsff.py:155-177) in exact arithmetic, while
    keeping the double-single products on small local-motion values.

    :param gains_h, gains_l: (n_f, 2, 2*n_max)
    :param center_h, center_l: (S, 2)
    :param buf_h, buf_l: (S, n_max+1, 2) rings (oldest first)
    :return: (x_h, x_l) of shape (S, n_f, 2)
    """
    s = buf_h.shape[0]
    w2 = gains_h.shape[-1]
    win_h, win_l = _ds_sub(buf_h[:, 1:, :], buf_l[:, 1:, :],
                           center_h[:, None, :], center_l[:, None, :])
    win_h = win_h.reshape(s, 1, 1, w2)
    win_l = win_l.reshape(s, 1, 1, w2)
    dot_h, dot_l = _ds_dot_tree(gains_h[None], gains_l[None], win_h, win_l)
    return _ds_add(center_h[:, None, :], center_l[:, None, :], dot_h, dot_l)


@partial(jax.jit, static_argnames=('n_f',))
def _step(gains, n_i_arr, n_f, state, measurements, active,
          measurements_lo=None):
    """One correct+predict step for all slots.

    :param gains: (2, n_f, 2, 2*n_max) stacked double-single gain pair
    :param measurements: (S, 2) float32 — matched detection position or the
        previous prediction (hi half) for disappeared-but-alive slots
    :param measurements_lo: (S, 2) float32 or None — lo half of the
        measurement; nonzero only for coasting slots feeding their own
        prediction back (the tracker passes the stored ``pred_lo``)
    :param active: (S,) bool — slots participating this frame
    :return: (new_state, corrected (S, 2), predicted (S, 2))
    """
    buf, length, mode, log_w = (state['buf'], state['len'], state['mode'],
                                state['log_w'])
    buf_lo = state['buf_lo']
    s, buf_len, _ = buf.shape
    n_max = buf_len - 1
    m = measurements.astype(jnp.float32)
    ml = (jnp.zeros_like(m) if measurements_lo is None
          else measurements_lo.astype(jnp.float32))
    gains_h, gains_l = gains[0], gains[1]

    # (a) mode growth: while mode < n_f and len >= n_i[mode] (gsff.py:283-289)
    new_mode = mode
    for _ in range(n_f):
        can_grow = (new_mode < n_f) & (length >= n_i_arr[jnp.clip(new_mode, 0, n_f - 1)])
        new_mode = new_mode + can_grow.astype(jnp.int32)
    grew = new_mode > mode
    filt_idx = jnp.arange(n_f, dtype=jnp.int32)
    filt_active = filt_idx[None, :] < new_mode[:, None]  # (S, n_f)

    # (b) weights: uniform 1/mode on transition (gsff.py:291-303)
    uniform = -jnp.log(jnp.maximum(new_mode, 1).astype(jnp.float32))[:, None]
    lw_in = jnp.where(grew[:, None], uniform, log_w)
    lw_in = jnp.where(filt_active, lw_in, NEG_INF)

    # (c) pre-append LS estimates (window = last n_max ring entries)
    x_pre_h, x_pre_l = _ds_estimates(gains_h, gains_l, buf[:, -1, :],
                                     buf_lo[:, -1, :], buf, buf_lo)

    # (d) log likelihoods vs the new measurement, Eq. 20 (gsff.py:179-202),
    # floored at log(likelihood_minimum) exactly as the reference floors lik.
    # d2 needs only f32 *relative* accuracy, but the difference must come
    # from the double-single values (hi-only differences would re-introduce
    # the coasting rounding this module exists to remove).
    diff_h, diff_l = _ds_sub(m[:, None, :], ml[:, None, :], x_pre_h, x_pre_l)
    d2 = jnp.sum(diff_h * diff_h + 2.0 * diff_h * diff_l, axis=-1)  # (S, n_f)
    log_lik = jnp.maximum(-0.5 * d2, jnp.float32(np.log(LIKELIHOOD_MINIMUM)))

    # (e) weight update w_i <- lik_i * w_i / sum in log space (gsff.py:320-334)
    lw = jnp.where(filt_active, lw_in + log_lik, NEG_INF)
    lw_max = jnp.max(lw, axis=1, keepdims=True)
    lse = lw_max + jnp.log(jnp.sum(jnp.exp(lw - lw_max), axis=1, keepdims=True))
    lw_new = jnp.where(filt_active, lw - lse, NEG_INF)
    w_new = jnp.where(filt_active, jnp.exp(lw_new), 0.0)

    # (f) corrected output: weighted pre-append estimates (gsff.py:337)
    cw_h, cw_l = _ds_mul(x_pre_h, x_pre_l, w_new[:, :, None],
                         jnp.zeros_like(w_new)[:, :, None])
    corr_h, corr_l = cw_h[:, 0, :], cw_l[:, 0, :]
    for i in range(1, n_f):
        corr_h, corr_l = _ds_add(corr_h, corr_l, cw_h[:, i, :], cw_l[:, i, :])
    corrected = corr_h + corr_l

    # (g) append measurement, recompute estimates, predict (gsff.py:204-249)
    buf_new = jnp.concatenate([buf[:, 1:, :], m[:, None, :]], axis=1)
    buf_lo_new = jnp.concatenate([buf_lo[:, 1:, :], ml[:, None, :]], axis=1)
    x_post_h, x_post_l = _ds_estimates(gains_h, gains_l, m, ml,
                                       buf_new, buf_lo_new)
    pw_h, pw_l = _ds_mul(x_post_h, x_post_l, w_new[:, :, None],
                         jnp.zeros_like(w_new)[:, :, None])
    pred_h, pred_l = pw_h[:, 0, :], pw_l[:, 0, :]
    for i in range(1, n_f):
        pred_h, pred_l = _ds_add(pred_h, pred_l, pw_h[:, i, :], pw_l[:, i, :])

    act = active
    out_state = {
        'buf': jnp.where(act[:, None, None], buf_new, buf),
        'buf_lo': jnp.where(act[:, None, None], buf_lo_new, buf_lo),
        'len': jnp.where(act, jnp.minimum(length + 1, n_max + 1), length),
        'mode': jnp.where(act, new_mode, mode),
        'log_w': jnp.where(act[:, None], lw_new, log_w),
        'pred_lo': jnp.where(act[:, None], pred_l, state['pred_lo']),
    }
    corrected = jnp.where(act[:, None], corrected, 0.0)
    predicted = jnp.where(act[:, None], pred_h, 0.0)
    return out_state, corrected, predicted


def step(params, state, measurements, active, measurements_lo=None):
    """Public wrapper binding the static bank parameters."""
    return _step(params.gains, params.n_i_arr, params.n_f, state,
                 measurements, active, measurements_lo)

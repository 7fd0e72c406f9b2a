#!/usr/bin/env python3
"""Double-single (two-float32) arithmetic — error-free transformations.

Every value is an unevaluated sum ``hi + lo`` with ``|lo| <= ulp(hi)/2``
(~48-bit effective mantissa). No float64 anywhere, so the ops run in the
vector units at float32 rate on any backend. XLA does not reassociate
floating-point expressions. XLA:CPU contracts a multiply followed by an add
into one fused multiply-add; XLA:GPU rounds the product first (both
measured with the same jitted ``a * b + c``, H100 and x86). The error-free
transformations stay exact either way: every product inside
:func:`two_prod` is exact, so a contracted multiply-add rounds the same
(``p + e == a * b`` held for 2**20 random pairs on both backends). The
products that are not exact, such as the cross terms ``xh * yl + xl * yh``
of :func:`mul`, round differently when contracted, so CPU and GPU results
agree to the double-single error, not bit for bit (verified against a
float64 oracle on the CPU in tests/test_gsff.py and on the GPU in
tests/test_on_card.py).

Used by ops/gsff.py (the filter bank must track the reference's float64
trajectories through a self-feedback loop) and ops/labeling.py (exact
min-area comparisons between hull-edge candidate rectangles).
"""

import jax.numpy as jnp


def two_sum(a, b):
    """Knuth two-sum: a + b = s + e exactly (no magnitude precondition)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """Dekker fast two-sum; requires |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Veltkamp/Dekker two-product: a * b = p + e exactly (f32, no FMA).

    Split factor 2**12 + 1 halves the 24-bit f32 mantissa. Safe for the
    coordinate magnitudes in this package (overflow needs |a| ~ 2**115).
    """
    p = a * b
    ca = jnp.float32(4097.0) * a
    ah = ca - (ca - a)
    al = a - ah
    cb = jnp.float32(4097.0) * b
    bh = cb - (cb - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def add(xh, xl, yh, yl):
    """Double-single addition (Dekker add2, ~1 ulp**2 error)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def sub(xh, xl, yh, yl):
    return add(xh, xl, -yh, -yl)


def mul(xh, xl, yh, yl):
    """Double-single multiplication."""
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def div_by_f32(xh, xl, d):
    """Double-single divided by an exact float32 divisor, DS quotient."""
    q0 = xh / d
    r0h, r0l = two_prod(q0, d)
    rh, rl = sub(xh, xl, r0h, r0l)
    q1 = (rh + rl) / d
    return quick_two_sum(q0, q1)


def dot_tree(gh, gl, wh, wl):
    """DS dot product over the last axis via pairwise tree reduction.

    :param gh, gl: coefficient pair, broadcastable against the window
    :param wh, wl: window pair (..., W)
    :return: (hi, lo) with the trailing axis reduced
    """
    ph, pl = mul(gh, gl, wh, wl)
    n = ph.shape[-1]
    while n > 1:
        half = n // 2
        if n % 2:  # fold the odd element into slot 0 first
            ph0, pl0 = add(ph[..., 0], pl[..., 0],
                           ph[..., n - 1], pl[..., n - 1])
            ph = ph.at[..., 0].set(ph0)
            pl = pl.at[..., 0].set(pl0)
        ph, pl = add(ph[..., :half], pl[..., :half],
                     ph[..., half:2 * half], pl[..., half:2 * half])
        n = half
    return ph[..., 0], pl[..., 0]

"""Error-free-transformation (double-f32) arithmetic for the embedded
error estimate (VERDICT-r4 #3).

At the reference's rtol=1.4e-8 the float32 embedded error estimate sits
near the f32 noise floor (measured round 2-4: cos(f32, f64) of the
regularizer gradient ~0.15 on the latent shape at that tolerance). The
round-2 regrouping (``sum(btilde_i (k_i - k1))``, ops/ode.py) already
removed the catastrophic O(1)->O(dt^5) summation cancellation; this
module removes what is left of the ARITHMETIC noise in the estimator —
every product/scale rounding in the combination and the scaled norm —
by carrying the error residual as an unevaluated (hi, lo) float32 pair
(Dekker/Knuth error-free transformations: TwoSum, Split, TwoProd).

What it cannot remove, by construction, is noise already present in its
INPUTS: the stage derivatives ``k_i`` are f32-rounded values of
``f(y_stage)`` where ``y_stage`` itself was f32-rounded — input noise
~eps*|y| enters ``k`` amplified by the dynamics' Lipschitz constant and
no downstream arithmetic can see below it. ``tools/lode_f64_probe.py``'s
round-5 legs measure exactly this split (compensated-combination vs
f32-rounded-stage-input ceilings): on the latent-ODE workload at
rtol=1.4e-8 the compensated combination measured no gain, because the
floor is the f32 state carry, not the estimator arithmetic.

All ops are plain f32 adds/muls — differentiable, and safe
under XLA (which does not reassociate floats).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "two_sum",
    "two_prod",
    "compensated_error_combination",
    "compensated_error_ssq",
]


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (s = fl(a+b))."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    """Dekker split at half the mantissa (f32: 2^12 + 1; f64: 2^27 + 1)."""
    factor = 134217729.0 if a.dtype == jnp.float64 else 4097.0
    c = jnp.asarray(factor, a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: p + e == a * b exactly (p = fl(a*b))."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def compensated_error_combination(dt_eff, btilde, k_leaves):
    """``dt * sum(btilde_i * (k_i - k_0))`` as an exact (hi, lo) pair.

    The differences ``k_i - k_0`` are computed in plain f32 (they are
    nearly Sterbenz-exact for close stage values — and any error there
    is INPUT noise this transformation cannot see anyway); every product
    and the running sum are error-free transformed."""
    k0 = k_leaves[0]
    s_hi = jnp.zeros_like(k0)
    s_lo = jnp.zeros_like(k0)
    for c, k in zip(btilde[1:], k_leaves[1:]):
        d = k - k0
        p, pe = two_prod(jnp.asarray(c, d.dtype), d)
        s_hi, e = two_sum(s_hi, p)
        s_lo = s_lo + (e + pe)
    m, me = two_prod(s_hi, dt_eff)
    return m, s_lo * dt_eff + me


def compensated_error_ssq(err_hi, err_lo, y0, y1, rtol, atol):
    """Sum of squares of the tolerance-scaled residual, with the (hi, lo)
    error pair folded in BEFORE squaring. Returns a plain f32 scalar
    (the final rounding of an O(1) ratio is harmless)."""
    denom = atol + jnp.maximum(jnp.abs(y0), jnp.abs(y1)) * rtol
    q = err_hi / denom
    # residual of the division: (err_hi - q*denom) + err_lo, re-scaled
    p, pe = two_prod(q, denom)
    r = ((err_hi - p) - pe + err_lo) / denom
    # (q + r)^2 to first order in r (r is O(eps * q))
    return jnp.sum(q * q + 2.0 * q * r)

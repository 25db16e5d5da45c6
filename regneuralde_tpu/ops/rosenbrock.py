"""Rosenbrock23: an L-stable stiff trial step for the adaptive engines.

The reference's experiments construct ``AutoTsit5(...)`` composites
(reference: experiments/mnist_node.jl:70-81) whose *stiff fallback there
is Tsit5 itself* — upstream only consumes the composite's ``eigen_est``
telemetry, never an implicit integrator. This module supplies the real
capability the composite implies: a 2nd-order / 3rd-order-embedded
Rosenbrock W-method (Shampine & Reichelt's ode23s pair, the same method
OrdinaryDiffEq ships as ``Rosenbrock23``), plugged into the SAME adaptive
loop, controller, telemetry, saveat interpolation, and autodiff engines
as the explicit tableaus via the ``stage_sweep`` contract.

Mapping: the per-sample Jacobian is materialised as a batched
``(batch, dim, dim)`` tensor by pushing the ``dim`` basis tangents
through one ``vmap`` of ``jvp`` (dim forward-mode evaluations of the
*batched* dynamics — matmul-shaped, no per-sample Python loop), and the
three stage solves reuse ONE batched LU factorisation of
``W = I - d*h*J``. Everything is traced, so ``mode="scan"`` gradients
(including through the LU) come out of autodiff directly.

Assumption (documented contract): batched dynamics act per-sample —
``func(t, y, args)[b]`` depends only on ``y[b]`` — which holds for every
dynamics family in this package (Dense/MLP stacks act on the feature
axis). Cross-sample coupling would silently corrupt the Jacobian columns.

State must be a single ndarray ``(dim,)`` or ``(batch, dim)`` (general
pytrees would need a flatten/unflatten of the coupled Jacobian; none of
the stiff use-cases need it).
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp

f32 = jnp.float32


import dataclasses


@dataclasses.dataclass(frozen=True)
class WMethodMeta:
    """Engine-facing metadata (the duck-typed subset of
    ``ExplicitRKTableau`` the adaptive engines read): ``order`` drives the
    PI controller and the Hairer initial-dt heuristic; ``num_stages - 1``
    counts the fresh f evaluations per trial step (2 here: the midpoint F1
    and the FSAL endpoint F2); ``fsal`` reflects that F2 seeds the next
    step's f0. Rosenbrock23 is L-stable, so its stability region is
    unbounded along the negative real axis — ``stability_size = inf``
    makes the stiffness regularizer's ``1/stability_size`` weight 0."""

    name: str = "rosenbrock23"
    order: int = 2
    num_stages: int = 3
    fsal: bool = True
    stability_size: float = float("inf")


ROSENBROCK23 = WMethodMeta()

#: d = 1/(2+sqrt(2)) — the W-method gamma of the ode23s pair.
_D = 1.0 / (2.0 + math.sqrt(2.0))
#: e32 = 6 + sqrt(2) — the third-stage combination constant.
_E32 = 6.0 + math.sqrt(2.0)


def _batched_jacobian(func: Callable, t, y: jnp.ndarray, args):
    """Per-sample Jacobian of ``func`` w.r.t. ``y``.

    ``(dim,)`` states use plain ``jacfwd``. ``(batch, dim)`` states push
    the ``dim`` basis tangents through the batched dynamics (one vmap of
    jvp = dim forward evaluations total), relying on per-sample
    independence; returns ``(batch, dim, dim)`` with ``J[b, i, k] =
    d f_i(y[b]) / d y_k``.
    """
    if y.ndim == 1:
        return jax.jacfwd(lambda yy: func(t, yy, args))(y)
    dim = y.shape[-1]
    eye = jnp.eye(dim, dtype=y.dtype)

    def col(e):
        return jax.jvp(
            lambda yy: func(t, yy, args), (y,),
            (jnp.broadcast_to(e, y.shape),))[1]

    cols = jax.vmap(col)(eye)  # (dim, batch, dim): cols[k, b, i]
    return jnp.moveaxis(cols, 0, -1)  # (batch, dim, dim)


def _time_derivative(func: Callable, t, y, args):
    """``dF/dt`` at fixed state — the W-method's non-autonomous term."""
    t = jnp.asarray(t)
    return jax.jvp(lambda tt: func(tt, y, args), (t,),
                   (jnp.ones_like(t),))[1]


def _matvec(J, v):
    return jnp.einsum("...ij,...j->...i", J, v)


def make_rosenbrock23_sweep(func: Callable) -> Callable:
    """Build a ``stage_sweep`` running one ode23s trial step.

    Per trial step: one Jacobian + one time-derivative jvp, one batched
    LU factorisation of ``W = I - d*h*J``, three triangular solves, and
    two fresh dynamics evaluations (F1 at the midpoint and the FSAL F2
    at the endpoint) — so the engines' ``(num_stages-1)*nsteps`` NFE
    accounting counts exactly the f evaluations, like OrdinaryDiffEq's
    ``nf`` (Jacobian work is tracked separately there as ``njacs``).

    Returns an ``ops.ode.EigenSweep``; ``eigen_est`` is a one-shot power
    probe ``rms(J f0) / rms(f0)`` (spectral-radius scale of the current
    Jacobian), which the Auto* composites use for switch-back decisions.
    """
    from regneuralde_tpu.ops.ode import EigenSweep

    def sweep(t, dt_eff, y, f0, args_):
        if not isinstance(y, jnp.ndarray) or y.ndim > 2:
            raise TypeError(
                "rosenbrock23 supports ndarray states of shape (dim,) or "
                "(batch, dim); got "
                + str(jax.tree_util.tree_structure(y)))
        J = _batched_jacobian(func, t, y, args_)
        T = _time_derivative(func, t, y, args_)
        hd = (dt_eff * _D).astype(y.dtype)
        eye = jnp.eye(y.shape[-1], dtype=y.dtype)
        W = eye - hd * J  # (…, dim, dim); hd is a scalar
        lu_piv = jax.scipy.linalg.lu_factor(W)

        def wsolve(b):
            return jax.scipy.linalg.lu_solve(lu_piv, b)

        hdT = hd * T
        k1 = wsolve(f0 + hdT)
        f1 = func(t + 0.5 * dt_eff, y + (0.5 * dt_eff) * k1, args_)
        k2 = wsolve(f1 - k1) + k1
        y_new = y + dt_eff * k2
        f2 = func(t + dt_eff, y_new, args_)
        k3 = wsolve(f2 - _E32 * (k2 - f1) - 2.0 * (k1 - f0) + hdT)
        err = (dt_eff / 6.0) * (k1 - 2.0 * k2 + k3)

        # Spectral-radius scale via the Gershgorin bound (max absolute row
        # sum of J, worst case over the batch). A Rayleigh quotient along
        # f0 would UNDER-estimate badly exactly when it matters: on a
        # stiff problem the trajectory derivative lives on the slow
        # manifold, nearly orthogonal to the fast eigenvectors (measured
        # 0.6 vs a true rho of 2.2e3 on Robertson). The Gershgorin bound
        # over-estimates by a small factor instead, which biases the Auto*
        # switch-back decision conservatively — the right direction.
        eigen = jnp.max(jnp.sum(jnp.abs(J), axis=-1))
        return EigenSweep(y_new=y_new, k_last=f2, err=err,
                          eigen_est=eigen.astype(f32))

    return sweep

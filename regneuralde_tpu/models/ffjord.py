"""FFJORD continuous normalizing flow on the owned solver core.

JAX counterpart of ``TrackedFFJORD`` (reference:
src/models/ffjord.jl). Matches behaviorally:

* Hutchinson trace estimator with ONE probe ``e ~ N(0, I)`` per solve
  (ffjord.jl:71); the ``e^T J`` product comes either from ``jax.vjp``
  (the reference's nested ``Tracker.forward`` pullback, ffjord.jl:22-27)
  or from a module-supplied analytic form (the ``dynamics=`` kwarg used by
  the CSL experiments, ffjord_tabular.jl:97-106 — here:
  ``CSLDynamics.forw_n_back``).
* Augmented state ``[z; logp]``, extended with the RNODE kinetic terms
  ``[.. ; int |f|^2 ; int |e^T J|^2]`` when ``kinetic_reg`` (ffjord.jl:57-59).
* The solver-heuristic (EEst*dt) regularizer needs no separate type
  parameter (reference's R=true variant, ffjord.jl:109-135): telemetry is
  always returned.
* ``logpx = logpz - delta_logp`` under a standard normal (ffjord.jl:103-104).
* ``sample`` integrates REVERSE time with an exact trace (explicit batched
  Jacobian, ffjord.jl:137-167) on the non-differentiable while fast path.

Arrays are batch-major ``(batch, dim)``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from regneuralde_tpu.ops import ODESolution, odeint
from regneuralde_tpu.ops.ode import StepTelemetry


class FFJORDOutput(NamedTuple):
    """Mirrors the reference's ``(logpx, lambda1, lambda2, nfe, sv)``
    (ffjord.jl:106)."""

    logpx: jnp.ndarray  # (batch,)
    kinetic: jnp.ndarray  # int |f|^2 per sample (zeros unless kinetic_reg)
    jacobian: jnp.ndarray  # int |e^T J|^2 per sample (zeros unless kinetic_reg)
    nfe: jnp.ndarray
    telemetry: StepTelemetry
    solution: ODESolution


class FFJORD:
    def __init__(
        self,
        dynamics: Any,
        input_dim: int,
        tspan: Tuple[float, float] = (0.0, 1.0),
        solver: str = "tsit5",
        rtol: float = 1.4e-8,
        atol: float = 1.4e-8,
        max_steps: int = 256,
        analytic_vjp: bool = True,
        axis_name: Optional[str] = None,
    ):
        """``dynamics`` is called as ``m(z, t)``. With ``analytic_vjp`` the
        module must expose ``forw_n_back(z, t, e) -> (f, eJ)`` (e.g.
        ``models.basic.CSLDynamics``); otherwise ``jax.vjp`` is used."""
        self.dynamics = dynamics
        self.input_dim = input_dim
        self.tspan = tspan
        self.solver = solver
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.analytic_vjp = analytic_vjp and hasattr(dynamics, "forw_n_back")
        self.axis_name = axis_name

    def init(self, key: jax.Array, x: jnp.ndarray) -> Any:
        t0 = jnp.asarray(self.tspan[0], jnp.float32)
        return self.dynamics.init(key, x, t0)

    def _forw_n_back(self, params, z, t, e):
        if self.analytic_vjp:
            return self.dynamics.apply(
                params, z, t, e, method=type(self.dynamics).forw_n_back
            )
        mz, vjp_fn = jax.vjp(lambda zz: self.dynamics.apply(params, zz, t), z)
        return mz, vjp_fn(e)[0]

    def _aug_dynamics(self, kinetic_reg: bool, e: jnp.ndarray):
        d = self.input_dim

        def func(t, u, params):
            z = u[:, :d]
            mz, eJ = self._forw_n_back(params, z, t, e)
            trace = jnp.sum(eJ * e, axis=-1, keepdims=True)
            if kinetic_reg:
                k1 = jnp.sum(jnp.square(mz), axis=-1, keepdims=True)
                k2 = jnp.sum(jnp.square(eJ), axis=-1, keepdims=True)
                return jnp.concatenate([mz, -trace, k1, k2], axis=-1)
            return jnp.concatenate([mz, -trace], axis=-1)

        return func

    def __call__(
        self,
        params: Any,
        x: jnp.ndarray,
        key: jax.Array,
        *,
        kinetic_reg: bool = False,
        e: Optional[jnp.ndarray] = None,
        mode: str = "adjoint",
    ) -> FFJORDOutput:
        batch = x.shape[0]
        if e is None:
            e = jax.random.normal(key, x.shape, x.dtype)
        n_aux = 3 if kinetic_reg else 1
        u0 = jnp.concatenate([x, jnp.zeros((batch, n_aux), x.dtype)], axis=-1)

        sol = odeint(
            self._aug_dynamics(kinetic_reg, e),
            u0,
            self.tspan[0],
            self.tspan[1],
            params,
            solver=self.solver,
            rtol=self.rtol,
            atol=self.atol,
            max_steps=self.max_steps,
            mode=mode,
            axis_name=self.axis_name,
        )
        return self._finish(sol, x, kinetic_reg)

    def _finish(self, sol, x, kinetic_reg: bool) -> FFJORDOutput:
        batch = x.shape[0]
        pred = sol.y1
        z = pred[:, : self.input_dim]
        delta_logp = pred[:, self.input_dim]
        if kinetic_reg:
            kinetic = pred[:, self.input_dim + 1]
            jacobian = pred[:, self.input_dim + 2]
        else:
            kinetic = jnp.zeros((batch,), x.dtype)
            jacobian = jnp.zeros((batch,), x.dtype)

        logpz = jnp.sum(
            -(math.log(2 * math.pi) + jnp.square(z)) / 2.0, axis=-1
        )
        logpx = logpz - delta_logp
        return FFJORDOutput(
            logpx=logpx,
            kinetic=kinetic,
            jacobian=jacobian,
            nfe=sol.stats.nfe,
            telemetry=sol.telemetry,
            solution=sol,
        )

    def _exact_trace_dynamics(self):
        d = self.input_dim

        def func(t, u, params):
            z = u[:, :d]

            def single(zi):
                return self.dynamics.apply(params, zi[None, :], t)[0]

            mz = self.dynamics.apply(params, z, t)
            jac = jax.vmap(jax.jacfwd(single))(z)  # (batch, d, d)
            trace = jnp.trace(jac, axis1=-2, axis2=-1)[:, None]
            return jnp.concatenate([mz, -trace], axis=-1)

        return func

    def sample(
        self,
        params: Any,
        key: jax.Array,
        nsamples: int,
        *,
        mode: str = "while",
    ) -> jnp.ndarray:
        """Draw samples by integrating base-space noise backwards through
        the flow with an exact trace (reference: ffjord.jl:160-167)."""
        z = jax.random.normal(key, (nsamples, self.input_dim))
        u0 = jnp.concatenate([z, jnp.zeros((nsamples, 1), z.dtype)], axis=-1)
        sol = odeint(
            self._exact_trace_dynamics(),
            u0,
            self.tspan[1],
            self.tspan[0],
            params,
            solver=self.solver,
            rtol=self.rtol,
            atol=self.atol,
            max_steps=self.max_steps,
            mode=mode,
        )
        return sol.y1[:, : self.input_dim]

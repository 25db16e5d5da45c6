"""NeuralODE layer: a dynamics module integrated by the owned solver core.

JAX counterpart of ``TrackedNeuralODE`` (reference:
src/models/neural_ode.jl). Differences by design:

* No destructure/rebuild closures — params are an explicit pytree argument
  (the reference's ``(m)(x, p)`` convention maps to ``model(params, x)``).
* No SavingCallback — the solver returns telemetry streams; regularizers
  are reductions over them (``regneuralde_tpu.reg``).
* The four R/Z type-parameter specializations (neural_ode.jl:48-180)
  collapse: telemetry always exists (free), and trajectory-vs-final output
  is decided by ``saveat``.
* Arrays are batch-major ``(batch, features)``; trajectories are
  ``(batch, time, features)`` (the reference's (feat, time, batch),
  transposed).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from regneuralde_tpu.models.nn import is_module
from regneuralde_tpu.ops import ODESolution, odeint
from regneuralde_tpu.ops.ode import StepTelemetry


class NeuralDEOutput(NamedTuple):
    """What the reference returns as ``(res, nfe, sv)``
    (neural_ode.jl:72-76), plus the full solution for power users."""

    value: jnp.ndarray  # final state or (batch, time, feat) trajectory
    nfe: jnp.ndarray
    telemetry: StepTelemetry
    solution: ODESolution


class NeuralODE:
    """du/dt = f(u, t; p), solved adaptively inside jit.

    Args:
      dynamics: a module with ``init``/``apply`` (``models.nn``; flax
        modules work too), applied as ``m(x, t)`` when ``time_dep`` else
        ``m(x)``; or a plain callable ``f(params, y[, t])`` whose
        parameters the caller manages (e.g. ``parallel.tp``).
      tspan: default (t0, t1) (reference: [0f0, 1f0]).
      time_dep: whether dynamics takes the solve time (reference:
        neural_ode.jl:55).
      solver/rtol/atol/max_steps: solver configuration (reference uses
        Tsit5 at rtol=atol=1.4e-8, experiments/mnist_node.jl:115-126).
      saveat: default save grid; if set, ``value`` is the trajectory.
    """

    def __init__(
        self,
        dynamics: Any,
        tspan: Tuple[float, float] = (0.0, 1.0),
        time_dep: bool = True,
        solver: str = "tsit5",
        rtol: float = 1.4e-8,
        atol: float = 1.4e-8,
        max_steps: int = 256,
        saveat: Optional[jnp.ndarray] = None,
        axis_name: Optional[str] = None,
        per_sample: bool = False,
        compensated_eest: bool = False,
    ):
        self.dynamics = dynamics
        self.tspan = tspan
        self.time_dep = time_dep
        self.solver = solver
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.saveat = saveat
        self.axis_name = axis_name
        # Double-f32 embedded-error estimate (ops.compensated): removes
        # the estimator's ARITHMETIC rounding noise at tight tolerances.
        # Shared-controller generic sweep only.
        if compensated_eest and per_sample:
            raise ValueError(
                "compensated_eest requires per_sample=False (generic "
                "sweep only)")
        self.compensated_eest = compensated_eest
        # Per-sample adaptive stepping (torchode-style): every batch
        # element gets its own PI controller and NFE count instead of the
        # reference's one-global-error-norm semantics (see
        # ops.per_sample). ``nfe`` becomes a (batch,) vector and telemetry
        # streams gain a leading batch axis; the reg reductions accept
        # both. axis_name needs no step sync in this mode (each sample is
        # independent), so it is simply not threaded into the solve.
        # per_sample may be True (vmap engine, full generality), or the
        # string "batched" (the per-lane-controller dense engine; see
        # ops.per_sample_batched).
        if per_sample not in (False, True, "batched"):
            raise ValueError(
                "per_sample must be False, True or 'batched', got "
                f"{per_sample!r}")
        self.per_sample = per_sample

    def init(self, key: jax.Array, x: jnp.ndarray) -> Any:
        if not is_module(self.dynamics):
            raise TypeError(
                "dynamics is a plain callable; its parameters are managed "
                "externally (e.g. parallel.tp.make_tp_dynamics) — pass them "
                "directly to __call__"
            )
        t0 = jnp.asarray(self.tspan[0], jnp.float32)
        if self.time_dep:
            return self.dynamics.init(key, x, t0)
        return self.dynamics.init(key, x)

    def _func(self, t, y, p):
        if not is_module(self.dynamics):
            # Plain-callable dynamics: f(params, y, t) / f(params, y) —
            # the tensor-parallel path (parallel.tp) and other externally
            # parameterized dynamics plug in here.
            if self.time_dep:
                return self.dynamics(p, y, t)
            return self.dynamics(p, y)
        if self.time_dep:
            return self.dynamics.apply(p, y, t)
        return self.dynamics.apply(p, y)

    def __call__(
        self,
        params: Any,
        x: jnp.ndarray,
        *,
        tspan: Optional[Tuple] = None,
        saveat: Optional[jnp.ndarray] = None,
        mode: str = "adjoint",
    ) -> NeuralDEOutput:
        t0, t1 = tspan if tspan is not None else self.tspan
        saveat = saveat if saveat is not None else self.saveat

        if self.per_sample:
            from regneuralde_tpu.ops import odeint_per_sample

            sol = odeint_per_sample(
                self._func, x, t0, t1, params,
                engine=("batched" if self.per_sample == "batched"
                        else "vmap"),
                solver=self.solver, rtol=self.rtol, atol=self.atol,
                max_steps=self.max_steps, saveat=saveat, mode=mode,
            )
            value = (jnp.swapaxes(sol.ys, 0, 1)
                     if saveat is not None else sol.y1)
            return NeuralDEOutput(
                value=value, nfe=sol.stats.nfe,
                telemetry=sol.telemetry, solution=sol,
            )

        sol = odeint(
            self._func,
            x,
            t0,
            t1,
            params,
            solver=self.solver,
            rtol=self.rtol,
            atol=self.atol,
            max_steps=self.max_steps,
            saveat=saveat,
            mode=mode,
            axis_name=self.axis_name,
            compensated_eest=self.compensated_eest,
        )
        if saveat is not None:
            # (time, batch, feat) -> (batch, time, feat)
            value = jnp.swapaxes(sol.ys, 0, 1)
        else:
            value = sol.y1
        return NeuralDEOutput(
            value=value, nfe=sol.stats.nfe, telemetry=sol.telemetry, solution=sol
        )

"""NeuralSDE layer: drift + diagonal-diffusion modules over the SDE core.

JAX counterpart of ``TrackedNeuralDSDE`` (reference:
src/models/neural_sde.jl). The reference concatenates both nets' params
into one flat vector split at ``len`` (neural_sde.jl:17,38) and counts NFE
with mutable closure counters (neural_sde.jl:46,50); here params are a
``{"drift", "diffusion"}`` pytree and the counters fall out of the solver's
step accounting. Unlike the reference — whose SDE path is pinned to CPU
arrays (neural_sde.jl:57, experiments/mnist_nsde.jl:11-13) — this runs on
the accelerator like everything else.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from regneuralde_tpu.ops import SDESolution, sdeint
from regneuralde_tpu.ops.ode import StepTelemetry


class NeuralSDEOutput(NamedTuple):
    """Mirrors the reference's ``(arr, nfe1, nfe2, sv)``
    (neural_sde.jl:61)."""

    value: jnp.ndarray
    nfe1: jnp.ndarray  # drift evaluations
    nfe2: jnp.ndarray  # diffusion evaluations
    telemetry: StepTelemetry
    solution: SDESolution


class NeuralSDE:
    """du = f(u;p) dt + g(u;p) dW (diagonal noise), solved adaptively.

    The reference's models are time-independent (neural_sde.jl:45-51);
    ``time_dep`` is provided for generality.
    """

    def __init__(
        self,
        drift: Any,
        diffusion: Any,
        tspan: Tuple[float, float] = (0.0, 1.0),
        time_dep: bool = False,
        solver: str = "sosri",
        rtol: float = 1.4e-1,
        atol: float = 1.4e-1,
        max_steps: int = 256,
        saveat: Optional[jnp.ndarray] = None,
        axis_name: Optional[str] = None,
        per_sample: bool = False,
    ):
        self.drift = drift
        self.diffusion = diffusion
        self.tspan = tspan
        self.time_dep = time_dep
        self.solver = solver
        self.rtol = rtol
        self.atol = atol
        self.max_steps = max_steps
        self.saveat = saveat
        self.axis_name = axis_name
        # Per-sample adaptive stepping: each batch element (each MC
        # trajectory, after the classifier fan-out) gets its own
        # controller AND its own independently-bridged Brownian path —
        # see ops.per_sample.sdeint_per_sample. nfe1/nfe2 become (batch,)
        # vectors. axis_name needs no step sync in this mode and is not
        # threaded into the solve.
        # per_sample may be True (vmap engine, full generality) or the
        # string "batched" (the per-lane-controller dense engine —
        # ops.per_sample_sde_batched; 2-D states, collapse bridge).
        if per_sample not in (False, True, "batched"):
            raise ValueError(
                "per_sample must be False, True or 'batched', got "
                f"{per_sample!r}")
        self.per_sample = per_sample

    def init(self, key: jax.Array, x: jnp.ndarray) -> Any:
        k1, k2 = jax.random.split(key)
        if self.time_dep:
            t0 = jnp.asarray(self.tspan[0], jnp.float32)
            return {
                "drift": self.drift.init(k1, x, t0),
                "diffusion": self.diffusion.init(k2, x, t0),
            }
        return {"drift": self.drift.init(k1, x), "diffusion": self.diffusion.init(k2, x)}

    def _drift(self, t, y, p):
        if self.time_dep:
            return self.drift.apply(p["drift"], y, t)
        return self.drift.apply(p["drift"], y)

    def _diffusion(self, t, y, p):
        if self.time_dep:
            return self.diffusion.apply(p["diffusion"], y, t)
        return self.diffusion.apply(p["diffusion"], y)

    def __call__(
        self,
        params: Any,
        x: jnp.ndarray,
        key: jax.Array,
        *,
        tspan: Optional[Tuple] = None,
        saveat: Optional[jnp.ndarray] = None,
        mode: str = "adjoint",
        brownian: str = "collapse",
    ) -> NeuralSDEOutput:
        t0, t1 = tspan if tspan is not None else self.tspan
        saveat = saveat if saveat is not None else self.saveat

        if self.per_sample:
            from regneuralde_tpu.ops import sdeint_per_sample

            sol = sdeint_per_sample(
                self._drift, self._diffusion, x, t0, t1, params,
                key=key, solver=self.solver, rtol=self.rtol,
                atol=self.atol, max_steps=self.max_steps, saveat=saveat,
                mode=mode, brownian=brownian,
                engine=("batched" if self.per_sample == "batched"
                        else "vmap"),
            )
            value = (jnp.swapaxes(sol.ys, 0, 1)
                     if saveat is not None else sol.y1)
            return NeuralSDEOutput(
                value=value, nfe1=sol.stats.nfe1, nfe2=sol.stats.nfe2,
                telemetry=sol.telemetry, solution=sol,
            )

        sol = sdeint(
            self._drift,
            self._diffusion,
            x,
            t0,
            t1,
            params,
            key=key,
            solver=self.solver,
            rtol=self.rtol,
            atol=self.atol,
            max_steps=self.max_steps,
            saveat=saveat,
            mode=mode,
            axis_name=self.axis_name,
            brownian=brownian,
        )
        if saveat is not None:
            value = jnp.swapaxes(sol.ys, 0, 1)  # (batch, time, feat)
        else:
            value = sol.y1
        return NeuralSDEOutput(
            value=value,
            nfe1=sol.stats.nfe1,
            nfe2=sol.stats.nfe2,
            telemetry=sol.telemetry,
            solution=sol,
        )

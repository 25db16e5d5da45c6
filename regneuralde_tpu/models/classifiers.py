"""Composite classifiers: pre-net -> neural DE core -> post-net.

JAX counterparts of ``ClassifierNODE`` / ``ClassifierNSDE``
(reference: src/models/supervised_classification.jl). Params are an
explicit ``{"pre", "de", "post"}`` pytree — the analogue of the
reference's ``Flux.trainable(m) = (m.p1, m.p2, m.p3)`` convention
(supervised_classification.jl:32,80).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from regneuralde_tpu.models.neural_ode import NeuralODE
from regneuralde_tpu.models.neural_sde import NeuralSDE
from regneuralde_tpu.ops.ode import StepTelemetry


class ClassifierNODEOutput(NamedTuple):
    logits: jnp.ndarray
    nfe: jnp.ndarray
    telemetry: StepTelemetry
    success: jnp.ndarray  # solver reached t1 within max_steps


class ClassifierNODE:
    """Reference: supervised_classification.jl:2-46. ``pre`` and ``post``
    are modules with ``init``/``apply`` (``models.nn``); ``node`` is a
    NeuralODE."""

    def __init__(self, pre: Optional[Any], node: NeuralODE, post: Any):
        self.pre = pre
        self.node = node
        self.post = post

    def init(self, key: jax.Array, x: jnp.ndarray) -> Any:
        k1, k2, k3 = jax.random.split(key, 3)
        h = x
        params = {}
        if self.pre is not None:
            params["pre"] = self.pre.init(k1, h)
            h = self.pre.apply(params["pre"], h)
        params["de"] = self.node.init(k2, h)
        out = self.node(params["de"], h, mode="while")
        params["post"] = self.post.init(k3, out.value)
        return params

    def __call__(self, params: Any, x: jnp.ndarray, **node_kwargs) -> ClassifierNODEOutput:
        h = self.pre.apply(params["pre"], x) if self.pre is not None else x
        out = self.node(params["de"], h, **node_kwargs)
        logits = self.post.apply(params["post"], out.value)
        return ClassifierNODEOutput(
            logits=logits, nfe=out.nfe, telemetry=out.telemetry,
            success=out.solution.stats.success,
        )


class ClassifierNSDEOutput(NamedTuple):
    logits: jnp.ndarray
    nfe1: jnp.ndarray
    nfe2: jnp.ndarray
    telemetry: StepTelemetry
    success: jnp.ndarray  # solver reached t1 within max_steps


class ClassifierNSDE:
    """Reference: supervised_classification.jl:50-100. Monte-Carlo
    trajectory fan-out: the batch is tiled ``trajectories`` times, solved
    as one big SDE state, and post-net outputs are averaged over the
    trajectory axis (supervised_classification.jl:92-99)."""

    def __init__(self, pre: Optional[Any], nsde: NeuralSDE, post: Any):
        self.pre = pre
        self.nsde = nsde
        self.post = post

    def init(self, key: jax.Array, x: jnp.ndarray) -> Any:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        h = x
        params = {}
        if self.pre is not None:
            params["pre"] = self.pre.init(k1, h)
            h = self.pre.apply(params["pre"], h)
        params["de"] = self.nsde.init(k2, h)
        out = self.nsde(params["de"], h, k4, mode="while")
        params["post"] = self.post.init(k3, out.value)
        return params

    def __call__(
        self,
        params: Any,
        x: jnp.ndarray,
        key: jax.Array,
        *,
        trajectories: int = 1,
        **nsde_kwargs,
    ) -> ClassifierNSDEOutput:
        bsize = x.shape[0]
        x = jnp.tile(x, (trajectories,) + (1,) * (x.ndim - 1))
        h = self.pre.apply(params["pre"], x) if self.pre is not None else x
        out = self.nsde(params["de"], h, key, **nsde_kwargs)
        z = self.post.apply(params["post"], out.value)
        z = jnp.mean(z.reshape((trajectories, bsize) + z.shape[1:]), axis=0)
        return ClassifierNSDEOutput(
            logits=z, nfe1=out.nfe1, nfe2=out.nfe2, telemetry=out.telemetry,
            success=out.solution.stats.success,
        )

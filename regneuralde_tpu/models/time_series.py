"""Latent ODE: VAE-over-dynamics for irregular time series.

JAX counterpart of ``LatentTimeSeriesModel`` (reference:
src/models/time_series.jl): a recurrent encoder consumes the observation
sequence (backwards in time), an MLP maps to (mu0, logvar) of the initial
latent, a reparameterized sample is decoded by a Neural ODE at the
requested timestamps, and a per-timestep linear decoder maps back to
observation space.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp

from regneuralde_tpu.models.neural_ode import NeuralODE
from regneuralde_tpu.ops.ode import StepTelemetry


class LatentTimeSeriesOutput(NamedTuple):
    """Mirrors the reference's ``(result, mu0, logvar, nfe, sv)``
    (time_series.jl:69)."""

    result: jnp.ndarray  # (batch, time, obs_dim)
    mu0: jnp.ndarray
    logvar: jnp.ndarray
    nfe: jnp.ndarray
    telemetry: StepTelemetry
    success: jnp.ndarray  # solver reached t1 within max_steps


class LatentTimeSeriesModel:
    """rnn -> enc -> reparameterize -> NeuralODE(saveat) -> dec.

    ``rnn`` consumes (batch, time, feat) and returns (batch, 2*latent_rnn);
    ``enc`` maps that to (batch, 2*latent_ode); ``dec`` maps latent states
    to observations. Reference: time_series.jl:40-70.
    """

    def __init__(self, rnn: Any, enc: Any, node: NeuralODE, dec: Any):
        self.rnn = rnn
        self.enc = enc
        self.node = node
        self.dec = dec

    def init(self, key: jax.Array, x: jnp.ndarray) -> Any:
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        p_rnn = self.rnn.init(k1, x)
        h = self.rnn.apply(p_rnn, x)
        p_enc = self.enc.init(k2, h)
        out = self.enc.apply(p_enc, h)
        latent = out.shape[-1] // 2
        z0 = out[:, :latent]
        p_node = self.node.init(k3, z0)
        node_out = self.node(p_node, z0, mode="while")
        zs = node_out.value
        p_dec = self.dec.init(k4, zs.reshape((-1, zs.shape[-1])))
        return {"rnn": p_rnn, "enc": p_enc, "de": p_node, "dec": p_dec}

    def __call__(
        self,
        params: Any,
        x: jnp.ndarray,
        key: jax.Array,
        *,
        saveat: Optional[jnp.ndarray] = None,
        tspan=None,
        mode: str = "adjoint",
    ) -> LatentTimeSeriesOutput:
        h = self.rnn.apply(params["rnn"], x)
        out = self.enc.apply(params["enc"], h)
        latent = out.shape[-1] // 2
        mu0 = out[:, :latent]
        logvar = out[:, latent:]

        # Reparameterized sample (reference: time_series.jl:58-59).
        eps = jax.random.normal(key, mu0.shape, mu0.dtype)
        z0 = eps * jnp.exp(logvar / 2.0) + mu0

        node_out = self.node(params["de"], z0, saveat=saveat, tspan=tspan, mode=mode)
        zs = node_out.value  # (batch, time, latent)
        b, t, d = zs.shape
        decoded = self.dec.apply(params["dec"], zs.reshape((b * t, d)))
        result = decoded.reshape((b, t, -1))
        return LatentTimeSeriesOutput(
            result=result,
            mu0=mu0,
            logvar=logvar,
            nfe=node_out.nfe,
            telemetry=node_out.telemetry,
            success=node_out.solution.stats.success,
        )

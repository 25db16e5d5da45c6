"""Dynamics networks and small building blocks (``models.nn`` modules).

Equivalents of the reference's Flux modules:

* ``TDChain`` / ``MLPDynamics`` — time-dependent MLPs that concatenate the
  scalar solve time ``t`` (broadcast to a row) onto the input of every
  layer (reference: src/models/basic.jl:16-28 and the MNIST dynamics at
  experiments/mnist_node.jl:41-54).
* ``ConcatSquashLinear`` / ``CSLDynamics`` — the gated FFJORD dynamics
  (reference: experiments/ffjord_tabular.jl:48-106), including an analytic
  vector-Jacobian product used by the Hutchinson trace estimator.
* ``RecognitionRNN`` — Elman encoder for latent-ODE style models
  (reference: src/models/basic.jl:43-58).
* ``LatentGRU`` — the masked GRU-Bayes cell run backwards in time over
  irregular observations (reference: experiments/latent_ode.jl:39-99),
  implemented as a ``lax.scan`` over a cell.

Array convention: JAX-native batch-major ``(batch, features)`` (the
reference is Julia column-major ``(features, batch)`` — transposed, same
math). Time-major sequences are ``(batch, time, features)``.

Parameter trees keep flax.linen's layout (``{"params": {name: {"kernel",
"bias"}}}``, scanned cells under ``"cell"``), see ``models.nn``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from regneuralde_tpu.models.nn import Dense, Module


def _t_row(x: jnp.ndarray, t) -> jnp.ndarray:
    """Broadcast time to a (batch, 1) column for concatenation.

    The reference builds this with ``CUDA.ones(1, B) .* t`` to stay
    on-device and on-tape (src/models/basic.jl:25-28); in JAX broadcasting
    a traced scalar does both for free. A ``(batch,)`` time vector (the
    per-lane-controller engine advances every sample at its OWN t) maps
    to one column entry per row.
    """
    t = jnp.asarray(t, x.dtype)
    if t.ndim == 1:
        return t[:, None]
    return jnp.broadcast_to(t, (x.shape[0], 1))


@dataclasses.dataclass(eq=False)
class TDChain(Module):
    """Chain of Dense layers, each consuming ``concat([h, t])``.

    Reference: src/models/basic.jl:16-28 (``applytdchain``).
    """

    features: Sequence[int]
    activation: Callable = jnp.tanh
    final_activation: bool = True

    def _act(self, i, h):
        if i < len(self.features) - 1 or self.final_activation:
            return self.activation(h)
        return h

    def _init(self, key, x, t):
        keys = jax.random.split(key, len(self.features))
        params = {}
        h = x
        for i, (f, k) in enumerate(zip(self.features, keys)):
            params[f"dense_{i}"], h = Dense(f)._init(
                k, jnp.concatenate([h, _t_row(h, t)], -1))
            h = self._act(i, h)
        return params, h

    def _apply(self, p, x, t):
        h = x
        for i, f in enumerate(self.features):
            h = Dense(f)._apply(p[f"dense_{i}"],
                                jnp.concatenate([h, _t_row(h, t)], -1))
            h = self._act(i, h)
        return h


@dataclasses.dataclass(eq=False)
class MLPDynamics(Module):
    """The MNIST Neural-ODE dynamics: 784 -> (+t) 100 tanh -> (+t) 784 tanh.

    Reference: experiments/mnist_node.jl:41-54. Uses ``ops.math.tanh``, the
    exp-based tanh whose accuracy on the card is recorded in ops/math.py:
    the activation's error is the floor of the solver's embedded error
    estimate at tight tolerances.
    """

    dim: int = 784
    hidden: int = 100

    def _init(self, key, x, t):
        k1, k2 = jax.random.split(key)
        p1, _ = Dense(self.hidden)._init(
            k1, jnp.concatenate([x, _t_row(x, t)], -1))
        h = self._hidden(p1, x, t)
        p2, _ = Dense(self.dim)._init(
            k2, jnp.concatenate([h, _t_row(h, t)], -1))
        p = {"dense_1": p1, "dense_2": p2}
        return p, self._apply(p, x, t)

    def _hidden(self, p1, x, t):
        from regneuralde_tpu.ops.math import tanh

        return tanh(Dense(self.hidden)._apply(
            p1, jnp.concatenate([x, _t_row(x, t)], -1)))

    def _apply(self, p, x, t):
        from regneuralde_tpu.ops.math import tanh

        h = self._hidden(p["dense_1"], x, t)
        return tanh(Dense(self.dim)._apply(
            p["dense_2"], jnp.concatenate([h, _t_row(h, t)], -1)))


@dataclasses.dataclass(eq=False)
class MLP(Module):
    """Plain Dense chain (no time input); used for drift/diffusion nets and
    encoders/decoders. ``activation`` applies between layers; the output
    layer is linear unless ``final_activation`` is set."""

    features: Sequence[int]
    activation: Callable = jnp.tanh
    final_activation: Optional[Callable] = None

    def _between(self, i, h):
        if i < len(self.features) - 1:
            return self.activation(h)
        if self.final_activation is not None:
            return self.final_activation(h)
        return h

    def _init(self, key, x):
        keys = jax.random.split(key, len(self.features))
        params = {}
        h = x
        for i, (f, k) in enumerate(zip(self.features, keys)):
            params[f"dense_{i}"], h = Dense(f)._init(k, h)
            h = self._between(i, h)
        return params, h

    def _apply(self, p, x):
        h = x
        for i, f in enumerate(self.features):
            h = self._between(i, Dense(f)._apply(p[f"dense_{i}"], h))
        return h


@dataclasses.dataclass(eq=False)
class AlternatingMLP(Module):
    """tanh -> (Dense(d,h) tanh -> Dense(h,d) tanh) * depth.

    The latent-ODE generative dynamics (reference:
    experiments/latent_ode.jl:113-126): an initial pointwise ``tanh`` then
    eight alternating Dense(20<->50, tanh) layers.
    """

    dim: int = 20
    hidden: int = 50
    depth: int = 4

    def _init(self, key, x):
        keys = jax.random.split(key, 2 * self.depth)
        params = {}
        h = jnp.tanh(x)
        for i in range(self.depth):
            params[f"up_{i}"], h = Dense(self.hidden)._init(keys[2 * i], h)
            h = jnp.tanh(h)
            params[f"down_{i}"], h = Dense(self.dim)._init(
                keys[2 * i + 1], h)
            h = jnp.tanh(h)
        return params, h

    def _apply(self, p, x):
        h = jnp.tanh(x)
        for i in range(self.depth):
            h = jnp.tanh(Dense(self.hidden)._apply(p[f"up_{i}"], h))
            h = jnp.tanh(Dense(self.dim)._apply(p[f"down_{i}"], h))
        return h


@dataclasses.dataclass(eq=False)
class ConcatSquashLinear(Module):
    """``(W x + b) * sigmoid(w_g t) + (w_b t + b_b)`` — FFJORD's CSL layer.

    Reference: experiments/ffjord_tabular.jl:48-76.
    """

    features: int

    def _init(self, key, x, t):
        k1, k2, k3 = jax.random.split(key, 3)
        t_arr = jnp.reshape(jnp.asarray(t, x.dtype), (1, 1))
        p = {
            "layer": Dense(self.features)._init(k1, x)[0],
            "gate": Dense(self.features, use_bias=False)._init(k2, t_arr)[0],
            "bias": Dense(self.features)._init(k3, t_arr)[0],
        }
        return p, self._apply(p, x, t)

    def _apply(self, p, x, t):
        lin = Dense(self.features)._apply(p["layer"], x)
        t_arr = jnp.reshape(jnp.asarray(t, x.dtype), (1, 1))
        gate = jax.nn.sigmoid(
            Dense(self.features, use_bias=False)._apply(p["gate"], t_arr))
        bias = Dense(self.features)._apply(p["bias"], t_arr)
        return lin * gate + bias


@dataclasses.dataclass(eq=False)
class CSLDynamics(Module):
    """Three CSL layers with softplus activations — the FFJORD dynamics for
    the gaussian/tabular experiments (reference:
    experiments/ffjord_tabular.jl:78-106, ffjord_gaussian.jl:48-106).

    ``forw_n_back`` computes the analytic e^T J product the reference
    hand-derives (ffjord_tabular.jl:97-106); it is also recoverable with
    ``jax.vjp``, but the closed form avoids a nested AD trace inside the
    solver loop. Call it as ``apply(variables, x, t, e,
    method=CSLDynamics.forw_n_back)``.
    """

    dim: int
    hidden: int = 100

    def _layers(self):
        return (("csl1", ConcatSquashLinear(self.hidden)),
                ("csl2", ConcatSquashLinear(self.hidden)),
                ("csl3", ConcatSquashLinear(self.dim)))

    def _init(self, key, x, t):
        keys = jax.random.split(key, 3)
        params = {}
        h = x
        for i, ((name, csl), k) in enumerate(zip(self._layers(), keys)):
            params[name], h = csl._init(k, h, t)
            if i < 2:
                h = jax.nn.softplus(h)
        return params, h

    def _apply(self, p, x, t):
        (n1, c1), (n2, c2), (n3, c3) = self._layers()
        h = jax.nn.softplus(c1._apply(p[n1], x, t))
        h = jax.nn.softplus(c2._apply(p[n2], h, t))
        return c3._apply(p[n3], h, t)

    def forw_n_back(self, params, x: jnp.ndarray, t, e: jnp.ndarray):
        """Forward value and analytic ``e^T J`` in one pass.

        Returns ``(f(x,t), eJ)`` with ``eJ`` shaped like ``x``. Uses the
        chain of per-layer transposed-Jacobian products; the gate factors
        are diagonal so each backward hop is ``(W * gate)^T @ v`` with the
        softplus derivative ``sigmoid(z)`` applied between hops.
        """

        def layer_fwd(p, h, t_arr):
            W = p["layer"]["kernel"]  # (in, out)
            b = p["layer"]["bias"]
            Wg = p["gate"]["kernel"]  # (1, out)
            Wb = p["bias"]["kernel"]
            bb = p["bias"]["bias"]
            gate = jax.nn.sigmoid(t_arr * Wg)  # (1, out)
            z = h @ W + b
            out = z * gate + (t_arr * Wb + bb)
            back = lambda v: v @ (W * gate).T  # (batch,out)@(out,in)
            return z, out, back

        t_arr = jnp.reshape(jnp.asarray(t, x.dtype), (1, 1))
        z1, o1, back1 = layer_fwd(params["csl1"], x, t_arr)
        h1 = jax.nn.softplus(o1)
        z2, o2, back2 = layer_fwd(params["csl2"], h1, t_arr)
        h2 = jax.nn.softplus(o2)
        z3, o3, back3 = layer_fwd(params["csl3"], h2, t_arr)

        v = back3(e)
        v = back2(v * jax.nn.sigmoid(o2))
        v = back1(v * jax.nn.sigmoid(o1))
        return o3, v


def _scan_reversed(cell_apply, carry0, xs):
    """Run ``cell_apply(carry, x_t) -> carry`` over a (batch, time, feat)
    sequence backwards in time; returns the final carry."""
    xs_rev = jnp.flip(jnp.swapaxes(xs, 0, 1), axis=0)  # (time, batch, feat)
    carry, _ = lax.scan(lambda c, x: (cell_apply(c, x), None), carry0, xs_rev)
    return carry


@dataclasses.dataclass(eq=False)
class RecognitionRNN(Module):
    """Elman cell encoder: ``h' = tanh(W [x; h])``, output ``2*latent_dim``.

    Reference: src/models/basic.jl:43-58. Runs the cell over a
    (batch, time, feat) sequence *backwards* (latent-ODE encoders consume
    the series in reverse) via ``lax.scan`` and returns the final output.
    Parameters: ``{"cell": {"i2h": ...}, "h2o": ...}``.
    """

    latent_dim: int
    hidden: int

    def _h0(self, xs):
        return jnp.zeros((xs.shape[0], self.hidden), xs.dtype)

    def _cell(self, p, h, x):
        return jnp.tanh(Dense(self.hidden)._apply(
            p["i2h"], jnp.concatenate([x, h], -1)))

    def _init(self, key, xs):
        k1, k2 = jax.random.split(key)
        h0 = self._h0(xs)
        i2h, _ = Dense(self.hidden)._init(
            k1, jnp.concatenate([xs[:, -1], h0], -1))
        cell = {"i2h": i2h}
        h = _scan_reversed(lambda c, x: self._cell(cell, c, x), h0, xs)
        h2o, out = Dense(2 * self.latent_dim)._init(k2, h)
        return {"cell": cell, "h2o": h2o}, out

    def _apply(self, p, xs):
        h = _scan_reversed(lambda c, x: self._cell(p["cell"], c, x),
                           self._h0(xs), xs)
        return Dense(2 * self.latent_dim)._apply(p["h2o"], h)


@dataclasses.dataclass(eq=False)
class LatentGRU(Module):
    """Masked GRU-Bayes cell over irregular series, run backwards in time.

    The input at each step is ``concat([data, mask, delta_t])``; steps whose
    mask rows are all zero leave the state untouched (reference:
    experiments/latent_ode.jl:64-99). Returns ``concat([y_mean, y_std])``
    of shape (batch, 2 * latent_dim). Parameters: ``{"cell":
    {"update_gate", "reset_gate", "new_state"}}``, each an ``MLP``.
    """

    in_dim: int
    hidden: int
    latent_dim: int

    def _gates(self):
        return (
            ("update_gate", MLP((self.hidden, self.latent_dim),
                                activation=jnp.tanh,
                                final_activation=jax.nn.sigmoid)),
            ("reset_gate", MLP((self.hidden, self.latent_dim),
                               activation=jnp.tanh,
                               final_activation=jax.nn.sigmoid)),
            ("new_state", MLP((self.hidden, 2 * self.latent_dim),
                              activation=jnp.tanh)),
        )

    def _cell(self, p, carry, x):
        (_, ug), (_, rg), (_, ns_mlp) = self._gates()
        y_mean, y_std = carry
        y_concat = jnp.concatenate([y_mean, y_std, x], -1)
        u = ug._apply(p["update_gate"], y_concat)
        r = rg._apply(p["reset_gate"], y_concat)
        concat = jnp.concatenate([y_mean * r, y_std * r, x], -1)
        ns = ns_mlp._apply(p["new_state"], concat)
        n_mean = ns[:, : self.latent_dim]
        n_std = ns[:, self.latent_dim :]  # treated as log sigma^2
        ym = (1 - u) * n_mean + u * y_mean
        ys = (1 - u) * n_std + u * y_std
        # Observation mask: rows of x beyond the data block (the mask
        # block); unobserved steps freeze the state.
        mask = (
            jnp.sum(x[:, self.in_dim : 2 * self.in_dim], axis=-1, keepdims=True)
            > 0
        ).astype(x.dtype)
        ym = mask * ym + (1 - mask) * y_mean
        ys = mask * ys + (1 - mask) * y_std
        return ym, ys

    def _y0(self, xs):
        return jnp.zeros((xs.shape[0], self.latent_dim), xs.dtype)

    def _init(self, key, xs):
        y0 = self._y0(xs)
        y_concat = jnp.concatenate([y0, y0, xs[:, -1]], -1)
        keys = jax.random.split(key, 3)
        cell = {name: mlp._init(k, y_concat)[0]
                for (name, mlp), k in zip(self._gates(), keys)}
        p = {"cell": cell}
        return p, self._apply(p, xs)

    def _apply(self, p, xs):
        # xs: (batch, time, 2*in_dim + 1)
        y0 = self._y0(xs)
        y_mean, y_std = _scan_reversed(
            lambda c, x: self._cell(p["cell"], c, x), (y0, y0), xs)
        return jnp.concatenate([y_mean, y_std], -1)

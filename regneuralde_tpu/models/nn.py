"""A minimal module layer: explicit parameter pytrees, no framework.

Every module exposes ``init(key, *args) -> variables`` and
``apply(variables, *args, method=None)``. ``variables`` is
``{"params": tree}`` where ``tree`` nests ``{name: {"kernel", "bias"}}``
per layer — the layout flax.linen uses, so checkpoints and the code that
reads parameter leaves by name (``CSLDynamics.forw_n_back``,
``parallel.tp``) see the same tree, and a flax module passed where a
module is expected works unchanged (the model layer only duck-types
``init``/``apply``).

Subclasses implement two functions on the inner tree:

* ``_init(key, *args) -> (params, out)`` — build this module's parameters
  from example inputs and return the forward value too, so a parent can
  size its next layer from it (what flax's shape inference does);
* ``_apply(params, *args)`` — the forward pass.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def is_module(obj: Any) -> bool:
    """Whether ``obj`` follows the ``init``/``apply`` module protocol
    (this layer's modules and flax modules alike), as opposed to a plain
    callable dynamics whose parameters are managed by the caller."""
    return callable(getattr(obj, "init", None)) and callable(
        getattr(obj, "apply", None))


class Module:
    """Base class: the ``{"params": ...}`` wrapping around ``_init`` and
    ``_apply``. ``method`` mirrors flax's ``apply(..., method=fn)``: ``fn``
    is called as ``fn(self, params, *args)``."""

    def init(self, key: jax.Array, *args) -> dict:
        params, _ = self._init(key, *args)
        return {"params": params}

    def apply(self, variables: dict, *args, method: Optional[Callable] = None):
        params = variables["params"]
        if method is None:
            return self._apply(params, *args)
        return method(self, params, *args)

    def _init(self, key: jax.Array, *args):
        raise NotImplementedError

    def _apply(self, params, *args):
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class Dense(Module):
    """``x @ kernel + bias`` over the last axis. Initializers are flax's
    defaults: LeCun-normal kernel (truncated normal, variance 1/fan_in),
    zero bias; parameters are float32 whatever the input dtype."""

    features: int
    use_bias: bool = True

    def _init(self, key, x):
        p = {"kernel": _lecun_normal(key, (x.shape[-1], self.features),
                                     jnp.float32)}
        if self.use_bias:
            p["bias"] = jnp.zeros((self.features,), jnp.float32)
        return p, self._apply(p, x)

    def _apply(self, p, x):
        y = jnp.matmul(x, p["kernel"])
        if self.use_bias:
            y = y + p["bias"]
        return y

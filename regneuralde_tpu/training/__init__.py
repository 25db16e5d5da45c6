"""Training harness: optimizers, config, checkpointing, train-state."""

from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from regneuralde_tpu.training.checkpoint import Checkpointer
from regneuralde_tpu.training.config import load_config, make_run_dir, save_yaml
from regneuralde_tpu.training.optimizers import (
    ffjord_optimizer,
    inv_decay,
    latent_ode_optimizer,
    make_optimizer,
    mnist_node_optimizer,
    mnist_nsde_optimizer,
    momentum_sgd,
    sde_toy_optimizer,
)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


def create_train_state(params: Any, optimizer: optax.GradientTransformation) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def make_train_step(
    loss_fn: Callable,
    optimizer: optax.GradientTransformation,
    has_aux: bool = True,
    donate: bool = True,
    nan_guard: bool = False,
) -> Callable:
    """Jit-compiled ``(state, *batch) -> (state, loss, aux)``.

    ``loss_fn(params, *batch)`` returns ``loss`` or ``(loss, aux)``. This
    replaces the reference's per-batch Tracker.gradient +
    update_parameters! + tape-reset + GC dance
    (experiments/mnist_node.jl:229-237, src/utils.jl:148-156) with one
    jitted XLA program.

    ``nan_guard``: skip the whole update (params AND optimizer state)
    when any gradient entry is non-finite — the enabled version of the
    reference's commented-out NaN abort (src/utils.jl:152), but as a
    step-skip instead of a crash; aux gains ``grads_finite``.
    """
    step = _make_step_body(loss_fn, optimizer, has_aux, nan_guard)
    return jax.jit(step, donate_argnums=(0,) if donate else ())


def _make_step_body(loss_fn, optimizer, has_aux, nan_guard):
    """The un-jitted ``(state, *batch) -> (state, loss, aux)`` body shared
    by ``make_train_step`` (one dispatch per batch) and
    ``make_multi_step`` (K batches per dispatch)."""
    grad_fn = jax.value_and_grad(loss_fn, has_aux=has_aux)

    def step(state: TrainState, *batch):
        if has_aux:
            (loss, aux), grads = grad_fn(state.params, *batch)
        else:
            loss, grads = grad_fn(state.params, *batch)
            aux = None
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        if nan_guard:
            finite = jnp.all(jnp.stack([
                jnp.all(jnp.isfinite(g)) for g in jax.tree_util.tree_leaves(grads)
            ]))
            params = jax.tree_util.tree_map(
                lambda new, old: jnp.where(finite, new, old), params, state.params
            )
            opt_state = jax.tree_util.tree_map(
                lambda new, old: jnp.where(finite, new, old),
                opt_state, state.opt_state,
            )
            if has_aux and isinstance(aux, dict):
                aux = dict(aux, grads_finite=finite)
            else:
                aux = (aux, finite)
        return TrainState(params, opt_state, state.step + 1), loss, aux

    return step


def make_multi_step(
    loss_fn: Callable,
    optimizer: optax.GradientTransformation,
    has_aux: bool = True,
    donate: bool = True,
    nan_guard: bool = False,
) -> Callable:
    """Jit-compiled ``(state, *stacked) -> (state, losses, auxs)`` running
    K train steps per dispatch via ``lax.scan``.

    Each argument in ``stacked`` carries a leading ``K`` axis (K batches,
    or K per-step scalars like an annealed lambda); step ``i`` consumes
    slice ``i`` of every argument. Semantically identical to K sequential
    ``make_train_step`` calls — same gradients, same optimizer chain, same
    NaN-guard per step — but the host dispatches ONE XLA program, which
    matters when per-call dispatch latency rivals the step's device time.
    The reference has no analogue (its Julia loop is host-driven per
    batch, experiments/mnist_node.jl:229-237); this is a framework
    capability the XLA compilation model makes natural.

    Returns per-step ``losses`` of shape ``(K,)`` and stacked ``auxs``.
    """
    from jax import lax

    step = _make_step_body(loss_fn, optimizer, has_aux, nan_guard)

    def multi(state: TrainState, *stacked):
        def body(st, sl):
            st2, loss, aux = step(st, *sl)
            return st2, (loss, aux)

        state2, (losses, auxs) = lax.scan(body, state, stacked)
        return state2, losses, auxs

    return jax.jit(multi, donate_argnums=(0,) if donate else ())


__all__ = [
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_multi_step",
    "Checkpointer",
    "load_config",
    "save_yaml",
    "make_run_dir",
    "make_optimizer",
    "inv_decay",
    "momentum_sgd",
    "mnist_node_optimizer",
    "latent_ode_optimizer",
    "mnist_nsde_optimizer",
    "ffjord_optimizer",
    "sde_toy_optimizer",
]

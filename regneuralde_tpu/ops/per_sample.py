"""Per-sample adaptive stepping (torchode-style), as one XLA program.

The reference — and this package's default — treats the whole minibatch as
ONE ODE state with a single global error norm (reference:
src/models/neural_ode.jl:62 solves the batched state through one
integrator), so one hard sample forces small steps on everyone and the
solve reports one NFE for the batch. Per-sample mode instead gives every
batch element its own PI controller: its own error norm, dt sequence,
accept/reject decisions, telemetry rows, and NFE count.

Mapping: the solve is ``jax.vmap`` of the single-sample solve. Under
vmap,

* ``lax.scan`` (mode="scan") stays one bounded loop over ``max_steps``
  with per-lane live masks, and
* ``lax.while_loop`` (mode="while" and the custom-vjp "adjoint" engine)
  becomes a batch-synchronized masked loop: XLA iterates while ANY lane is
  unfinished and masks out finished lanes.

Either way the whole batch advances in lockstep iterations of fully
batched stage sweeps (the dynamics still sees full batched matmuls every
iteration), so this stays compiler-friendly: no dynamic shapes, no
per-sample Python loops. Wall-clock per solve is set by the slowest
sample; the win over global control is *accounting and accuracy* — easy
samples take few, large steps (their per-sample NFE is honest, not
inflated by the batch's worst case) and each sample is integrated exactly
to its own tolerance instead of to a batch-RMS compromise.

Each vmap lane carries a singleton batch axis (leaves ``(1, ...)`` per
lane), so batched dynamics modules — which expect ``(batch, features)``
inputs and broadcast the scalar solve time to a row (models.basic._t_row)
— run unchanged.

Not supported here (both are global-batch concepts): ``axis_name`` step
synchronization (per-sample control is already shard-local — under data
parallelism simply shard the batch; no cross-device step sync is needed
or wanted) and custom ``stage_sweep`` hooks (they compute one shared
error norm for the whole batch).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from regneuralde_tpu.ops.ode import ODESolution, odeint

Pytree = Any

__all__ = ["odeint_per_sample", "sdeint_per_sample"]


def _check_batch(y0) -> int:
    leaves = jax.tree_util.tree_leaves(y0)
    if not leaves:
        raise ValueError("y0 has no array leaves")
    batch = leaves[0].shape[0] if leaves[0].ndim else None
    if batch is None or any(
        l.ndim == 0 or l.shape[0] != batch for l in leaves
    ):
        raise ValueError(
            "per-sample mode needs every y0 leaf to carry the sample axis "
            f"first; got shapes {[l.shape for l in leaves]}"
        )
    return batch


def _check_tspan(name, arr, batch):
    if arr.ndim not in (0, 1) or (arr.ndim == 1 and arr.shape[0] != batch):
        raise ValueError(
            f"{name} must be a scalar or a ({batch},) per-sample array;"
            f" got shape {arr.shape}"
        )


def _reject_global_kwargs(kwargs):
    for key in ("axis_name", "stage_sweep"):
        if kwargs.get(key) is not None:
            raise ValueError(
                f"per-sample solves do not accept {key!r}: per-sample "
                "step control is shard-local by construction and custom "
                "sweeps assume one shared controller"
            )
        kwargs.pop(key, None)


def _split_saveat(kwargs, batch):
    """Pop ``saveat`` and classify it: ``None``, a shared ``(n_save,)``
    grid, or a per-sample ``(batch, n_save)`` grid (each sample decoded at
    its OWN timestamps — e.g. each physionet series' observation stamps;
    the reference forces sample 1's grid on the whole batch,
    experiments/latent_ode.jl:137). Returns ``(saveat, vmap_axis)``."""
    sa = kwargs.pop("saveat", None)
    if sa is None:
        return None, None
    sa = jnp.asarray(sa)
    if sa.ndim == 1:
        return sa, None
    if sa.ndim == 2 and sa.shape[0] == batch:
        return sa, 0
    raise ValueError(
        "saveat must be a shared (n_save,) grid or a per-sample "
        f"({batch}, n_save) grid; got shape {sa.shape}"
    )


def odeint_per_sample(
    func: Callable[[Any, Pytree, Any], Pytree],
    y0: Pytree,
    t0,
    t1,
    args: Any = None,
    engine: str = "vmap",
    **kwargs,
) -> ODESolution:
    """Integrate every batch element under its own adaptive controller.

    Args:
      func: batched dynamics ``f(t, y, args) -> dy`` — the same callable
        ``odeint`` takes; each vmap lane calls it on a batch of one.
      y0: pytree whose leaves all carry the sample axis first,
        ``(batch, ...)``.
      t0, t1: scalars, or ``(batch,)`` arrays for per-sample time spans
        (e.g. per-sample STEER jitter of ``t1`` — the reference jitters
        one shared ``t1`` per minibatch, experiments/mnist_node.jl:133).
      args: shared across samples (model parameters).
      **kwargs: forwarded to :func:`odeint` (solver, rtol/atol, dt0,
        max_steps, saveat, controller, mode, remat). ``saveat`` may be a
        shared sorted ``(n_save,)`` grid or a per-sample ``(batch,
        n_save)`` grid (each row sorted) — the latter decodes every
        sample at its OWN timestamps (e.g. each physionet series'
        observation stamps; the reference forces sample 1's grid on the
        whole batch, experiments/latent_ode.jl:137), and ``sol.ts`` is
        then ``(batch, n_save)``. ``axis_name`` / ``stage_sweep`` are
        rejected (see module docstring).

    Returns:
      An :class:`ODESolution` whose array conventions match the batched
      solve — ``y1`` leaves ``(batch, ...)``, ``ys`` leaves
      ``(len(saveat), batch, ...)`` — but whose ``stats`` fields are
      per-sample ``(batch,)`` vectors (``stats.nfe[i]`` is sample *i*'s
      honest evaluation count; compare reference src/models/neural_ode.jl:72
      where ``destats.nf`` is one number for the whole batch) and whose
      ``telemetry`` streams are ``(batch, max_steps)``. The ``reg``
      reductions accept these unchanged (masked over both axes).
    """
    _reject_global_kwargs(kwargs)
    batch = _check_batch(y0)
    saveat, sa_axis = _split_saveat(kwargs, batch)

    if engine == "batched":
        # Per-lane-controller engine: same semantics, one dense batched
        # program (no vmap'd per-lane buffer updates — 11-14x faster on
        # the flagship shape, see ops.per_sample_batched). 2-D states
        # run directly; pytree states flatten to one dense (batch, D)
        # state (exact — see _odeint_batched_pytree). saveat (shared or
        # per-sample grids) is a dense masked Hermite write.
        from regneuralde_tpu.ops.per_sample_batched import (
            odeint_per_sample_batched,
        )

        mode = kwargs.pop("mode", None)
        if mode == "while":
            # The batched adjoint forward IS the early-exit while loop;
            # it just also carries a hand-written backward.
            mode = "adjoint"
        mode = mode or "adjoint"
        if hasattr(y0, "ndim") and y0.ndim == 2:
            return odeint_per_sample_batched(func, y0, t0, t1, args,
                                             mode=mode,
                                             saveat=saveat, **kwargs)
        # Pytree states ride the engine through a flatten adapter
        # (round 5): every leaf reshapes to (batch, -1) and concatenates
        # into ONE dense (batch, D) state. Exact in exact arithmetic —
        # the per-lane error scale is ELEMENTWISE
        # (atol + max(|y0|,|y1|)*rtol, ops.norms.error_ratio) and the
        # per-lane norm is an rms over ALL the lane's elements, both of
        # which commute with concatenation. In f32 the summation ORDER
        # differs (vmap sums leaf-by-leaf; the adapter reduces one row),
        # so a borderline accept can flip and move a lane by one trial
        # step (tests/test_per_sample.py::TestBatchedPytreeState).
        return _odeint_batched_pytree(func, y0, t0, t1, args, batch,
                                      mode=mode, saveat=saveat, **kwargs)
    if engine != "vmap":
        raise ValueError(f"engine must be 'vmap' or 'batched', got "
                         f"{engine!r}")

    # Each lane keeps a singleton batch axis so batched dynamics modules
    # (which concatenate time rows, run (batch, feat) matmuls, ...) work
    # without a per-sample variant.
    y0_lanes = jax.tree_util.tree_map(lambda l: l[:, None], y0)

    t0a = jnp.asarray(t0)
    t1a = jnp.asarray(t1)
    _check_tspan("t0", t0a, batch)
    _check_tspan("t1", t1a, batch)

    def solve_one(y0_one, t0_one, t1_one, sa_one):
        return odeint(func, y0_one, t0_one, t1_one, args, saveat=sa_one,
                      **kwargs)

    sol = jax.vmap(
        solve_one,
        in_axes=(0, 0 if t0a.ndim else None, 0 if t1a.ndim else None,
                 sa_axis),
    )(y0_lanes, t0a, t1a, saveat)

    y1 = jax.tree_util.tree_map(lambda l: jnp.squeeze(l, 1), sol.y1)
    ys = None
    ts = None
    if sol.ys is not None:
        # lane ys: (n_save, 1, ...) -> stacked (batch, n_save, 1, ...)
        # -> the batched convention (n_save, batch, ...).
        ys = jax.tree_util.tree_map(
            lambda l: jnp.moveaxis(jnp.squeeze(l, 2), 0, 1), sol.ys
        )
        # Shared grid: vmap stacked the same row per lane — report one.
        # Per-sample grid: report the full (batch, n_save) stamps.
        ts = sol.ts[0] if sa_axis is None else sol.ts
    return ODESolution(y1=y1, ys=ys, ts=ts, stats=sol.stats,
                       telemetry=sol.telemetry)


def _odeint_batched_pytree(func, y0, t0, t1, args, batch, *, mode,
                           saveat, **kwargs):
    """Run a pytree state through the batched per-lane engine by
    flattening it to one dense ``(batch, D)`` array (see the call site
    for why this preserves the vmap engine's step sequence exactly).

    Leaves must share one floating dtype (mixed-dtype states keep the
    vmap engine — a concatenated state would silently promote)."""
    from regneuralde_tpu.ops.per_sample_batched import (
        odeint_per_sample_batched,
    )

    leaves, treedef = jax.tree_util.tree_flatten(y0)
    shapes = [l.shape for l in leaves]
    dtypes = {l.dtype for l in leaves}
    if len(dtypes) > 1:
        raise ValueError(
            "engine='batched' pytree states need one common leaf dtype, "
            f"got {sorted(str(d) for d in dtypes)}; use engine='vmap' "
            "for mixed-dtype states")
    sizes = [int(np.prod(s[1:], dtype=np.int64)) for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)])

    def ravel(tree):
        ls = treedef.flatten_up_to(tree)
        return jnp.concatenate(
            [l.reshape(batch, -1) for l in ls], axis=1)

    def unravel(flat):
        # flat: (..., batch, D) with any number of leading axes (none
        # for y1, n_save for ys).
        lead = flat.shape[:-1]
        parts = [
            flat[..., offsets[i]:offsets[i + 1]].reshape(
                *lead, *shapes[i][1:])
            for i in range(len(shapes))
        ]
        return treedef.unflatten(parts)

    def func_flat(t, y_flat, a):
        return ravel(func(t, unravel(y_flat), a))

    sol = odeint_per_sample_batched(func_flat, ravel(y0), t0, t1, args,
                                    mode=mode, saveat=saveat, **kwargs)
    ys = None if sol.ys is None else unravel(sol.ys)
    return ODESolution(y1=unravel(sol.y1), ys=ys, ts=sol.ts,
                       stats=sol.stats, telemetry=sol.telemetry)


def sdeint_per_sample(
    drift: Callable[[Any, Pytree, Any], Pytree],
    diffusion: Callable[[Any, Pytree, Any], Pytree],
    y0: Pytree,
    t0,
    t1,
    args: Any = None,
    *,
    key: jax.Array,
    engine: str = "vmap",
    **kwargs,
) -> "SDESolution":
    """Per-sample adaptive SDE stepping (see :func:`odeint_per_sample`).

    Every batch element gets its own PI controller, error norm,
    accept/reject sequence, AND its own independent Brownian path — the
    rejection bridge (tail collapse or the RSwM3 segment stack) operates
    per sample, so one sample's rejection never perturbs another sample's
    Wiener increments. This matters most for Monte-Carlo trajectory
    fan-out (the reference tiles the batch ``trajectories×``,
    src/models/supervised_classification.jl:92): under global control one
    unlucky trajectory forces small steps on the whole fan-out; here each
    trajectory steps at its own pace.

    ``key`` is split once per sample; lane *i* reproduces
    ``sdeint(..., key=jax.random.split(key, batch)[i])`` on that sample
    alone, draw for draw. ``stats`` fields are per-sample ``(batch,)``
    vectors; ``telemetry`` streams are ``(batch, max_steps)``.
    """
    # Imported lazily: ops/__init__ keeps the SDE core optional for
    # ODE-only consumers (see the import-order note there).
    from regneuralde_tpu.ops.sde import SDESolution, sdeint

    _reject_global_kwargs(kwargs)
    batch = _check_batch(y0)
    saveat, sa_axis = _split_saveat(kwargs, batch)

    if engine == "batched":
        # Per-lane-controller dense engine (per_sample_sde_batched): the
        # same per-lane semantics AND per-lane Brownian paths without
        # vmap's per-lane buffer-update cost class. Scoped to single
        # 2-D states and the collapse bridge scheme.
        from regneuralde_tpu.ops.per_sample_sde_batched import (
            sdeint_per_sample_batched,
        )

        if not (hasattr(y0, "ndim") and y0.ndim == 2):
            raise ValueError(
                "engine='batched' needs a bare 2-D (batch, dim) state "
                "array; use engine='vmap' for pytree states")
        mode = kwargs.pop("mode", None)
        if mode == "while":
            mode = "adjoint"  # the batched adjoint IS the early-exit loop
        return sdeint_per_sample_batched(
            drift, diffusion, y0, t0, t1, args, key=key,
            mode=mode or "adjoint", saveat=saveat, **kwargs)
    if engine != "vmap":
        raise ValueError(f"engine must be 'vmap' or 'batched', got "
                         f"{engine!r}")

    y0_lanes = jax.tree_util.tree_map(lambda l: l[:, None], y0)
    t0a = jnp.asarray(t0)
    t1a = jnp.asarray(t1)
    _check_tspan("t0", t0a, batch)
    _check_tspan("t1", t1a, batch)
    keys = jax.random.split(key, batch)

    def solve_one(y0_one, t0_one, t1_one, key_one, sa_one):
        return sdeint(drift, diffusion, y0_one, t0_one, t1_one, args,
                      key=key_one, saveat=sa_one, **kwargs)

    sol = jax.vmap(
        solve_one,
        in_axes=(0, 0 if t0a.ndim else None, 0 if t1a.ndim else None, 0,
                 sa_axis),
    )(y0_lanes, t0a, t1a, keys, saveat)

    y1 = jax.tree_util.tree_map(lambda l: jnp.squeeze(l, 1), sol.y1)
    ys = None
    ts = None
    if sol.ys is not None:
        ys = jax.tree_util.tree_map(
            lambda l: jnp.moveaxis(jnp.squeeze(l, 2), 0, 1), sol.ys
        )
        ts = sol.ts[0] if sa_axis is None else sol.ts
    return SDESolution(y1=y1, ys=ys, ts=ts, stats=sol.stats,
                       telemetry=sol.telemetry)

"""Adaptive SDE integration (diagonal noise) as a single XLA program.

The reference solves neural SDEs with ``StochasticDiffEq.SOSRI`` — an
adaptive, stability-optimized strong-order-1.5 SRI method with
rejection-safe Brownian bridging — and harvests ``EEst * dt`` per accepted
step via ``SavingCallback`` while counting drift/diffusion evaluations with
manual closure counters (reference: src/models/neural_sde.jl:44-114,
experiments/mnist_nsde.jl:45-65). This module provides the XLA
equivalents:

* ``solver="sosri" | "sosri2" | "sriw1"``: tableau-driven SRI methods
  (strong order 1.5, diagonal noise) from ``ops.sri`` — the
  stability-optimized SOSRI-opt/SOSRI2-opt tableaus (derived in
  tools/derive_sosri.py; the counterparts of StochasticDiffEq's
  SOSRI/SOSRI2) and Rößler's SRIW1 — with the natural-embedding error
  estimate (Rackauckas & Nie 2017) ``E = delta*dt*sum(e_drift_i f_i) +
  (I10/dt)*sum(e_noise_i g_i)`` driving a PI step controller.
* ``solver="em"``: fixed-step Euler-Maruyama over a uniform grid of
  ``max_steps`` steps (the baseline / test method).
* **Brownian path under rejection**: a counter-based (split-per-step) RNG
  drives the increments; on step rejection the sampled increment over the
  attempted interval is committed as a "tail" and the retry samples a
  Brownian-bridge point inside it. On acceptance mid-tail the remainder is
  carried forward. Nested-rejection interior points are collapsed into the
  remaining tail (an RSwM1-style simplification: interior values only ever
  entered rejected trial computations).
* NFE accounting: per-trial-step drift/diffusion evaluation counts come
  from the tableau's static stage analysis (``nfe1``/``nfe2``, mirroring
  the reference's manual counters) — 2+4 for SRIW1, 4+4 for SOSRI-opt.

The solve is one bounded ``lax.scan`` with masks (differentiable — the
discrete adjoint through accepted and rejected steps, like the reference's
Tracker tape) or a ``lax.while_loop`` fast path, exactly as in ``ops.ode``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from regneuralde_tpu.ops.controller import PIController
from regneuralde_tpu.ops.norms import (
    error_ratio,
    hairer_norm,
    tree_sub,
    tree_where,
)
from regneuralde_tpu.ops.ode import StepTelemetry
from regneuralde_tpu.ops.sri import (
    TABLEAUS,
    diffusion_evals_per_step,
    drift_evals_per_step,
    get_tableau,
    sri_step,
)

Pytree = Any

_SQRT3 = math.sqrt(3.0)


class SDEStats(NamedTuple):
    nfe1: jnp.ndarray  # drift evaluations (reference: neural_sde.jl:46)
    nfe2: jnp.ndarray  # diffusion evaluations (reference: neural_sde.jl:50)
    naccept: jnp.ndarray
    nreject: jnp.ndarray
    success: jnp.ndarray


class SDESolution(NamedTuple):
    y1: Pytree
    ys: Optional[Pytree]
    ts: Optional[jnp.ndarray]
    stats: SDEStats
    telemetry: StepTelemetry


class _Tail(NamedTuple):
    h: jnp.ndarray  # committed horizon length ahead of t (0 = no tail)
    w: Pytree  # Brownian increment over [t, t+h]
    z: Pytree  # auxiliary increment (for the I10 integral) over [t, t+h]


class _Carry(NamedTuple):
    t: jnp.ndarray
    dt: jnp.ndarray
    qold: jnp.ndarray
    y: Pytree
    done: jnp.ndarray
    step: jnp.ndarray
    naccept: jnp.ndarray
    nreject: jnp.ndarray
    key: jax.Array
    tail: _Tail
    ys_buf: Optional[Pytree]


def _normal_like(key: jax.Array, tree: Pytree) -> Pytree:
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(key, len(leaves))
    out = [jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
    return jax.tree_util.tree_unflatten(treedef, out)


def presample_noise(key: jax.Array, shape, dtype, max_steps: int):
    """The (xi_w, xi_z) N(0,1) draws :func:`sdeint` would make, one
    pair per trial step, reproducing its exact key chain
    (``split(carry.key)`` -> ``split(sub)`` -> ``_normal_like``'s
    per-leaf split). Shape ``(max_steps,) + shape`` each.

    Only the (scalar-cheap) key chain is sequential; the actual sampling
    is one vmapped batch, so no per-step ``normal`` call sits in a loop."""

    def chain(k, _):
        k_next, sub = jax.random.split(k)
        return k_next, sub

    _, subs = lax.scan(chain, key, None, length=max_steps)

    def draw(sub):
        kw, kz = jax.random.split(sub)
        xw = jax.random.normal(jax.random.split(kw, 1)[0], shape, dtype)
        xz = jax.random.normal(jax.random.split(kz, 1)[0], shape, dtype)
        return xw, xz

    return jax.vmap(draw)(subs)


def _tree_fma(a: Pytree, s, b: Pytree) -> Pytree:
    """a + s * b, leafwise (s scalar)."""
    return jax.tree_util.tree_map(lambda x, y: x + s * y, a, b)


def _sample_increment(key, tail: _Tail, dt):
    """Draw (dW, dZ) over [t, t+dt] conditioned on the committed tail.

    Returns (dW, dZ, tail_if_accepted, tail_if_rejected).
    """
    kw, kz = jax.random.split(key)
    xi_w = _normal_like(kw, tail.w)
    xi_z = _normal_like(kz, tail.z)

    h = tail.h
    safe_h = jnp.maximum(h, 1e-30)
    inside = dt < h
    frac = jnp.where(inside, dt / safe_h, 1.0)
    var = jnp.where(inside, dt * (h - dt) / safe_h, jnp.maximum(dt - h, 0.0))
    # Zero-guarded sqrt (sqrt'(0) = inf poisons the backward): var hits
    # exactly 0 when a step consumes the committed tail exactly — e.g. a
    # rejected is_last trial leaves a tail reaching t1, and the accepted
    # retry's final step spans the remainder (dt == h). Same double-where
    # pattern as ops.norms.hairer_norm.
    var = jnp.maximum(var, 0.0)
    std = jnp.where(var > 0, jnp.sqrt(jnp.where(var > 0, var, 1.0)), 0.0)

    def draw(tail_leaf, xi_leaf):
        return frac * tail_leaf + std * xi_leaf

    dw = jax.tree_util.tree_map(draw, tail.w, xi_w)
    dz = jax.tree_util.tree_map(draw, tail.z, xi_z)

    rem_w = jax.tree_util.tree_map(
        lambda tl, d: jnp.where(inside, tl - d, jnp.zeros_like(d)), tail.w, dw
    )
    rem_z = jax.tree_util.tree_map(
        lambda tl, d: jnp.where(inside, tl - d, jnp.zeros_like(d)), tail.z, dz
    )
    tail_acc = _Tail(h=jnp.where(inside, h - dt, 0.0), w=rem_w, z=rem_z)
    tail_rej = _Tail(h=dt, w=dw, z=dz)
    return dw, dz, tail_acc, tail_rej


class _TailStack(NamedTuple):
    """RSwM3-class committed-segment stack (Rackauckas & Nie 2017; the
    scheme StochasticDiffEq's adaptive solvers default to — the
    reference's SOSRI path inherits it). Time-ordered segments ahead of
    ``t``: slot 0 is nearest; ``h[j] == 0`` marks an empty slot and
    empties always form a suffix (their w/z are zero so masked sums are
    safe). Unlike the single-``_Tail`` collapse scheme, a rejection
    inside a committed segment SPLITS it instead of discarding the
    remainder, so every previously observed Brownian value stays
    binding for the rest of the solve (up to the static depth K; on
    overflow the two FARTHEST segments merge — the graceful degradation
    back toward the collapse scheme, farthest-first because near
    segments are the ones a shrinking dt will touch)."""

    h: jnp.ndarray  # (K,)
    w: Pytree  # leaves (K,) + leaf.shape
    z: Pytree


def _stack_zeros(y0: Pytree, depth: int, time_dtype) -> _TailStack:
    zl = lambda l: jnp.zeros((depth,) + l.shape, l.dtype)
    return _TailStack(
        h=jnp.zeros((depth,), time_dtype),
        w=jax.tree_util.tree_map(zl, y0),
        z=jax.tree_util.tree_map(zl, y0),
    )


def _sample_increment_stack(key, st: _TailStack, dt):
    """Draw (dW, dZ) over [t, t+dt] conditioned on ALL committed
    segments. Consumes exactly one (xi_w, xi_z) pair — same RNG chain as
    the collapse scheme — because at most one fresh value is ever
    needed per trial step: the bridge point inside the (single) segment
    containing t+dt, or the free extension beyond all segments.

    Returns (dW, dZ, stack_if_accepted, stack_if_rejected).
    """
    kw, kz = jax.random.split(key)
    take0 = lambda tree: jax.tree_util.tree_map(lambda l: l[0], tree)
    # Drawn at LEAF shape with the same keys as the collapse scheme, so
    # solves whose rejections never land inside a committed segment (the
    # only case where the schemes differ) are bitwise identical.
    xi_w0 = _normal_like(kw, take0(st.w))
    xi_z0 = _normal_like(kz, take0(st.z))

    K = st.h.shape[0]
    h = st.h
    tiny = jnp.asarray(1e-30, h.dtype)
    ends = jnp.cumsum(h)
    starts = ends - h
    covered = ends[-1]
    nonempty = h > 0

    # coef[j]: fraction of segment j's increment inside [0, dt] —
    # clip((dt - start)/len, 0, 1) is 1 for consumed, delta/L for the
    # split segment, 0 beyond.
    coef = jnp.clip((dt - starts) / jnp.maximum(h, tiny), 0.0, 1.0)
    coef = jnp.where(nonempty, coef, 0.0)
    is_split = nonempty & (starts < dt) & (dt < ends)
    any_split = jnp.any(is_split)
    # Split-segment geometry (zeros when no split).
    delta = jnp.sum(jnp.where(is_split, dt - starts, 0.0))
    L = jnp.sum(jnp.where(is_split, h, 0.0))
    var_split = delta * jnp.maximum(L - delta, 0.0) / jnp.maximum(L, tiny)
    var_ext = jnp.maximum(dt - covered, 0.0)
    # Zero-guarded sqrt — see _sample_increment: var is exactly 0 when a
    # step lands exactly on a segment boundary (var_ext == 0 with
    # dt == covered, or a degenerate split), and sqrt'(0) = inf would
    # poison the backward through the controller's dt chain.
    var = jnp.where(any_split, var_split, var_ext)
    std = jnp.where(var > 0, jnp.sqrt(jnp.where(var > 0, var, 1.0)), 0.0)

    def combine(seg_leaf, xi_leaf):
        c = coef.reshape((K,) + (1,) * (seg_leaf.ndim - 1)).astype(
            seg_leaf.dtype)
        return jnp.sum(c * seg_leaf, axis=0) + std.astype(
            seg_leaf.dtype) * xi_leaf

    dw = jax.tree_util.tree_map(combine, st.w, xi_w0)
    dz = jax.tree_util.tree_map(combine, st.z, xi_z0)

    idx = jnp.arange(K)
    n_full = jnp.sum((ends <= dt) & nonempty).astype(jnp.int32)
    n_seg = jnp.sum(nonempty).astype(jnp.int32)
    frac = delta / jnp.maximum(L, tiny)

    # ---- accepted: consume [0, dt]; the split remainder becomes slot 0,
    # untouched beyond-segments shift down by n_full.
    def roll0(l, s):
        return jnp.roll(l, -s, axis=0)

    h_acc = roll0(h, n_full)
    wrap = idx >= (K - n_full)  # rolled-around entries are dead
    h_acc = jnp.where(wrap, 0.0, h_acc)
    # slot 0 after the roll is the split segment (when one exists):
    # replace by its remainder [dt, end).
    at0 = idx == 0
    h_acc = jnp.where(at0 & any_split, jnp.maximum(L - delta, 0.0), h_acc)

    def acc_leaf(seg_leaf, xi0_leaf):
        r = roll0(seg_leaf, n_full)
        shp = (K,) + (1,) * (seg_leaf.ndim - 1)
        dead = wrap.reshape(shp)
        r = jnp.where(dead, 0.0, r)
        # remainder of the split segment: (1-frac)*w - std*xi
        rem = ((1.0 - frac).astype(seg_leaf.dtype) * r[0]
               - std.astype(seg_leaf.dtype) * xi0_leaf)
        sel0 = (at0 & any_split).reshape(shp)
        return jnp.where(sel0, rem[None], r)

    w_acc = jax.tree_util.tree_map(acc_leaf, st.w, xi_w0)
    z_acc = jax.tree_util.tree_map(acc_leaf, st.z, xi_z0)
    st_acc = _TailStack(h=h_acc.astype(h.dtype), w=w_acc, z=z_acc)

    # ---- rejected: t does not advance; the freshly observed value is
    # COMMITTED by refining the stack. Split case: segment j becomes
    # ([start, dt] drawn part, [dt, end] remainder) — insert, shifting
    # later slots up. Extension case: append ([covered, dt], std*xi).
    # Overflow: pre-merge the two FARTHEST segments (they never contain
    # the split point for K >= 2: the split segment lies before them).
    need_merge = n_seg >= K
    lastv = jnp.maximum(n_seg - 1, 0)
    prevv = jnp.maximum(n_seg - 2, 0)
    hm = h.at[prevv].add(h[lastv]).at[lastv].set(0.0)
    merge_leaf = lambda l: l.at[prevv].add(l[lastv]).at[lastv].set(
        jnp.zeros_like(l[lastv]))
    pick = lambda a, b: jax.tree_util.tree_map(
        lambda x, y: jnp.where(need_merge, x, y), a, b)
    h_r = jnp.where(need_merge, hm, h)
    w_r = pick(jax.tree_util.tree_map(merge_leaf, st.w), st.w)
    z_r = pick(jax.tree_util.tree_map(merge_leaf, st.z), st.z)
    n_seg_r = jnp.where(need_merge, n_seg - 1, n_seg)
    # Geometry on the (possibly merged) stack. The merge preserves both
    # the total covered horizon and every boundary before the two
    # farthest slots, so the split segment and its offsets are intact.
    ends_r = jnp.cumsum(h_r)
    starts_r = ends_r - h_r
    is_split_r = (h_r > 0) & (starts_r < dt) & (dt < ends_r)
    j_ins = jnp.where(
        any_split,
        jnp.sum(jnp.where(is_split_r, idx, 0)).astype(jnp.int32),
        n_seg_r.astype(jnp.int32),
    )
    d_r = jnp.where(
        any_split,
        dt - jnp.sum(jnp.where(is_split_r, starts_r, 0.0)),
        dt - covered,
    )
    L_r = jnp.where(any_split, jnp.sum(jnp.where(is_split_r, h_r, 0.0)),
                    dt - covered)
    frac_r = jnp.where(any_split, d_r / jnp.maximum(L_r, tiny), 1.0)

    src = jnp.where(idx <= j_ins, idx, idx - 1)
    h_rej = h_r[src]
    h_rej = jnp.where(idx == j_ins, jnp.maximum(d_r, 0.0), h_rej)
    h_rej = jnp.where(idx == j_ins + 1,
                      jnp.where(any_split,
                                jnp.maximum(L_r - d_r, 0.0), 0.0), h_rej)

    def rej_leaf(seg_leaf, xi0_leaf):
        g = jnp.take(seg_leaf, src, axis=0)
        shp = (K,) + (1,) * (seg_leaf.ndim - 1)
        segj = jnp.sum(
            jnp.where(is_split_r.reshape(shp), seg_leaf, 0.0), axis=0)
        drawn = (jnp.where(any_split, frac_r, 0.0).astype(seg_leaf.dtype)
                 * segj + std.astype(seg_leaf.dtype) * xi0_leaf)
        rem = segj - drawn
        g = jnp.where((idx == j_ins).reshape(shp), drawn[None], g)
        g = jnp.where((idx == j_ins + 1).reshape(shp),
                      jnp.where(any_split, rem[None],
                                jnp.zeros_like(rem)[None]), g)
        return g

    w_rej = jax.tree_util.tree_map(rej_leaf, w_r, xi_w0)
    z_rej = jax.tree_util.tree_map(rej_leaf, z_r, xi_z0)
    st_rej = _TailStack(h=h_rej.astype(h.dtype), w=w_rej, z=z_rej)
    return dw, dz, st_acc, st_rej


def sdeint(
    drift: Callable[[Any, Pytree, Any], Pytree],
    diffusion: Callable[[Any, Pytree, Any], Pytree],
    y0: Pytree,
    t0,
    t1,
    args: Any = None,
    *,
    key: jax.Array,
    solver: str = "sosri",
    rtol: float = 1e-2,
    atol: float = 1e-2,
    dt0: Optional[float] = None,
    max_steps: int = 256,
    saveat: Optional[jnp.ndarray] = None,
    controller: Optional[PIController] = None,
    mode: str = "scan",
    remat: bool = True,
    axis_name: Optional[str] = None,
    matmul_precision: Optional[str] = "highest",
    brownian: str = "collapse",
    brownian_depth: int = 8,
    _bwd_precision: Optional[str] = None,
) -> SDESolution:
    """Integrate ``dy = drift dt + diffusion dW`` (diagonal noise).

    ``key`` seeds the counter-based Brownian path (one split per trial
    step). The minibatch is one SDE state with one global error norm, as in
    the reference; Monte-Carlo trajectory fan-out is done by the caller by
    tiling the batch axis (reference: src/models/supervised_classification.jl:92).
    ``matmul_precision``: see ``odeint`` — keeps reduced-precision (TF32
    on the GPU) matmul noise out of the embedded error estimate.

    ``brownian``: rejection-bridge bookkeeping. ``"collapse"`` (default)
    keeps ONE committed tail and discards the remainder on an
    inside-tail rejection (an RSwM1-style simplification — a small
    adaptivity-path bias when rejections nest). ``"stack"`` keeps a
    depth-``brownian_depth`` segment stack (the RSwM3 scheme
    StochasticDiffEq's adaptive solvers default to): every observed
    Brownian value stays binding; supported in ``mode="scan"``/
    ``"while"`` (scan differentiates through it; the custom-vjp adjoint
    keeps the collapse scheme — its per-step history stores one tail,
    not a stack).
    """
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return sdeint(
                drift, diffusion, y0, t0, t1, args,
                key=key, solver=solver, rtol=rtol, atol=atol, dt0=dt0,
                max_steps=max_steps, saveat=saveat, controller=controller,
                mode=mode, remat=remat, axis_name=axis_name,
                matmul_precision=None, brownian=brownian,
                brownian_depth=brownian_depth,
                _bwd_precision=matmul_precision,
            )
    if brownian not in ("collapse", "stack"):
        raise ValueError(
            f"unknown brownian {brownian!r}; use 'collapse' or 'stack'")
    if brownian == "stack" and mode == "adjoint":
        raise ValueError(
            "brownian='stack' supports mode='scan' or 'while'; the "
            "adjoint engine's per-step history stores a single tail")
    time_dtype = jnp.result_type(jnp.asarray(t0).dtype, jnp.float32)
    t0 = jnp.asarray(t0, time_dtype)
    t1 = jnp.asarray(t1, time_dtype)

    # Per-shard-independent step control inside a shard_map region: stamp
    # replicated differentiable inputs shard-varying once at entry, so no
    # implicit pvary/psum_invariant pairs land inside the solve loops
    # (deadlock-prone with per-shard trip counts) — see ops.ode.odeint.
    from regneuralde_tpu.ops.ode import _stamp_like

    in_manual = axis_name is None and bool(
        getattr(jax.typeof(jax.tree_util.tree_leaves(y0)[0]), "vma",
                frozenset()) or frozenset()
    )
    if in_manual:
        t0, t1, args = _stamp_like(y0, (t0, t1, args))
        if saveat is not None:
            saveat = _stamp_like(y0, jnp.asarray(saveat, time_dtype))

    if solver != "em" and solver not in TABLEAUS:
        raise ValueError(
            f"unknown SDE solver {solver!r}; use 'em' or one of "
            f"{sorted(TABLEAUS)}"
        )

    span = t1 - t0  # forward-time only for SDEs
    tdir = 1.0

    ctrl = controller or PIController(beta1=0.5, beta2=0.0)

    ys_buf = None
    if saveat is not None:
        saveat = jnp.asarray(saveat, time_dtype)
        ys_buf = jax.tree_util.tree_map(
            lambda l: jnp.zeros((saveat.shape[0],) + l.shape, l.dtype), y0
        )
        at_start = saveat - t0 <= 0
        ys_buf = jax.tree_util.tree_map(
            lambda buf, y0l: jnp.where(
                at_start.reshape((-1,) + (1,) * y0l.ndim), y0l[None], buf
            ),
            ys_buf,
            y0,
        )

    if solver == "em":
        return _em_solve(
            drift, diffusion, y0, t0, t1, args, key, max_steps, saveat, ys_buf,
            time_dtype,
        )

    tableau = get_tableau(solver)

    dt_init = jnp.asarray(dt0 if dt0 is not None else 0.01, time_dtype)
    dt_init = jnp.minimum(dt_init, span) if dt0 is None else dt_init

    if brownian == "stack":
        zeros_tail = _stack_zeros(y0, brownian_depth, time_dtype)
        sample_increment = _sample_increment_stack
    else:
        zeros_tail = _Tail(
            h=jnp.zeros((), time_dtype),
            w=jax.tree_util.tree_map(jnp.zeros_like, y0),
            z=jax.tree_util.tree_map(jnp.zeros_like, y0),
        )
        sample_increment = _sample_increment
    init = _Carry(
        t=t0,
        dt=dt_init,
        qold=jnp.asarray(ctrl.qoldinit, jnp.float32),
        y=y0,
        done=span == 0,
        step=jnp.asarray(0, jnp.int32),
        naccept=jnp.asarray(0, jnp.int32),
        nreject=jnp.asarray(0, jnp.int32),
        key=key,
        tail=zeros_tail,
        ys_buf=ys_buf,
    )

    def make_step(t1, span, saveat, args):
        # Factory so the adjoint backward can rebuild the identical step
        # with traced (t1, span, saveat, args) for per-step jax.vjp
        # replay. ``saveat`` is a parameter (not a closure capture) so the
        # adjoint can thread it through its custom_vjp: under jax.vmap
        # with a per-sample (batch, n_save) grid the array is a batch
        # tracer, and a tracer captured by a custom_vjp closure leaks when
        # the backward is traced (UnexpectedTracerError).
        def step(carry: _Carry):
            t, dt, y = carry.t, carry.dt, carry.y
            remaining = t1 - t
            is_last = dt >= remaining
            dt_eff = jnp.where(is_last, remaining, dt)

            key_next, sub = jax.random.split(carry.key)
            dw, dz, tail_acc, tail_rej = sample_increment(
                sub, carry.tail, dt_eff)

            y_new, err, stage_info = sri_step(
                tableau, drift, diffusion, args, t, y, dt_eff, dw, dz
            )
            eest = error_ratio(err, y, y_new, rtol, atol, axis_name=axis_name)
            accept = eest <= 1.0

            # Stiffness estimate: dominant-eigenvalue proxy from the last two
            # distinct drift stages, ||f_b - f_a|| / ||H0_b - H0_a|| — the
            # shape OrdinaryDiffEq's composite algorithms use for eigen_est
            # (the reference's stiff_est input, experiments/mnist_nsde.jl:51-61).
            f_a, f_b, h_a, h_b = stage_info
            num = hairer_norm(tree_sub(f_b, f_a), axis_name=axis_name)
            den = hairer_norm(tree_sub(h_b, h_a), axis_name=axis_name)
            eigen_est = jnp.where(den > 0, num / jnp.maximum(den, 1e-30), 0.0)

            dt_next, qold_next = ctrl.propose(dt_eff, eest, qold=carry.qold, accept=accept)
            dt_next = jnp.minimum(dt_next, span).astype(time_dtype)
            qold_next = qold_next.astype(carry.qold.dtype)

            t_new = jnp.where(accept, jnp.where(is_last, t1, t + dt_eff), t)
            done_new = accept & is_last
            y_out = tree_where(accept, y_new, y)
            tail_out = jax.tree_util.tree_map(
                lambda a, r: jnp.where(accept, a, r), tail_acc, tail_rej
            )

            ys_out = carry.ys_buf
            if saveat is not None:
                t_end = jnp.where(is_last, t1, t + dt_eff)
                in_window = accept & (saveat - t > 0) & (saveat - t_end <= 0)
                theta = (saveat - t) / jnp.where(dt_eff == 0, 1.0, dt_eff)

                def lin(buf, y0l, y1l):
                    th = theta.reshape((-1,) + (1,) * y0l.ndim).astype(y0l.dtype)
                    yi = (1 - th) * y0l + th * y1l
                    return jnp.where(
                        in_window.reshape((-1,) + (1,) * y0l.ndim), yi, buf
                    )

                ys_out = jax.tree_util.tree_map(lin, carry.ys_buf, y, y_new)

            new_carry = _Carry(
                t=t_new,
                dt=dt_next,
                qold=qold_next,
                y=y_out,
                done=done_new,
                step=carry.step + 1,
                naccept=carry.naccept + accept.astype(jnp.int32),
                nreject=carry.nreject + (~accept).astype(jnp.int32),
                key=key_next,
                tail=tail_out,
                ys_buf=ys_out,
            )
            out = StepTelemetry(
                t=jnp.where(is_last, t1, t + dt_eff),
                dt=dt_eff,
                eest=eest,
                eigen_est=eigen_est,
                accepted=accept,
                live=jnp.asarray(True),
            )
            return new_carry, out

        return step

    step = make_step(t1, span, saveat, args)


    # EEst/eigen_est dtype follows the state dtype (float64 under x64);
    # the noop branch must emit identical types for lax.cond.
    eest_dtype = jnp.result_type(
        *[l.dtype for l in jax.tree_util.tree_leaves(y0)], jnp.float32
    )

    def noop(carry: _Carry):
        zero = jnp.zeros((), time_dtype)
        out = StepTelemetry(
            t=zero, dt=zero,
            eest=jnp.zeros((), eest_dtype),
            eigen_est=jnp.zeros((), eest_dtype),
            accepted=jnp.asarray(False),
            live=jnp.asarray(False),
        )
        return carry, out

    if mode == "adjoint":
        # Differentiable early-exit solve, mirroring ops.ode's adjoint
        # mode: while_loop forward storing the per-trial-step carry (incl.
        # the Brownian tail, so the replay reproduces the exact sampled
        # path), custom reverse while_loop jax.vjp-replaying only live
        # steps. The RNG key history is replayed as a non-differentiable
        # input; gradients flow through dW/dZ via the stored tail and the
        # bridge's dt-dependent scale exactly as in scan mode.
        final, tel = _sde_adjoint_solve(
            make_step, init, t0, t1, span, saveat, args, max_steps,
            time_dtype, eest_dtype, _bwd_precision, stamp=in_manual,
        )
    elif mode == "scan":
        if in_manual:
            # No lax.cond under per-shard-independent control: branches
            # would mix shard-varying state with replicated constants
            # differently and fail vma type matching — use the masked
            # select vmap lowers the cond to anyway (see ops.ode.odeint).
            # Done lanes still EXECUTE the (discarded) step branch, where
            # t == t1 makes dt_eff = 0 and d(sqrt(dt_eff)) = inf poisons
            # the zeroed cotangent (0 * inf = NaN) — feed those lanes a
            # harmless synthetic (t, dt) with dt_eff > 0 instead.
            safe_span = jnp.maximum(span, 1.0)

            def body(c):
                safe = c._replace(
                    t=jnp.where(c.done, t1 - safe_span, c.t),
                    dt=jnp.where(c.done, 0.5 * safe_span, c.dt),
                )
                new_s, out_s = step(safe)
                new_n, out_n = noop(c)
                pick = lambda a, b: jax.tree_util.tree_map(
                    lambda x, y: jnp.where(c.done, x, y), a, b)
                return pick(new_n, new_s), pick(out_n, out_s)

            init = _stamp_like(y0, init)
        else:
            body = lambda c: lax.cond(c.done, noop, step, c)
        if remat:
            body = jax.checkpoint(body)
        final, tel = lax.scan(lambda c, _: body(c), init, None, length=max_steps)
    elif mode == "while":
        tel0 = StepTelemetry(
            t=jnp.zeros((max_steps,), time_dtype),
            dt=jnp.zeros((max_steps,), time_dtype),
            eest=jnp.zeros((max_steps,), eest_dtype),
            eigen_est=jnp.zeros((max_steps,), eest_dtype),
            accepted=jnp.zeros((max_steps,), bool),
            live=jnp.zeros((max_steps,), bool),
        )
        if in_manual:
            init = _stamp_like(y0, init)
            tel0 = _stamp_like(y0, tel0)

        def while_body(state):
            carry, bufs = state
            i = carry.step
            carry2, out = step(carry)
            bufs2 = StepTelemetry(*[b.at[i].set(o) for b, o in zip(bufs, out)])
            return carry2, bufs2

        final, tel = lax.while_loop(
            lambda s: (~s[0].done) & (s[0].step < max_steps), while_body, (init, tel0)
        )
    else:
        raise ValueError(
            f"unknown mode {mode!r}; use 'adjoint', 'scan' or 'while'"
        )

    nsteps = final.naccept + final.nreject
    stats = SDEStats(
        nfe1=drift_evals_per_step(tableau) * nsteps,
        nfe2=diffusion_evals_per_step(tableau) * nsteps,
        naccept=final.naccept,
        nreject=final.nreject,
        success=final.done,
    )
    return SDESolution(y1=final.y, ys=final.ys_buf, ts=saveat, stats=stats, telemetry=tel)


class _SDEHist(NamedTuple):
    t: jnp.ndarray
    dt: jnp.ndarray
    qold: jnp.ndarray
    tail_h: jnp.ndarray
    key: jnp.ndarray  # (max_steps, 2) uint32 — replayed, not differentiated
    y: Pytree
    tail_w: Pytree
    tail_z: Pytree


def _sde_adjoint_solve(make_step, init, t0, t1, span, saveat, args,
                       max_steps, time_dtype, eest_dtype, bwd_precision,
                       stamp=False):
    """while_loop forward + custom reverse while_loop over live steps (the
    SDE counterpart of ops.ode's mode="adjoint"). Not twice-differentiable.
    ``stamp``: per-shard-independent control under shard_map — stamp loop
    carries seeded from replicated constants with the state's vma."""
    from regneuralde_tpu.ops.ode import (_materialize, _materialize_tree,
                                         _stamp_like)

    y0 = init.y
    has_ys = init.ys_buf is not None
    ys_init = init.ys_buf if has_ys else ()
    tail0 = init.tail
    key0 = init.key

    def vbuf(tree):
        def mk(l):
            buf = jnp.zeros((max_steps,) + l.shape, l.dtype)
            vma = tuple(
                sorted(getattr(jax.typeof(l), "vma", frozenset()) or ())
            )
            return jax.lax.pcast(buf, vma, to="varying") if vma else buf

        return jax.tree_util.tree_map(mk, tree)

    def replay(t, dt, qold, y, tail_h, tail_w, tail_z, ys_buf, t1_, span_,
               sa_, args_, key_):
        carry = _Carry(
            t=t, dt=dt, qold=qold, y=y,
            done=jnp.asarray(False),
            step=jnp.asarray(0, jnp.int32),
            naccept=jnp.asarray(0, jnp.int32),
            nreject=jnp.asarray(0, jnp.int32),
            key=key_,
            tail=_Tail(h=tail_h, w=tail_w, z=tail_z),
            ys_buf=ys_buf if has_ys else None,
        )
        new, tl = make_step(t1_, span_, sa_, args_)(carry)
        return (new.t, new.dt, new.qold, new.y, new.tail.h, new.tail.w,
                new.tail.z, new.ys_buf if has_ys else (),
                tl.t, tl.dt, tl.eest, tl.eigen_est)

    def _forward(t0_, t1_, span_, dt_init, y0_, tail0_, ys_init_, sa_,
                 key_, args_):
        step_fn = make_step(t1_, span_, sa_, args_)
        tel0 = StepTelemetry(
            t=jnp.zeros((max_steps,), time_dtype),
            dt=jnp.zeros((max_steps,), time_dtype),
            eest=jnp.zeros((max_steps,), eest_dtype),
            eigen_est=jnp.zeros((max_steps,), eest_dtype),
            accepted=jnp.zeros((max_steps,), bool),
            live=jnp.zeros((max_steps,), bool),
        )
        hist0 = _SDEHist(
            t=jnp.zeros((max_steps,), time_dtype),
            dt=jnp.zeros((max_steps,), time_dtype),
            qold=jnp.zeros((max_steps,), init.qold.dtype),
            tail_h=jnp.zeros((max_steps,), time_dtype),
            key=jnp.zeros((max_steps,) + key_.shape, key_.dtype),
            y=vbuf(y0_),
            tail_w=vbuf(tail0_.w),
            tail_z=vbuf(tail0_.z),
        )
        start = _Carry(
            t=t0_, dt=dt_init, qold=init.qold, y=y0_,
            done=init.done, step=init.step,
            naccept=init.naccept, nreject=init.nreject,
            key=key_, tail=tail0_,
            ys_buf=ys_init_ if has_ys else None,
        )

        if stamp:
            start = _stamp_like(y0_, start)
            tel0 = _stamp_like(y0_, tel0)
            hist0 = _stamp_like(y0_, hist0)

        def cond(state):
            carry, _, _ = state
            return (~carry.done) & (carry.step < max_steps)

        def body(state):
            carry, tel, hist = state
            i = carry.step
            setrow = lambda bt, vt: jax.tree_util.tree_map(
                lambda b, l: b.at[i].set(l), bt, vt)
            hist = _SDEHist(
                t=hist.t.at[i].set(carry.t),
                dt=hist.dt.at[i].set(carry.dt),
                qold=hist.qold.at[i].set(carry.qold),
                tail_h=hist.tail_h.at[i].set(carry.tail.h),
                key=hist.key.at[i].set(carry.key),
                y=setrow(hist.y, carry.y),
                tail_w=setrow(hist.tail_w, carry.tail.w),
                tail_z=setrow(hist.tail_z, carry.tail.z),
            )
            carry2, out = step_fn(carry)
            tel2 = StepTelemetry(*[b.at[i].set(o) for b, o in zip(tel, out)])
            return carry2, tel2, hist

        final, tel, hist = lax.while_loop(cond, body, (start, tel0, hist0))
        outs = (
            final.y,
            final.ys_buf if has_ys else (),
            tel, final.t, final.dt, final.qold,
            final.naccept, final.nreject, final.done,
        )
        return outs, hist

    @jax.custom_vjp
    def solve(t0_, t1_, span_, dt_init, y0_, tail0_, ys_init_, sa_, key_,
              args_):
        outs, _ = _forward(t0_, t1_, span_, dt_init, y0_, tail0_, ys_init_,
                           sa_, key_, args_)
        return outs

    def solve_fwd(t0_, t1_, span_, dt_init, y0_, tail0_, ys_init_, sa_,
                  key_, args_):
        outs, hist = _forward(t0_, t1_, span_, dt_init, y0_, tail0_,
                              ys_init_, sa_, key_, args_)
        nsteps = outs[6] + outs[7]
        return outs, (hist, nsteps, t1_, span_, y0_, tail0_, ys_init_, sa_,
                      args_)

    def solve_bwd(res, cts):
        # Traced lazily outside the forward's matmul-precision context —
        # bake it in (see ops.ode._make_adjoint_solve).
        if bwd_precision is not None:
            with jax.default_matmul_precision(bwd_precision):
                return _solve_bwd_impl(res, cts)
        return _solve_bwd_impl(res, cts)

    def _solve_bwd_impl(res, cts):
        hist, nsteps, t1_, span_, y0_, tail0_, ys_init_, sa_, args_ = res
        (ct_y1, ct_ysbuf, ct_tel, ct_tf, ct_dtf, ct_qoldf,
         _na, _nr, _done) = cts

        zlike = lambda tr: jax.tree_util.tree_map(jnp.zeros_like, tr)
        ys_zero = zlike(ys_init_)

        carry0 = (
            nsteps - 1,
            _materialize(ct_tf, jnp.zeros((), time_dtype)),
            _materialize(ct_dtf, jnp.zeros((), time_dtype)),
            _materialize(ct_qoldf, jnp.zeros((), hist.qold.dtype)),
            _materialize_tree(ct_y1, y0_),
            jnp.zeros((), time_dtype),  # ct tail.h
            zlike(tail0_.w),
            zlike(tail0_.z),
            _materialize_tree(ct_ysbuf, ys_init_),
            zlike(sa_),
            zlike(args_),
            jnp.zeros((), time_dtype),  # acc ct t1
            jnp.zeros((), time_dtype),  # acc ct span
        )
        if stamp:
            carry0 = _stamp_like(hist.y, carry0)
        ct_tel_t = _materialize(ct_tel.t, jnp.zeros((max_steps,), time_dtype))
        ct_tel_dt = _materialize(ct_tel.dt, jnp.zeros((max_steps,), time_dtype))
        ct_tel_e = _materialize(ct_tel.eest, jnp.zeros((max_steps,), eest_dtype))
        ct_tel_g = _materialize(
            ct_tel.eigen_est, jnp.zeros((max_steps,), eest_dtype))

        def cond(state):
            return state[0] >= 0

        def body(state):
            (i, ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_ys,
             ct_sa, ct_args, ct_t1x, ct_spanx) = state
            row = lambda tr: jax.tree_util.tree_map(lambda b: b[i], tr)
            prim = (
                hist.t[i], hist.dt[i], hist.qold[i], row(hist.y),
                hist.tail_h[i], row(hist.tail_w), row(hist.tail_z),
                ys_zero, t1_, span_, sa_, args_, hist.key[i],
            )
            _, vjp_fn = jax.vjp(replay, *prim)
            (d_t, d_dt, d_qold, d_y, d_th, d_tw, d_tz, d_ys, d_t1, d_span,
             d_sa, d_args, _d_key) = vjp_fn(
                (ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_ys,
                 ct_tel_t[i], ct_tel_dt[i], ct_tel_e[i], ct_tel_g[i])
            )
            return (
                i - 1, d_t, d_dt, d_qold, d_y, d_th, d_tw, d_tz, d_ys,
                jax.tree_util.tree_map(jnp.add, ct_sa, d_sa),
                jax.tree_util.tree_map(jnp.add, ct_args, d_args),
                ct_t1x + d_t1, ct_spanx + d_span,
            )

        (_, ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_ys,
         ct_sa, ct_args, ct_t1x, ct_spanx) = lax.while_loop(
            cond, body, carry0)

        return (
            ct_t,  # t0 (carry start)
            ct_t1x,  # t1
            ct_spanx,  # span
            ct_dt,  # dt_init
            ct_y,  # y0
            _Tail(h=ct_th, w=ct_tw, z=ct_tz),  # tail0
            ct_ys,  # ys_init
            ct_sa,  # saveat (interpolation stamps)
            None,  # key (non-differentiable)
            ct_args,
        )

    solve.defvjp(solve_fwd, solve_bwd)

    (y1, ys_out, tel, t_f, dt_f, qold_f, naccept, nreject, done) = solve(
        t0, t1, span, init.dt, y0, tail0, ys_init, saveat, key0, args
    )
    final = init._replace(
        t=t_f, dt=dt_f, qold=qold_f, y=y1,
        ys_buf=ys_out if has_ys else None,
        naccept=naccept, nreject=nreject, done=done,
    )
    return final, tel


def _em_solve(drift, diffusion, y0, t0, t1, args, key, n_steps, saveat, ys_buf, time_dtype):
    """Fixed-step Euler-Maruyama over a uniform grid of ``n_steps`` steps."""
    dt = (t1 - t0) / n_steps
    sqdt = jnp.sqrt(dt)

    def body(carry, i):
        y, k = carry
        t = t0 + i.astype(time_dtype) * dt
        k, sub = jax.random.split(k)
        xi = _normal_like(sub, y)
        f = drift(t, y, args)
        g = diffusion(t, y, args)
        y_new = jax.tree_util.tree_map(
            lambda u, fl, gl, x: u + dt * fl + sqdt * gl * x, y, f, g, xi
        )
        return (y_new, k), (y, y_new, t)

    (y1, _), (ys0, ys1, ts_grid) = lax.scan(
        body, (y0, key), jnp.arange(n_steps), length=n_steps
    )

    out_buf = ys_buf
    if saveat is not None:
        # Linear interpolation on the uniform grid, vectorized over saveat.
        t_start = ts_grid  # (n,)
        t_end = ts_grid + dt

        def interp(buf, y0s, y1s, y0_init):
            # y0s/y1s: (n, *shape); pick the containing interval per save pt.
            idx = jnp.clip(((saveat - t0) / dt).astype(jnp.int32), 0, n_steps - 1)
            th = (saveat - (t0 + idx.astype(time_dtype) * dt)) / dt
            th = jnp.clip(th, 0.0, 1.0)
            a = y0s[idx]
            b = y1s[idx]
            thb = th.reshape((-1,) + (1,) * (a.ndim - 1)).astype(a.dtype)
            yi = (1 - thb) * a + thb * b
            before = (saveat <= t0).reshape((-1,) + (1,) * (a.ndim - 1))
            return jnp.where(before, y0_init[None], yi)

        out_buf = jax.tree_util.tree_map(interp, ys_buf, ys0, ys1, y0)

    n = jnp.asarray(n_steps, jnp.int32)
    tel = StepTelemetry(
        t=ts_grid + dt,
        dt=jnp.full((n_steps,), dt, time_dtype),
        eest=jnp.zeros((n_steps,), jnp.float32),
        eigen_est=jnp.zeros((n_steps,), jnp.float32),
        accepted=jnp.ones((n_steps,), bool),
        live=jnp.ones((n_steps,), bool),
    )
    stats = SDEStats(
        nfe1=n, nfe2=n, naccept=n, nreject=jnp.zeros((), jnp.int32),
        success=jnp.asarray(True),
    )
    return SDESolution(y1=y1, ys=out_buf, ts=saveat, stats=stats, telemetry=tel)

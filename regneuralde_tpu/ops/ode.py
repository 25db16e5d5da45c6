"""Adaptive explicit Runge-Kutta ODE integration as a single XLA program.

This layer replaces the reference's use of ``OrdinaryDiffEq.solve`` with
``SensitivityADPassThrough`` — i.e. "backprop through the solver" with a
tape AD (reference: src/models/neural_ode.jl:110-144) — with an XLA-native
design:

* The adaptive loop is a **bounded ``lax.scan`` over ``max_steps`` trial
  steps with live/accept masks**, so ``jax.grad`` performs the discrete
  adjoint through every accepted and rejected step (XLA cannot reverse-
  differentiate ``while_loop``). Each step body is wrapped in
  ``jax.checkpoint`` so backward memory is O(max_steps * state) instead of
  O(max_steps * stages * state) — the analogue of the reference's tape-size
  pain (reference: experiments/mnist_node.jl:237 forces GC per batch).
* A ``lax.while_loop`` fast path (``mode="while"``) runs exactly the same
  step function for inference / NFE measurement without paying for dead
  iterations; it produces an identical `ODESolution`, it just isn't
  reverse-differentiable.
* Solver internals are **first-class differentiable outputs**: every trial
  step emits ``(t, dt, EEst, eigen_est, accepted)`` streams. The reference
  harvests the same quantities via ``SavingCallback((u,t,int) ->
  int.EEst * int.dt)`` (reference: src/models/neural_ode.jl:116,126-127);
  here the regularizers in ``regneuralde_tpu.reg`` are masked reductions
  over these streams.
* ``eigen_est`` is the power-iteration-like stiffness estimate the
  reference obtains via the ``AutoTsit5(Tsit5())`` composite hack
  (reference: experiments/latent_ode.jl:128-136): the norm ratio of the
  last two stage derivatives over the last two stage states.
* The whole minibatch is one ODE state with ONE global error norm, matching
  reference semantics; under data parallelism pass ``axis_name`` and the
  norms psum over the mesh axis so step control is globally synchronized.

Dense output for ``saveat`` uses a cubic Hermite interpolant over each
accepted step (free: uses the FSAL derivatives already computed).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from regneuralde_tpu.ops.controller import PIController, initial_step_size
from regneuralde_tpu.ops.norms import (
    error_ratio,
    hairer_norm,
    tree_lincomb,
    tree_sub,
    tree_where,
)
from regneuralde_tpu.ops.tableaus import ExplicitRKTableau, get_tableau

Pytree = Any


class StepTelemetry(NamedTuple):
    """Per-trial-step solver internals, shape ``(max_steps,)`` each.

    ``accepted`` marks live accepted steps; ``live`` marks trial steps that
    actually executed (the bounded scan keeps iterating after integration
    finishes, emitting ``live=False`` rows). Regularizers reduce these
    streams under the masks.
    """

    t: jnp.ndarray  # endpoint of the trial step (== save time when accepted)
    dt: jnp.ndarray  # dt used for the trial step
    eest: jnp.ndarray  # tolerance-normalized local error estimate
    eigen_est: jnp.ndarray  # stiffness estimate (stage-ratio power estimate)
    accepted: jnp.ndarray  # bool
    live: jnp.ndarray  # bool


class ODEStats(NamedTuple):
    nfe: jnp.ndarray  # number of dynamics evaluations (matches destats.nf)
    naccept: jnp.ndarray
    nreject: jnp.ndarray
    success: jnp.ndarray  # reached t1 within max_steps


class ODESolution(NamedTuple):
    y1: Pytree  # state at t1
    ys: Optional[Pytree]  # states at `saveat` (leading axis = len(saveat))
    ts: Optional[jnp.ndarray]  # the saveat times
    stats: ODEStats
    telemetry: StepTelemetry


class _Carry(NamedTuple):
    t: jnp.ndarray
    dt: jnp.ndarray
    qold: jnp.ndarray
    y: Pytree
    f0: Pytree  # FSAL derivative at (t, y)
    done: jnp.ndarray
    step: jnp.ndarray
    naccept: jnp.ndarray
    nreject: jnp.ndarray
    ys_buf: Optional[Pytree]
    # Extra per-loop state for composite solvers (the Auto* stiffness
    # switch carries (alg, run, n_stiff_steps) here); plain solvers
    # leave it empty.
    aux: Any = ()


class CompSweep(NamedTuple):
    """A sweep result whose embedded error carries its rounding residual
    as an (hi, lo) double-f32 pair (``odeint(compensated_eest=True)``;
    see ops/compensated.py). The step fn folds the pair into the scaled
    norm before squaring."""

    y_new: Pytree
    k_last: Pytree
    err_hi: Pytree
    err_lo: Pytree
    k_prev: Pytree
    g_prev: Pytree


class EigenSweep(NamedTuple):
    """A ``stage_sweep`` result that supplies its own stiffness estimate
    instead of the explicit-RK two-stage quotient (used by implicit /
    Rosenbrock trial steps, whose stage structure has no analogue of the
    last-two-stages eigen_est). ``err`` is the raw embedded error (same
    contract as the generic sweep); the step fn still runs
    ``error_ratio`` on it, and pmax's ``eigen_est`` across ``axis_name``,
    so step control AND Auto* switching stay in lockstep under data
    parallelism."""

    y_new: Pytree
    k_last: Pytree  # derivative at (t + dt, y_new): FSAL seed + Hermite
    err: Pytree
    eigen_est: jnp.ndarray


def _hermite_eval(theta, h, y0, y1, f0, f1):
    """Cubic Hermite interpolation on one step; ``theta`` has shape (S,).

    Broadcasts the (S,) interpolation grid against every state leaf,
    returning leaves of shape ``(S,) + leaf.shape``.
    """

    def leaf(y0l, y1l, f0l, f1l):
        th = theta.reshape((-1,) + (1,) * y0l.ndim).astype(y0l.dtype)
        hh = jnp.asarray(h, y0l.dtype)
        dy = y1l - y0l
        return (
            (1 - th) * y0l
            + th * y1l
            + th * (th - 1) * ((1 - 2 * th) * dy + (th - 1) * hh * f0l + th * hh * f1l)
        )

    return jax.tree_util.tree_map(leaf, y0, y1, f0, f1)


def _make_step_fn(
    func: Callable,
    args,
    tab: ExplicitRKTableau,
    ctrl: PIController,
    t1,
    tdir,
    span,
    rtol,
    atol,
    saveat: Optional[jnp.ndarray],
    axis_name: Optional[str],
    stage_sweep: Optional[Callable] = None,
    compensated: bool = False,
):
    if not tab.fsal:
        raise NotImplementedError("only FSAL tableaus are supported")
    n_stages = tab.num_stages
    time_dtype = jnp.result_type(t1)
    err_dtype = jnp.promote_types(time_dtype, jnp.float32)

    def compensated_sweep(t, dt_eff, y, f0, args_):
        # Same stage math as generic_sweep, but the embedded-error
        # combination carries its rounding residual as an (hi, lo)
        # float pair (ops.compensated; VERDICT-r4 #3) folded into the
        # scaled norm in step() below. Removes ARITHMETIC noise from
        # the estimator; stage-input rounding remains (see
        # ops/compensated.py).
        from regneuralde_tpu.ops.compensated import (
            compensated_error_combination,
        )

        ks = [f0]
        y_stage = y
        for i in range(1, n_stages):
            y_stage = tree_lincomb(y, dt_eff, tab.a[i - 1], ks)
            ks.append(func(t + tab.c[i] * dt_eff, y_stage, args_))
        y_new = y_stage
        g_prev = tree_lincomb(y, dt_eff, tab.a[n_stages - 3],
                              ks[: n_stages - 2])
        pairs = jax.tree_util.tree_map(
            lambda *kl: compensated_error_combination(
                dt_eff, tab.btilde, kl),
            *ks,
        )
        err_hi, err_lo = jax.tree_util.tree_transpose(
            jax.tree_util.tree_structure(y),
            jax.tree_util.tree_structure((0, 0)), pairs)
        return CompSweep(y_new, ks[-1], err_hi, err_lo, ks[-2], g_prev)

    def generic_sweep(t, dt_eff, y, f0, args_):
        # Stage sweep. FSAL: the advancing solution equals the input of the
        # final stage, whose derivative seeds the next step's k1.
        ks = [f0]
        y_stage = y
        for i in range(1, n_stages):
            y_stage = tree_lincomb(y, dt_eff, tab.a[i - 1], ks)
            ks.append(func(t + tab.c[i] * dt_eff, y_stage, args_))
        y_new = y_stage  # b row == last a row (FSAL)
        g_prev = tree_lincomb(y, dt_eff, tab.a[n_stages - 3], ks[: n_stages - 2])

        # Embedded error, regrouped as sum(btilde_i * (k_i - k1)) — exact
        # because sum(btilde) == 0, but numerically crucial in float32: the
        # naive combination cancels O(1) stage values down to an O(dt^5)
        # residual, so its rounding noise (~1e-7 absolute) floors the error
        # estimate and pins the controller at a tiny dt at tight tolerances.
        # Differencing against k1 first makes every summand O(dt), dropping
        # the noise floor to the irreducible stage-storage rounding and
        # letting dt open up to the true-error limit (~10x fewer steps at
        # rtol=1.4e-8 on the MNIST dynamics).
        err = jax.tree_util.tree_map(
            lambda *k_leaves: dt_eff * sum(
                c * (kl - k_leaves[0]) for c, kl in zip(tab.btilde[1:], k_leaves[1:])
            ),
            *ks,
        )
        return y_new, ks[-1], err, ks[-2], g_prev

    if compensated and stage_sweep is not None:
        raise ValueError(
            "compensated_eest applies to the generic sweep only — "
            "construct with no stage_sweep")
    sweep = (stage_sweep if stage_sweep is not None
             else (compensated_sweep if compensated else generic_sweep))

    def step(carry: _Carry):
        t, dt, qold, y, f0 = carry.t, carry.dt, carry.qold, carry.y, carry.f0

        remaining = t1 - t
        is_last = (dt - remaining) * tdir >= 0
        dt_eff = jnp.where(is_last, remaining, dt)

        res = sweep(t, dt_eff, y, f0, args)
        if isinstance(res, CompSweep):
            from regneuralde_tpu.ops.compensated import (
                compensated_error_ssq,
            )

            y_new, k_last = res.y_new, res.k_last
            ssq = sum(
                compensated_error_ssq(hi, lo, yl, ynl, rtol, atol)
                for hi, lo, yl, ynl in zip(
                    jax.tree_util.tree_leaves(res.err_hi),
                    jax.tree_util.tree_leaves(res.err_lo),
                    jax.tree_util.tree_leaves(y),
                    jax.tree_util.tree_leaves(y_new)))
            ssq = ssq.astype(err_dtype)
            count = jnp.asarray(
                sum(l.size for l in jax.tree_util.tree_leaves(y)),
                err_dtype)
            if axis_name is not None:
                ssq = lax.psum(ssq, axis_name)
                count = lax.psum(count, axis_name)
            eest = jnp.where(
                ssq > 0,
                jnp.sqrt(jnp.where(ssq > 0, ssq, 1.0) / count),
                0.0).astype(err_dtype)
            eig_num = hairer_norm(tree_sub(k_last, res.k_prev),
                                  axis_name=axis_name)
            eig_den = hairer_norm(tree_sub(y_new, res.g_prev),
                                  axis_name=axis_name)
            eigen_est = jnp.where(
                eig_den > 0, eig_num / jnp.maximum(eig_den, 1e-30), 0.0
            ).astype(err_dtype)
        elif isinstance(res, EigenSweep):
            y_new, k_last = res.y_new, res.k_last
            eest = error_ratio(res.err, y, y_new, rtol, atol,
                               axis_name=axis_name)
            eest = eest.astype(err_dtype)
            eigen_est = res.eigen_est.astype(err_dtype)
            if axis_name is not None:
                # Global worst case over shards: keeps the estimate (and
                # any Auto* switch decision built on it) in lockstep.
                eigen_est = lax.pmax(eigen_est, axis_name)
        else:
            y_new, k_last, err, k_prev, g_prev = res
            eest = error_ratio(err, y, y_new, rtol, atol, axis_name=axis_name)
            eest = eest.astype(err_dtype)

            # Stiffness estimate from the last two internal stages, as
            # OrdinaryDiffEq's composite algorithms compute it.
            eig_num = hairer_norm(tree_sub(k_last, k_prev), axis_name=axis_name)
            eig_den = hairer_norm(tree_sub(y_new, g_prev), axis_name=axis_name)
            eigen_est = jnp.where(
                eig_den > 0, eig_num / jnp.maximum(eig_den, 1e-30), 0.0
            ).astype(err_dtype)

        accept = eest <= 1.0
        dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
        # dtmax clamp: never propose beyond the total span.
        dt_next = jnp.sign(dt_next) * jnp.minimum(jnp.abs(dt_next), span)

        t_new = jnp.where(accept, jnp.where(is_last, t1, t + dt_eff), t)
        done_new = accept & is_last
        y_out = tree_where(accept, y_new, y)
        f0_out = tree_where(accept, k_last, f0)

        ys_buf = carry.ys_buf
        if saveat is not None:
            t_end = jnp.where(is_last, t1, t + dt_eff)
            in_window = (
                accept
                & ((saveat - t) * tdir > 0)
                & ((saveat - t_end) * tdir <= 0)
            )
            theta = (saveat - t) / jnp.where(dt_eff == 0, 1.0, dt_eff)
            y_interp = _hermite_eval(theta, dt_eff, y, y_new, f0, k_last)
            ys_buf = jax.tree_util.tree_map(
                lambda buf, yi: jnp.where(
                    in_window.reshape((-1,) + (1,) * (buf.ndim - 1)), yi, buf
                ),
                ys_buf,
                y_interp,
            )

        new_carry = _Carry(
            t=t_new.astype(time_dtype),
            dt=dt_next,
            qold=qold_next,
            y=y_out,
            f0=f0_out,
            done=done_new,
            step=carry.step + 1,
            naccept=carry.naccept + accept.astype(jnp.int32),
            nreject=carry.nreject + (~accept).astype(jnp.int32),
            ys_buf=ys_buf,
        )
        out = StepTelemetry(
            t=jnp.where(is_last, t1, t + dt_eff).astype(time_dtype),
            dt=dt_eff,
            eest=eest,
            eigen_est=eigen_est,
            accepted=accept,
            live=jnp.asarray(True),
        )
        return new_carry, out

    def noop(carry: _Carry):
        zero = jnp.zeros((), time_dtype)
        out = StepTelemetry(
            t=zero,
            dt=zero,
            eest=jnp.zeros((), err_dtype),
            eigen_est=jnp.zeros((), err_dtype),
            accepted=jnp.asarray(False),
            live=jnp.asarray(False),
        )
        return carry, out

    return step, noop


# ---------------------------------------------------------------------------
# Differentiable early-exit mode ("adjoint"): while_loop forward storing the
#: AutoSwitch thresholds (OrdinaryDiffEq's AutoSwitch procedure with the
#: stifftol calibrated to THIS package's eigen_est): switch to the stiff
#: algorithm after `maxstiffstep` consecutive accepted steps whose
#: normalized indicator `|eigen_est|*dt / stability_size(nonstiff alg)`
#: exceeds `stifftol`, and back after `maxnonstiffstep` consecutive
#: accepted steps below `nonstifftol`. Calibration: an explicit method
#: running at its stability limit measures ~1.02 here (Robertson, Tsit5,
#: rtol 1e-6 — the controller's accept/grow cycle hugs the boundary from
#: just above), while accuracy-limited nonstiff solves sit far below 1,
#: so the stiff trigger is 1.0 (upstream's 11/10 never fires for this
#: eigen_est estimator). On a switch, dt is scaled by `dtfac` (up into
#: the stiff method, down out of it).
_AUTO_MAXSTIFFSTEP = 10
_AUTO_MAXNONSTIFFSTEP = 3
_AUTO_STIFFTOL = 1.0
_AUTO_NONSTIFFTOL = 9.0 / 10.0
_AUTO_DTFAC = 2.0


def _make_auto_step(step_ns, noop_ns, step_st, stab_size: float):
    """Wrap a nonstiff and a stiff step fn into one stiffness-switching
    step (the Auto* composite of OrdinaryDiffEq, reference:
    experiments/mnist_node.jl:70-81 — where upstream's composite is
    degenerate, `AutoTsit5(Tsit5())`, because only its eigen_est
    telemetry is consumed; here the stiff arm is a real Rosenbrock23).

    The switching state rides ``carry.aux = (alg, run, n_stiff)``:
    ``alg`` is the active algorithm (0 nonstiff / 1 stiff), ``run``
    counts consecutive accepted steps voting for a switch, ``n_stiff``
    counts trial steps executed by the stiff arm (NFE accounting —
    the two arms cost different f evaluations per step)."""

    def step(carry: _Carry):
        alg, run, n_stiff = carry.aux
        base = carry._replace(aux=())
        new, out = lax.cond(alg == 1, step_st, step_ns, base)

        stiffness = jnp.abs(out.eigen_est) * jnp.abs(out.dt) / stab_size
        vote = jnp.where(
            alg == 1,
            stiffness < _AUTO_NONSTIFFTOL,
            stiffness > _AUTO_STIFFTOL,
        ) & out.accepted
        run = jnp.where(vote, run + 1,
                        jnp.where(out.accepted, 0, run))
        limit = jnp.where(alg == 1, _AUTO_MAXNONSTIFFSTEP,
                          _AUTO_MAXSTIFFSTEP)
        flip = run >= limit
        dt_new = jnp.where(
            flip,
            jnp.where(alg == 0, new.dt * _AUTO_DTFAC,
                      new.dt / _AUTO_DTFAC),
            new.dt,
        )
        aux = (
            jnp.where(flip, 1 - alg, alg),
            jnp.where(flip, 0, run),
            n_stiff + (alg == 1).astype(jnp.int32),
        )
        return new._replace(dt=dt_new.astype(new.dt.dtype), aux=aux), out

    def noop(carry: _Carry):
        return noop_ns(carry)

    return step, noop


# per-trial-step carry, custom_vjp backward replaying ONLY live steps in a
# reverse while_loop. Unlike the bounded scan, neither direction pays for
# dead iterations past the step where integration finished — the scan mode's
# measured top cost at generous max_steps — while gradients remain the exact
# discrete adjoint through every accepted and rejected step (the reference's
# SensitivityADPassThrough semantics, src/models/neural_ode.jl:67).
# Per-step state rematerialization (recompute the stage sweep from the
# stored step-start state) doubles as the checkpointing strategy: backward
# memory is O(max_steps * state), same as the remat'd scan.
# Not twice-differentiable (the backward is itself a while_loop); use
# mode="scan" for higher-order AD.
# ---------------------------------------------------------------------------


class _AdjointHist(NamedTuple):
    t: jnp.ndarray  # (max_steps,) carry at each trial-step START
    dt: jnp.ndarray
    qold: jnp.ndarray
    y: Pytree  # (max_steps,) + leaf.shape
    f0: Pytree  # FSAL derivative carried into the step (bitwise-faithful
    # replay: recomputing func(t, y) instead would differ from the carried
    # k7 by rounding, and 1/tol amplification through the EEst chain turns
    # those ulps into visible gradient noise)
    # Composite switching state (alg, run, n_stiff) at each step START —
    # () for plain solvers.
    aux: Any = ()


def _make_adjoint_solve(
    func, tab, ctrl, rtol, atol, has_saveat, axis_name, stage_sweep,
    max_steps, time_dtype, err_dtype, bwd_precision,
    step_builder=None, aux0=(), compensated=False,
):
    """Build the custom_vjp'd solve for one (static-config) odeint call.

    The returned callable maps
      (t0, t1, dt_init, y0, f0_init, ys_buf_init, saveat, args)
    to
      (y1, ys_buf, telemetry, t_f, dt_f, qold_f, naccept, nreject, done,
       aux_f).

    ``saveat`` is threaded as an explicit argument (``()`` when
    ``has_saveat`` is false) rather than captured in the closure: under
    ``jax.vmap`` with a per-sample ``(batch, n_save)`` grid the array is a
    batch tracer, and a tracer captured by a ``custom_vjp`` closure leaks
    when the backward is traced (UnexpectedTracerError). Its cotangent is
    accumulated through the replay vjp like the args', so d(loss)/d(saveat)
    matches mode="scan".

    ``step_builder(t0, t1, saveat, args) -> step_fn`` overrides the
    default single-tableau step — the Auto* stiffness-switching composite
    plugs in here. Its integer switching state ``(alg, run, n_stiff)``
    rides ``carry.aux`` (template ``aux0``), is recorded per trial step in
    the adjoint history, and is replayed into each backward step so the
    vjp differentiates through the SAME branch the forward took
    (reference: the AutoTsit5 composite trained through,
    experiments/mnist_node.jl:70-81). ``aux_f`` is the final aux
    (``()`` for plain solvers) — n_stiff feeds NFE accounting.
    """
    tdir_of = lambda t0, t1: jnp.sign(t1 - t0)

    def make_step(t0, t1, saveat, args):
        if step_builder is not None:
            return step_builder(t0, t1, saveat if has_saveat else None,
                                args)
        tdir = tdir_of(t0, t1)
        span = jnp.abs(t1 - t0)
        step_fn, _ = _make_step_fn(
            func, args, tab, ctrl, t1, tdir, span, rtol, atol,
            saveat if has_saveat else None,
            axis_name, stage_sweep=stage_sweep, compensated=compensated,
        )
        return step_fn

    def replay(t, dt, qold, y, f0, ys_buf, aux, t0, t1, saveat, args):
        """One trial step from the stored step-start carry (incl. the FSAL
        derivative and any composite switching state), bitwise identical
        to the forward's step. ``aux`` is integer state — its cotangent is
        float0 and dropped by the caller."""
        carry = _Carry(
            t=t, dt=dt, qold=qold, y=y, f0=f0,
            done=jnp.asarray(False),
            step=jnp.asarray(0, jnp.int32),
            naccept=jnp.asarray(0, jnp.int32),
            nreject=jnp.asarray(0, jnp.int32),
            ys_buf=ys_buf,
            aux=aux,
        )
        new, tel = make_step(t0, t1, saveat, args)(carry)
        return (new.t, new.dt, new.qold, new.y, new.f0, new.ys_buf,
                tel.t, tel.dt, tel.eest, tel.eigen_est)

    def _forward(t0, t1, dt_init, y0, f0_init, ys_buf_init, saveat, args):
        step_fn = make_step(t0, t1, saveat, args)
        tel0 = StepTelemetry(
            t=jnp.zeros((max_steps,), time_dtype),
            dt=jnp.zeros((max_steps,), time_dtype),
            eest=jnp.zeros((max_steps,), err_dtype),
            eigen_est=jnp.zeros((max_steps,), err_dtype),
            accepted=jnp.zeros((max_steps,), bool),
            live=jnp.zeros((max_steps,), bool),
        )
        def buf_like(tree):
            # History buffers must carry the template's varying-mesh-axes
            # (under shard_map the state rows are per-shard), or the
            # while_loop carry types mismatch at the first write. `+ l * 0`
            # stamps the template's vma via broadcasting (XLA folds the
            # dead multiply) without the deprecated explicit pvary.
            return jax.tree_util.tree_map(
                lambda l: jnp.zeros((max_steps,) + l.shape, l.dtype) + l * 0,
                tree,
            )
        hist0 = _AdjointHist(
            t=jnp.zeros((max_steps,), time_dtype),
            dt=jnp.zeros((max_steps,), time_dtype),
            qold=jnp.zeros((max_steps,), err_dtype),
            y=buf_like(y0),
            f0=buf_like(f0_init),
            aux=buf_like(aux0),
        )
        init = _Carry(
            t=t0, dt=dt_init,
            qold=jnp.asarray(ctrl.qoldinit, err_dtype),
            y=y0, f0=f0_init,
            done=jnp.abs(t1 - t0) == 0,
            step=jnp.asarray(0, jnp.int32),
            naccept=jnp.asarray(0, jnp.int32),
            nreject=jnp.asarray(0, jnp.int32),
            ys_buf=ys_buf_init,
            aux=aux0,
        )
        # Per-shard-independent solves under shard_map (see _stamp_like).
        if axis_name is None:
            init = _stamp_like(y0, init)
            tel0 = _stamp_like(y0, tel0)
            hist0 = _stamp_like(y0, hist0)

        def cond(state):
            carry, _, _ = state
            return (~carry.done) & (carry.step < max_steps)

        def body(state):
            carry, tel, hist = state
            i = carry.step
            set_row = lambda buf_tree, val_tree: jax.tree_util.tree_map(
                lambda buf, l: buf.at[i].set(l), buf_tree, val_tree
            )
            hist = _AdjointHist(
                t=hist.t.at[i].set(carry.t),
                dt=hist.dt.at[i].set(carry.dt),
                qold=hist.qold.at[i].set(carry.qold),
                y=set_row(hist.y, carry.y),
                f0=set_row(hist.f0, carry.f0),
                aux=set_row(hist.aux, carry.aux),
            )
            carry2, out = step_fn(carry)
            tel2 = StepTelemetry(*[b.at[i].set(o) for b, o in zip(tel, out)])
            return carry2, tel2, hist

        final, tel, hist = lax.while_loop(cond, body, (init, tel0, hist0))
        outs = (final.y, final.ys_buf, tel, final.t, final.dt, final.qold,
                final.naccept, final.nreject, final.done, final.aux)
        return outs, hist

    @jax.custom_vjp
    def solve(t0, t1, dt_init, y0, f0_init, ys_buf_init, saveat, args):
        outs, _ = _forward(t0, t1, dt_init, y0, f0_init, ys_buf_init,
                           saveat, args)
        return outs

    def solve_fwd(t0, t1, dt_init, y0, f0_init, ys_buf_init, saveat, args):
        outs, hist = _forward(t0, t1, dt_init, y0, f0_init, ys_buf_init,
                              saveat, args)
        nsteps = outs[6] + outs[7]  # naccept + nreject
        return outs, (hist, nsteps, t0, t1, y0, f0_init, ys_buf_init,
                      saveat, args)

    def solve_bwd(res, cts):
        # PRECISION IS LOAD-BEARING: this function is traced lazily during
        # backward-pass construction, OUTSIDE the default_matmul_precision
        # context that wrapped the forward solve. The replay re-traces the
        # dynamics' contractions here — at the GPU's TF32 default (10-bit
        # mantissa, ~1e-3 relative) they would feed the EEst/controller
        # pullback noise that the ~1/tol amplification turns into garbage
        # gradients. CPU is immune (its default matmul is exact f32);
        # the chip test in tests/test_adjoint.py pins this on the card.
        if bwd_precision is not None:
            with jax.default_matmul_precision(bwd_precision):
                return _solve_bwd_impl(res, cts)
        return _solve_bwd_impl(res, cts)

    def _solve_bwd_impl(res, cts):
        hist, nsteps, t0, t1, y0, f0_init, ys_buf_init, saveat, args = res
        (ct_y1, ct_ysbuf, ct_tel, ct_tf, ct_dtf, ct_qoldf,
         _ct_na, _ct_nr, _ct_done, _ct_aux) = cts

        def zlike(tree):
            return jax.tree_util.tree_map(jnp.zeros_like, tree)

        ys_zero = zlike(ys_buf_init)

        carry0 = (
            nsteps - 1,
            _materialize(ct_tf, jnp.zeros((), time_dtype)),
            _materialize(ct_dtf, jnp.zeros((), time_dtype)),
            _materialize(ct_qoldf, jnp.zeros((), err_dtype)),
            _materialize_tree(ct_y1, y0),
            zlike(f0_init),  # ct on the carried FSAL derivative
            _materialize_tree(ct_ysbuf, ys_buf_init),
            zlike(saveat),
            zlike(args),
            jnp.zeros((), time_dtype),  # extra ct into t0 (span clamp)
            jnp.zeros((), time_dtype),  # extra ct into t1 (is_last / span)
        )
        # Per-shard-independent solves under shard_map (see _stamp_like).
        if axis_name is None:
            carry0 = _stamp_like(hist.y, carry0)

        ct_tel_t = _materialize(ct_tel.t, jnp.zeros((max_steps,), time_dtype))
        ct_tel_dt = _materialize(ct_tel.dt, jnp.zeros((max_steps,), time_dtype))
        ct_tel_eest = _materialize(ct_tel.eest, jnp.zeros((max_steps,), err_dtype))
        ct_tel_eig = _materialize(
            ct_tel.eigen_est, jnp.zeros((max_steps,), err_dtype))

        def cond(state):
            return state[0] >= 0

        def body(state):
            (i, ct_t, ct_dt, ct_qold, ct_y, ct_f0, ct_ys, ct_sa, ct_args,
             ct_t0x, ct_t1x) = state
            row = lambda tree: jax.tree_util.tree_map(lambda b: b[i], tree)
            prim = (
                hist.t[i], hist.dt[i], hist.qold[i],
                row(hist.y), row(hist.f0),
                ys_zero, row(hist.aux), t0, t1, saveat, args,
            )
            _, vjp_fn = jax.vjp(replay, *prim)
            (d_t, d_dt, d_qold, d_y, d_f0, d_ys, _d_aux, d_t0, d_t1, d_sa,
             d_args) = vjp_fn(
                (ct_t, ct_dt, ct_qold, ct_y, ct_f0, ct_ys,
                 ct_tel_t[i], ct_tel_dt[i], ct_tel_eest[i], ct_tel_eig[i])
            )
            return (
                i - 1, d_t, d_dt, d_qold, d_y, d_f0, d_ys,
                jax.tree_util.tree_map(jnp.add, ct_sa, d_sa),
                jax.tree_util.tree_map(jnp.add, ct_args, d_args),
                ct_t0x + d_t0, ct_t1x + d_t1,
            )

        (_, ct_t, ct_dt, ct_qold, ct_y, ct_f0, ct_ys, ct_sa, ct_args,
         ct_t0x, ct_t1x) = lax.while_loop(cond, body, carry0)

        return (
            ct_t + ct_t0x,  # t0: carry start + span-clamp contributions
            ct_t1x,         # t1
            ct_dt,          # dt_init
            ct_y,           # y0
            ct_f0,          # f0_init (FSAL seed; flows through func at t0)
            ct_ys,          # ys_buf_init (pass-through outside save windows)
            ct_sa,          # saveat (interpolation stamps)
            ct_args,
        )

    solve.defvjp(solve_fwd, solve_bwd)
    return solve


def _stamp_like(ref_tree, val_tree):
    """Stamp every leaf of ``val_tree`` with the varying-manual-axes of
    ``ref_tree``'s first leaf (a no-op outside shard_map).

    Under shard_map WITHOUT an axis_name — per-shard-independent step
    control, e.g. per-sample adaptive stepping sharded over a data mesh —
    loop carries initialized from replicated constants (t0, qoldinit,
    done, counters, zeroed telemetry/history buffers) become
    shard-varying after one step because they depend on the sharded
    state, and lax.while_loop/scan require carry input and output types
    (including vma) to match. Adding a 0-valued scalar that carries the
    reference's vma upgrades the types; XLA folds the dead add."""
    leaves = jax.tree_util.tree_leaves(ref_tree)
    if not leaves:
        return val_tree
    vma = tuple(sorted(
        getattr(jax.typeof(leaves[0]), "vma", frozenset()) or ()))
    if not vma:
        return val_tree

    def stamp(l):
        l = jnp.asarray(l)
        have = getattr(jax.typeof(l), "vma", frozenset()) or frozenset()
        need = tuple(a for a in vma if a not in have)
        return jax.lax.pcast(l, need, to="varying") if need else l

    return jax.tree_util.tree_map(stamp, val_tree)


def _materialize(ct, zeros):
    """Replace symbolic-zero cotangents with concrete zeros."""
    if ct is None or (hasattr(ct, "dtype") and ct.dtype == jax.dtypes.float0):
        return zeros
    return ct


def _materialize_tree(ct, like):
    return jax.tree_util.tree_map(
        lambda c, l: _materialize(c, jnp.zeros(l.shape, l.dtype)), ct, like,
        is_leaf=lambda x: x is None,
    )


def odeint(
    func: Callable[[Any, Pytree, Any], Pytree],
    y0: Pytree,
    t0,
    t1,
    args: Any = None,
    *,
    solver: str = "tsit5",
    rtol: float = 1e-7,
    atol: float = 1e-7,
    dt0: Optional[float] = None,
    max_steps: int = 256,
    saveat: Optional[jnp.ndarray] = None,
    controller: Optional[PIController] = None,
    mode: str = "scan",
    remat: bool = True,
    axis_name: Optional[str] = None,
    matmul_precision: Optional[str] = "highest",
    stage_sweep: Optional[Callable] = None,
    compensated_eest: bool = False,
    _bwd_precision: Optional[str] = None,
) -> ODESolution:
    """Integrate ``dy/dt = func(t, y, args)`` from ``t0`` to ``t1``.

    Args:
      func: dynamics ``f(t, y, args) -> dy``; ``y`` may be any pytree.
      y0: initial state (pytree of arrays).
      t0, t1: scalars; ``t1 < t0`` integrates backwards (used by FFJORD
        sampling, reference: src/models/ffjord.jl:160-167).
      args: passed through to ``func`` (typically model parameters).
      solver: ``tsit5`` / ``dopri5`` / ``bosh3`` (explicit tableaus) or
        ``rosenbrock23`` (L-stable stiff W-method; ndarray states only —
        see ops.rosenbrock).
      rtol, atol: tolerances; the reference experiments use 1.4e-8
        (reference: experiments/mnist_node.jl:122-123).
      dt0: initial step; ``None`` uses Hairer's heuristic (one extra NFE,
        matching OrdinaryDiffEq's accounting).
      max_steps: trial-step bound of the scan; the solve fails
        (``stats.success == False``) if t1 is not reached within it.
      saveat: optional 1-D array of times at which to emit interpolated
        states (reference: latent ODE's 49 Physionet timestamps,
        experiments/latent_ode.jl:137-147).
      mode: ``"adjoint"`` (differentiable AND early-exit: while_loop
        forward, custom reverse while_loop over live steps only — the
        fast path for training; not twice-differentiable), ``"scan"``
        (differentiable, bounded — the oracle; supports higher-order AD)
        or ``"while"`` (early exit, not reverse-differentiable — for
        inference/NFE measurement).
      remat: checkpoint each step body (scan mode) to bound backward memory.
      axis_name: mesh axis for globally synchronized step control under
        ``shard_map`` data parallelism.
      matmul_precision: matmul precision for everything inside the solve.
        The GPU runs float32 matmuls in TF32 by default, whose rounding
        noise (~1e-3 relative) would swamp the embedded error estimate at
        tight tolerances — the controller then grinds dt to the noise
        floor and NFE explodes. ``"highest"`` (default) keeps full float32
        on the GPU and is a no-op on CPU; pass ``None`` to keep the
        ambient precision for loose-tolerance speed runs.
    """
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return odeint(
                func, y0, t0, t1, args,
                solver=solver, rtol=rtol, atol=atol, dt0=dt0,
                max_steps=max_steps, saveat=saveat, controller=controller,
                mode=mode, remat=remat, axis_name=axis_name,
                matmul_precision=None, stage_sweep=stage_sweep,
                compensated_eest=compensated_eest,
                _bwd_precision=matmul_precision,
            )
    auto_composite = False
    if solver == "rosenbrock23":
        # Stiff path: ode23s W-method plugged in through the stage_sweep
        # contract — same controller, telemetry, saveat, and AD engines.
        if stage_sweep is not None:
            raise ValueError(
                "solver='rosenbrock23' provides its own stage sweep")
        from regneuralde_tpu.ops.rosenbrock import (
            ROSENBROCK23, make_rosenbrock23_sweep)

        tab = ROSENBROCK23
        stage_sweep = make_rosenbrock23_sweep(func)
    elif solver.startswith("auto_"):
        # Stiffness-switching composite, e.g. "auto_tsit5_rosenbrock23"
        # (OrdinaryDiffEq's AutoTsit5(Rosenbrock23()), reference:
        # experiments/mnist_node.jl:70-81).
        ns_name, _, st_name = solver[5:].rpartition("_")
        if st_name != "rosenbrock23" or not ns_name:
            raise ValueError(
                f"unknown composite {solver!r}; use "
                "'auto_<tsit5|dopri5|bosh3>_rosenbrock23'")
        if mode not in ("scan", "while", "adjoint"):
            raise ValueError(
                "auto_* composites support mode='adjoint' (training fast "
                "path; switching state rides the adjoint history), "
                "'scan' (oracle) or 'while'")
        if stage_sweep is not None:
            raise ValueError(
                "auto_* composites provide their own stage sweeps")
        tab = get_tableau(ns_name)
        auto_composite = True
    else:
        tab = get_tableau(solver)
    ctrl = controller or PIController.for_order(tab.order)

    time_dtype = jnp.result_type(jnp.asarray(t0).dtype, jnp.float32)
    t0 = jnp.asarray(t0, time_dtype)
    t1 = jnp.asarray(t1, time_dtype)

    # Per-shard-independent step control inside a shard_map region (no
    # axis_name; detected via the state's varying-manual-axes): stamp the
    # replicated differentiable inputs shard-varying ONCE at entry.
    # Without this, every op mixing replicated params with varying state
    # gets an implicit pvary whose transpose is a psum_invariant INSIDE
    # the solve loops — and with per-shard trip counts (the whole point
    # of unsynchronized control), shards then execute different numbers
    # of collectives and the all-reduce rendezvous deadlocks. Hoisting
    # the pvary to entry leaves exactly one end-of-backward psum, outside
    # any loop, and the observable gradient (invariant = already
    # all-reduced) is unchanged.
    in_manual = axis_name is None and bool(
        getattr(jax.typeof(jax.tree_util.tree_leaves(y0)[0]), "vma",
                frozenset()) or frozenset()
    )
    if in_manual:
        t0, t1, args = _stamp_like(y0, (t0, t1, args))
        if saveat is not None:
            saveat = _stamp_like(y0, jnp.asarray(saveat, time_dtype))

    tdir = jnp.sign(t1 - t0)
    span = jnp.abs(t1 - t0)

    f_init = func(t0, y0, args)
    nfe_init = 1
    if dt0 is None:
        dt_init, _ = initial_step_size(
            func, t0, y0, f_init, args, tab.order, rtol, atol, t1, axis_name=axis_name
        )
        nfe_init = 2
    else:
        dt_init = jnp.asarray(dt0, time_dtype) * tdir

    ys_buf = None
    if saveat is not None:
        saveat = jnp.asarray(saveat, time_dtype)
        ys_buf = jax.tree_util.tree_map(
            lambda l: jnp.zeros((saveat.shape[0],) + l.shape, l.dtype), y0
        )
        # Entries at/before t0 hold the initial state (OrdinaryDiffEq saves
        # u0 when saveat contains t0).
        at_start = (saveat - t0) * tdir <= 0
        ys_buf = jax.tree_util.tree_map(
            lambda buf, y0l: jnp.where(
                at_start.reshape((-1,) + (1,) * y0l.ndim), y0l[None], buf
            ),
            ys_buf,
            y0,
        )

    err_dtype = jnp.promote_types(time_dtype, jnp.float32)
    init = _Carry(
        t=t0,
        dt=dt_init.astype(time_dtype),
        qold=jnp.asarray(ctrl.qoldinit, err_dtype),
        y=y0,
        f0=f_init,
        done=span == 0,
        step=jnp.asarray(0, jnp.int32),
        naccept=jnp.asarray(0, jnp.int32),
        nreject=jnp.asarray(0, jnp.int32),
        ys_buf=ys_buf,
    )

    if compensated_eest and (stage_sweep is not None or auto_composite
                             or solver == "rosenbrock23"):
        raise ValueError(
            "compensated_eest applies to the generic explicit-RK sweep "
            "only (no stage_sweep, no rosenbrock/auto_* solvers)")
    step_fn, noop_fn = _make_step_fn(
        func, args, tab, ctrl, t1, tdir, span, rtol, atol, saveat, axis_name,
        stage_sweep=stage_sweep, compensated=compensated_eest,
    )

    n_stages_stiff = 0
    if auto_composite:
        from regneuralde_tpu.ops.rosenbrock import (
            ROSENBROCK23, make_rosenbrock23_sweep)

        n_stages_stiff = ROSENBROCK23.num_stages
        ctrl_st = controller or PIController.for_order(ROSENBROCK23.order)
        step_st, _ = _make_step_fn(
            func, args, ROSENBROCK23, ctrl_st, t1, tdir, span, rtol, atol,
            saveat, axis_name,
            stage_sweep=make_rosenbrock23_sweep(func),
        )
        step_fn, noop_fn = _make_auto_step(
            step_fn, noop_fn, step_st, tab.stability_size)
        zero_i = jnp.asarray(0, jnp.int32)
        init = init._replace(aux=(zero_i, zero_i, zero_i))

    if mode == "adjoint":
        step_builder = None
        aux0 = ()
        if auto_composite:
            from regneuralde_tpu.ops.rosenbrock import (
                ROSENBROCK23, make_rosenbrock23_sweep)

            ctrl_st = controller or PIController.for_order(
                ROSENBROCK23.order)

            def step_builder(t0_, t1_, saveat_, args_):
                tdir_ = jnp.sign(t1_ - t0_)
                span_ = jnp.abs(t1_ - t0_)
                s_ns, n_ns = _make_step_fn(
                    func, args_, tab, ctrl, t1_, tdir_, span_, rtol, atol,
                    saveat_, axis_name, stage_sweep=None)
                s_st, _ = _make_step_fn(
                    func, args_, ROSENBROCK23, ctrl_st, t1_, tdir_, span_,
                    rtol, atol, saveat_, axis_name,
                    stage_sweep=make_rosenbrock23_sweep(func))
                s, _ = _make_auto_step(s_ns, n_ns, s_st,
                                       tab.stability_size)
                return s

            zero_i = jnp.asarray(0, jnp.int32)
            aux0 = (zero_i, zero_i, zero_i)
        solve = _make_adjoint_solve(
            func, tab, ctrl, rtol, atol, saveat is not None, axis_name,
            stage_sweep, max_steps, time_dtype, err_dtype, _bwd_precision,
            step_builder=step_builder, aux0=aux0,
            compensated=compensated_eest,
        )
        ys_init = ys_buf if ys_buf is not None else ()
        sa_arg = saveat if saveat is not None else ()
        (y1, ys_out, tel, _tf, _dtf, _qoldf, naccept, nreject, done,
         aux_f) = solve(t0, t1, init.dt, y0, f_init, ys_init, sa_arg, args)
        nsteps = naccept + nreject
        nfe = (jnp.asarray(nfe_init, jnp.int32)
               + (tab.num_stages - 1) * nsteps)
        if auto_composite:
            nfe = nfe + (n_stages_stiff - tab.num_stages) * aux_f[2]
        stats = ODEStats(
            nfe=nfe,
            naccept=naccept,
            nreject=nreject,
            success=done,
        )
        return ODESolution(
            y1=y1,
            ys=ys_out if saveat is not None else None,
            ts=saveat,
            stats=stats,
            telemetry=tel,
        )

    if mode == "scan":
        if in_manual:
            # Replace the done-branch lax.cond with an explicit masked
            # select (what vmap lowers the cond to anyway) so no
            # branch-type matching is involved, and stamp the initial
            # carry to the step outputs' vma (see _stamp_like).
            def body(c):
                new_s, out_s = step_fn(c)
                new_n, out_n = noop_fn(c)
                pick = lambda a, b: jax.tree_util.tree_map(
                    lambda x, y: jnp.where(c.done, x, y), a, b)
                return pick(new_n, new_s), pick(out_n, out_s)

            init = _stamp_like(y0, init)
        else:
            body = lambda c: lax.cond(c.done, noop_fn, step_fn, c)
        if remat:
            body = jax.checkpoint(body)

        def scan_body(carry, _):
            return body(carry)

        final, tel = lax.scan(scan_body, init, None, length=max_steps)
    elif mode == "while":
        tel0 = StepTelemetry(
            t=jnp.zeros((max_steps,), time_dtype),
            dt=jnp.zeros((max_steps,), time_dtype),
            eest=jnp.zeros((max_steps,), err_dtype),
            eigen_est=jnp.zeros((max_steps,), err_dtype),
            accepted=jnp.zeros((max_steps,), bool),
            live=jnp.zeros((max_steps,), bool),
        )
        # Per-shard-independent solves under shard_map (no axis_name):
        # while_loop does no carry-vma unification (unlike lax.scan), so
        # carries seeded from replicated constants must be stamped with
        # the state's vma up front (see _stamp_like).
        if axis_name is None:
            init = _stamp_like(y0, init)
            tel0 = _stamp_like(y0, tel0)

        def while_cond(state):
            carry, _ = state
            return (~carry.done) & (carry.step < max_steps)

        def while_body(state):
            carry, bufs = state
            i = carry.step
            carry2, out = step_fn(carry)
            bufs2 = StepTelemetry(
                *[b.at[i].set(o) for b, o in zip(bufs, out)]
            )
            return carry2, bufs2

        final, tel = lax.while_loop(while_cond, while_body, (init, tel0))
    else:
        raise ValueError(
            f"unknown mode {mode!r}; use 'adjoint', 'scan' or 'while'"
        )

    nsteps = final.naccept + final.nreject
    nfe = jnp.asarray(nfe_init, jnp.int32) + (tab.num_stages - 1) * nsteps
    if auto_composite:
        # The two arms cost different fresh f evaluations per trial step;
        # final.aux[2] counts the trial steps the stiff arm executed.
        n_stiff = final.aux[2]
        nfe = nfe + (n_stages_stiff - tab.num_stages) * n_stiff
    stats = ODEStats(
        nfe=nfe,
        naccept=final.naccept,
        nreject=final.nreject,
        success=final.done,
    )
    return ODESolution(
        y1=final.y,
        ys=final.ys_buf,
        ts=saveat,
        stats=stats,
        telemetry=tel,
    )

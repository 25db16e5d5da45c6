"""Per-lane-controller batched engine for per-sample adaptive stepping.

The vmap engine (:mod:`regneuralde_tpu.ops.per_sample`) is semantically
exact but pays a heavy cost: under ``jax.vmap`` each lane's
history/save updates index by that lane's OWN step counter, so XLA
lowers every per-step ``dynamic_update_slice`` into a full-buffer masked
update (``tools/bench_per_sample.py`` times the engines side by side).

This engine instead runs per-sample control DIRECTLY on the batched
state, the way torchode does on GPU (PAPERS.md):

* The whole batch advances in lockstep iterations; the stage sweep stays
  a full ``(batch, dim)`` matmul every iteration — no per-lane loop,
  no singleton batches.
* Controller state is vectorized per lane: ``t``, ``dt``, ``qold``,
  ``done``, accept/reject, and the tolerance-normalized error norm are
  ``(batch,)`` rows (``EEst_i = rms(err_i / (atol + max|y_i| rtol))``
  along features only — exactly what the vmap engine's per-lane
  ``hairer_norm`` computes on its ``(1, dim)`` leaf).
* Finished lanes freeze: their state stops updating and their telemetry
  rows mark ``live=False``; wall clock is set by the slowest lane (the
  same "iterate while any lane runs" schedule vmap produces), but every
  buffer write is a dense full-batch store — nothing scatters.
* Time enters the dynamics as a ``(batch,)`` vector (every lane sits at
  its own ``t_i``); ``models.basic._t_row`` maps it to the standard
  ``(batch, 1)`` time column, so batched dynamics modules run unchanged.

Two gradient modes (mirroring :func:`regneuralde_tpu.ops.odeint`):

* ``mode="adjoint"`` (default): ``lax.while_loop`` forward that EXITS as
  soon as every lane is done (the bounded scan executes all ``max_steps``
  iterations while typically ~half are live), storing the per-iteration
  step-start carry; a hand-written ``custom_vjp`` backward replays ONLY
  the executed iterations in a reverse while_loop — the exact discrete
  adjoint through every accepted and rejected step, per lane. Not
  twice-differentiable (the backward is itself a while_loop).
* ``mode="scan"``: bounded ``lax.scan`` with per-step remat; ordinary
  reverse-mode AD traces through it, so it supports higher-order AD and
  is the oracle the adjoint mode is pinned against
  (tests/test_per_sample.py).

``saveat`` (a shared ``(n_save,)`` grid or a per-sample
``(batch, n_save)`` grid — each sample decoded at its OWN stamps) is
supported in both modes as a DENSE masked Hermite write: every accepted
step interpolates all its covered save points for the whole batch in
one ``(batch, n_save, dim)`` ``where`` — no per-lane save cursor, no
scattering (the very op class that makes the vmap engine slow).

Scope (prototype boundaries, checked with clear errors): single 2-D
array state, explicit FSAL tableaus (tsit5/bosh3/dopri5).

Reference relation: the reference solves the whole batch as ONE ODE
state with one global norm (src/models/neural_ode.jl:62); per-sample
control is a capability beyond it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from regneuralde_tpu.ops.controller import PIController
from regneuralde_tpu.ops.ode import (
    ODESolution,
    ODEStats,
    StepTelemetry,
    _materialize,
    _materialize_tree,
    _stamp_like,
)
from regneuralde_tpu.ops.tableaus import get_tableau

__all__ = ["odeint_per_sample_batched"]

f32 = jnp.float32


def _row_norm(x: jnp.ndarray) -> jnp.ndarray:
    """Hairer RMS norm along features, per batch row; sqrt'(0)-safe."""
    ssq = jnp.sum(x * x, axis=-1)
    count = x.shape[-1]
    return jnp.where(ssq > 0, jnp.sqrt(jnp.where(ssq > 0, ssq, 1.0) / count), 0.0)


def _per_lane_initial_dt(func, t0, y0, f0, args, order, rtol, atol, t1):
    """Hairer's automatic initial dt (controller.initial_step_size) with
    every norm taken per lane — each sample gets its own dt0, exactly
    what the vmap engine computes per lane. One extra (batched) dynamics
    evaluation, mirroring the +1 NFE of the scalar version."""
    tdir = jnp.sign(t1 - t0)
    span = jnp.abs(t1 - t0)

    def scaled(v):
        return v / (atol + jnp.abs(y0) * rtol)

    d0 = _row_norm(scaled(y0))
    d1 = _row_norm(scaled(f0))
    dt0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), jnp.asarray(1e-6, d0.dtype),
                    0.01 * d0 / jnp.maximum(d1, 1e-30))
    dt0 = jnp.minimum(dt0, span)

    y1 = y0 + (tdir * dt0)[:, None] * f0
    f1 = func(t0 + tdir * dt0, y1, args)
    d2 = _row_norm(scaled(f1 - f0)) / jnp.maximum(dt0, 1e-30)

    dmax = jnp.maximum(d1, d2)
    dt1 = jnp.where(dmax <= 1e-15, jnp.maximum(1e-6, dt0 * 1e-3),
                    (0.01 / jnp.maximum(dmax, 1e-30)) ** (1.0 / (order + 1)))
    dt = jnp.minimum(jnp.minimum(100.0 * dt0, dt1), span)
    return tdir * dt, f1


def _make_step_core(func, tab, ctrl, rtol, atol, has_saveat):
    """One per-lane-controlled trial step on the full batch.

    Returns ``core(t, dt, qold, y, f0c, done, ys_buf, t0v, t1v, saveat,
    args)`` → ``(t_new, dt_out, qold_out, y_out, f0_out, done_new,
    ys_out, accept, live, tel_row)``. Pure in its arguments so the
    adjoint mode can ``jax.vjp`` the SAME function the forward ran
    (bitwise-faithful replay from the stored step-start carry).
    ``ys_buf``/``saveat`` are ``()`` when ``has_saveat`` is false;
    otherwise ``ys_buf`` is ``(batch, n_save, dim)`` (internal layout —
    the batch-major write is one dense fused ``where``) and ``saveat``
    is ``(batch, n_save)``.
    """
    n_stages = tab.num_stages

    def core(t, dt, qold, y, f0c, done, ys_buf, t0v, t1v, saveat, args):
        tdir = jnp.sign(t1v - t0v)
        span = jnp.abs(t1v - t0v)
        live = ~done

        remaining = t1v - t
        is_last = (dt - remaining) * tdir >= 0
        dt_eff = jnp.where(is_last, remaining, dt)
        de = dt_eff[:, None]

        # FSAL stage sweep on the full batch; per-lane dt/t broadcast
        # as columns. Accumulation order matches ops.norms.tree_lincomb
        # (k-combination first, one dt multiply, zero coeffs skipped)
        # and the btilde terms are differenced against k1 (the same
        # f32 cancellation fix as ops.ode's generic_sweep) so the
        # per-lane controller sees the same EEst roundoff as the vmap
        # engine.
        def lincomb(base, coeffs, kl):
            nz = [(c, k) for c, k in zip(coeffs, kl) if c != 0.0]
            if not nz:
                return base
            acc = nz[0][0] * nz[0][1]
            for c_ij, kj in nz[1:]:
                acc = acc + c_ij * kj
            return base + de * acc

        ks = [f0c]
        y_stage = y
        for i in range(1, n_stages):
            y_stage = lincomb(y, tab.a[i - 1], ks)
            ks.append(func(t + tab.c[i] * dt_eff, y_stage, args))
        y_new = y_stage  # b row == last a row (FSAL)
        g_prev = lincomb(y, tab.a[n_stages - 3], ks[: n_stages - 2])
        k_last, k_prev = ks[-1], ks[-2]

        err = de * sum(
            c * (kl - ks[0]) for c, kl in zip(tab.btilde[1:], ks[1:]))
        scaled = err / (atol + jnp.maximum(jnp.abs(y), jnp.abs(y_new)) * rtol)
        eest = _row_norm(scaled)

        eig_num = _row_norm(k_last - k_prev)
        eig_den = _row_norm(y_new - g_prev)
        eigen_est = jnp.where(eig_den > 0,
                              eig_num / jnp.maximum(eig_den, 1e-30), 0.0)

        accept = eest <= 1.0
        dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
        dt_next = jnp.sign(dt_next) * jnp.minimum(jnp.abs(dt_next), span)

        upd = accept & live
        t_new = jnp.where(upd, jnp.where(is_last, t1v, t + dt_eff), t)
        done_new = done | (accept & is_last & live)
        y_out = jnp.where(upd[:, None], y_new, y)
        f0_out = jnp.where(upd[:, None], k_last, f0c)
        dt_out = jnp.where(live, dt_next, dt)
        qold_out = jnp.where(live, qold_next, qold)

        ys_out = ys_buf
        if has_saveat:
            # Dense masked Hermite write: same window/interpolant as the
            # global engine (ops.ode._make_step_fn / _hermite_eval), per
            # lane. One fused (batch, n_save, dim) where per trial step.
            t_end = jnp.where(is_last, t1v, t + dt_eff)
            win = (upd[:, None]
                   & ((saveat - t[:, None]) * tdir[:, None] > 0)
                   & ((saveat - t_end[:, None]) * tdir[:, None] <= 0))
            th = ((saveat - t[:, None])
                  / jnp.where(de == 0, 1.0, de))[:, :, None]
            hh = dt_eff[:, None, None]
            yb, ynb = y[:, None, :], y_new[:, None, :]
            dy = ynb - yb
            yi = ((1 - th) * yb + th * ynb
                  + th * (th - 1) * ((1 - 2 * th) * dy
                                     + (th - 1) * hh * f0c[:, None, :]
                                     + th * hh * k_last[:, None, :]))
            ys_out = jnp.where(win[:, :, None], yi, ys_buf)

        zero = jnp.zeros_like(t)
        tel_row = StepTelemetry(
            t=jnp.where(live, jnp.where(is_last, t1v, t + dt_eff), zero),
            dt=jnp.where(live, dt_eff, zero),
            eest=jnp.where(live, eest, zero),
            eigen_est=jnp.where(live, eigen_est, zero),
            accepted=accept & live,
            live=live,
        )
        return (t_new, dt_out, qold_out, y_out, f0_out, done_new, ys_out,
                accept, live, tel_row)

    return core


# ---------------------------------------------------------------------------
# mode="adjoint": early-exit while_loop forward + custom_vjp backward that
# replays only the iterations the forward executed (per-lane analogue of
# ops.ode._make_adjoint_solve — the scan mode's dead iterations past the
# slowest lane's finish are pure waste).
# ---------------------------------------------------------------------------


def _make_adjoint_solve(core, ctrl, max_steps, batch, dim, matmul_precision):
    def replay(t, dt, qold, y, f0c, done, ys_buf, t0v, t1v, saveat, args):
        """Differentiable outputs of one stored trial step. ``done`` is
        boolean (nondiff; float0 cotangent dropped by the caller).
        ``ys_buf`` is passed as zeros during the backward replay — the
        step's ys output is ``where(window, interp, ys_in)``, linear in
        ``ys_in`` with value-independent coefficients, so its vjp is
        exact regardless of the primal buffer contents (same trick as
        ops.ode._make_adjoint_solve)."""
        (t_new, dt_out, qold_out, y_out, f0_out, _done_new, ys_out, _acc,
         _live, tel) = core(t, dt, qold, y, f0c, done, ys_buf, t0v, t1v,
                            saveat, args)
        return (t_new, dt_out, qold_out, y_out, f0_out, ys_out,
                tel.t, tel.dt, tel.eest, tel.eigen_est)

    def _forward(t0v, t1v, dt_init, y0, f0_init, ys_buf_init, saveat,
                 args):
        tel0 = StepTelemetry(
            t=jnp.zeros((max_steps, batch), f32),
            dt=jnp.zeros((max_steps, batch), f32),
            eest=jnp.zeros((max_steps, batch), f32),
            eigen_est=jnp.zeros((max_steps, batch), f32),
            accepted=jnp.zeros((max_steps, batch), bool),
            live=jnp.zeros((max_steps, batch), bool),
        )
        hist0 = (
            jnp.zeros((max_steps, batch), f32),        # t
            jnp.zeros((max_steps, batch), f32),        # dt
            jnp.zeros((max_steps, batch), f32),        # qold
            jnp.zeros((max_steps, batch, dim), y0.dtype),  # y
            jnp.zeros((max_steps, batch, dim), y0.dtype),  # f0
            jnp.zeros((max_steps, batch), bool),       # done at step start
        )
        zi = jnp.zeros((batch,), jnp.int32)
        init = (jnp.asarray(0, jnp.int32), t0v, dt_init,
                jnp.full((batch,), ctrl.qoldinit, f32), y0, f0_init,
                jnp.zeros((batch,), bool), ys_buf_init, zi, zi)
        # Per-shard-independent solves under shard_map (see ode._stamp_like).
        init = _stamp_like(y0, init)
        tel0 = _stamp_like(y0, tel0)
        hist0 = _stamp_like(y0, hist0)

        def cond(state):
            (it, _t, _dt, _q, _y, _f, done, _ys, _na, _nr), _, _ = state
            return jnp.any(~done) & (it < max_steps)

        def body(state):
            (it, t, dt, qold, y, f0c, done, ys_buf, na, nr), tel, hist = state
            hist = (
                hist[0].at[it].set(t), hist[1].at[it].set(dt),
                hist[2].at[it].set(qold), hist[3].at[it].set(y),
                hist[4].at[it].set(f0c), hist[5].at[it].set(done),
            )
            (t_new, dt_out, qold_out, y_out, f0_out, done_new, ys_out,
             accept, live, row) = core(t, dt, qold, y, f0c, done, ys_buf,
                                       t0v, t1v, saveat, args)
            tel = StepTelemetry(*[b.at[it].set(o) for b, o in zip(tel, row)])
            na = na + (accept & live).astype(jnp.int32)
            nr = nr + ((~accept) & live).astype(jnp.int32)
            return ((it + 1, t_new, dt_out, qold_out, y_out, f0_out,
                     done_new, ys_out, na, nr), tel, hist)

        (it, tf, dtf, qoldf, y1, _ff, done, ys, na, nr), tel, hist = (
            lax.while_loop(cond, body, (init, tel0, hist0)))
        outs = (y1, tel, ys, tf, dtf, qoldf, done, na, nr)
        return outs, (hist, it)

    @jax.custom_vjp
    def solve(t0v, t1v, dt_init, y0, f0_init, ys_buf_init, saveat, args):
        outs, _ = _forward(t0v, t1v, dt_init, y0, f0_init, ys_buf_init,
                           saveat, args)
        return outs

    def solve_fwd(t0v, t1v, dt_init, y0, f0_init, ys_buf_init, saveat,
                  args):
        outs, (hist, n_iters) = _forward(t0v, t1v, dt_init, y0, f0_init,
                                         ys_buf_init, saveat, args)
        return outs, (hist, n_iters, t0v, t1v, y0, f0_init, ys_buf_init,
                      saveat, args)

    def solve_bwd(res, cts):
        # PRECISION IS LOAD-BEARING: traced lazily OUTSIDE the forward's
        # default_matmul_precision context; the replay re-traces the
        # dynamics' contractions here. At the GPU's TF32 default (~1e-3
        # relative) the EEst/controller pullback picks up noise that the
        # ~1/tol amplification turns into garbage gradients (see
        # ops.ode._make_adjoint_solve and the batched-engine chip test in
        # tests/test_on_device.py).
        if matmul_precision is not None:
            with jax.default_matmul_precision(matmul_precision):
                return _solve_bwd_impl(res, cts)
        return _solve_bwd_impl(res, cts)

    def _solve_bwd_impl(res, cts):
        (hist, n_iters, t0v, t1v, y0, f0_init, ys_buf_init, saveat,
         args) = res
        (ct_y1, ct_tel, ct_ys_out, ct_tf, ct_dtf, ct_qoldf, _ct_done,
         _ct_na, _ct_nr) = cts

        def zlike(tree):
            return jax.tree_util.tree_map(jnp.zeros_like, tree)

        ys_zero = zlike(ys_buf_init)
        zrow = lambda: jnp.zeros((batch,), f32)
        carry0 = (
            n_iters - 1,
            _materialize(ct_tf, zrow()),
            _materialize(ct_dtf, zrow()),
            _materialize(ct_qoldf, zrow()),
            _materialize_tree(ct_y1, y0),
            jnp.zeros_like(f0_init),  # ct on the carried FSAL derivative
            _materialize_tree(ct_ys_out, ys_buf_init),
            zlike(saveat),            # accumulated ct into saveat
            zrow(),                   # accumulated ct into t0v (span)
            zrow(),                   # accumulated ct into t1v
            zlike(args),
        )
        carry0 = _stamp_like(hist[3], carry0)

        zbuf = lambda: jnp.zeros((max_steps, batch), f32)
        ct_tel_t = _materialize(ct_tel.t, zbuf())
        ct_tel_dt = _materialize(ct_tel.dt, zbuf())
        ct_tel_eest = _materialize(ct_tel.eest, zbuf())
        ct_tel_eig = _materialize(ct_tel.eigen_est, zbuf())

        def cond(state):
            return state[0] >= 0

        def body(state):
            (i, ct_t, ct_dt, ct_qold, ct_y, ct_f0, ct_ys, ct_sa, ct_t0x,
             ct_t1x, ct_args) = state
            prim = (hist[0][i], hist[1][i], hist[2][i], hist[3][i],
                    hist[4][i], hist[5][i], ys_zero, t0v, t1v, saveat,
                    args)
            _, vjp_fn = jax.vjp(replay, *prim)
            (d_t, d_dt, d_qold, d_y, d_f0, _d_done, d_ys, d_t0, d_t1,
             d_sa, d_args) = vjp_fn(
                (ct_t, ct_dt, ct_qold, ct_y, ct_f0, ct_ys,
                 ct_tel_t[i], ct_tel_dt[i], ct_tel_eest[i], ct_tel_eig[i]))
            return (i - 1, d_t, d_dt, d_qold, d_y, d_f0, d_ys,
                    jax.tree_util.tree_map(jnp.add, ct_sa, d_sa),
                    ct_t0x + d_t0, ct_t1x + d_t1,
                    jax.tree_util.tree_map(jnp.add, ct_args, d_args))

        (_, ct_t, ct_dt, _ct_qold, ct_y, ct_f0, ct_ys, ct_sa, ct_t0x,
         ct_t1x, ct_args) = lax.while_loop(cond, body, carry0)

        return (
            ct_t + ct_t0x,  # t0v: the t carried into step 0, + span clamps
            ct_t1x,         # t1v
            ct_dt,          # dt_init
            ct_y,           # y0
            ct_f0,          # f0_init (FSAL seed; flows through func at t0)
            ct_ys,          # ys_buf_init (pass-through outside windows)
            ct_sa,          # saveat (interpolation stamps)
            ct_args,
        )

    solve.defvjp(solve_fwd, solve_bwd)
    return solve


def odeint_per_sample_batched(
    func: Callable,
    y0: jnp.ndarray,
    t0,
    t1,
    args: Any = None,
    *,
    solver: str = "tsit5",
    rtol: float = 1e-6,
    atol: float = 1e-6,
    dt0: Optional[float] = None,
    max_steps: int = 256,
    mode: str = "adjoint",
    saveat: Optional[jnp.ndarray] = None,
    controller: Optional[PIController] = None,
    remat: bool = True,
    matmul_precision: Optional[str] = "highest",
) -> ODESolution:
    """Integrate every batch row under its own adaptive controller, as
    one dense batched program (see module docstring).

    Args/returns match :func:`odeint_per_sample` for a single 2-D state:
    ``stats`` fields are per-sample ``(batch,)`` vectors, ``telemetry``
    streams are ``(batch, max_steps)``. ``saveat`` is a shared
    ``(n_save,)`` grid or a per-sample ``(batch, n_save)`` grid;
    ``ys`` comes back ``(n_save, batch, dim)`` (the engine convention).
    ``mode`` selects the gradient engine: ``"adjoint"`` (early-exit
    while_loop + hand-written custom_vjp backward over only the executed
    iterations; the default) or ``"scan"`` (bounded remat'd scan, traced
    AD, twice-differentiable).

    ``matmul_precision`` mirrors :func:`odeint`'s default: reduced-
    precision dots (TF32 on the GPU) flood the embedded error estimate at
    tight tolerances and every lane runs to the ``max_steps`` cap. Both
    the traced scan gradient and the adjoint mode's lazily-traced
    backward bake it in.
    """
    if mode not in ("adjoint", "scan"):
        raise ValueError(
            f"mode must be 'adjoint' or 'scan' for the batched per-sample "
            f"engine, got {mode!r} (engine='vmap' also offers 'while')")
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return _run(func, y0, t0, t1, args, solver, rtol, atol, dt0,
                        max_steps, mode, saveat, controller, remat,
                        matmul_precision)
    return _run(func, y0, t0, t1, args, solver, rtol, atol, dt0, max_steps,
                mode, saveat, controller, remat, None)


def _run(func, y0, t0, t1, args, solver, rtol, atol, dt0, max_steps, mode,
         saveat, controller, remat, matmul_precision):
    y0 = jnp.asarray(y0)
    if y0.ndim != 2:
        raise ValueError(
            f"the batched per-sample engine needs a 2-D (batch, dim) "
            f"state, got shape {y0.shape}; use engine='vmap' for pytree "
            f"states")
    tab = get_tableau(solver)
    if not tab.fsal:
        raise NotImplementedError("only FSAL tableaus are supported")
    ctrl = controller or PIController.for_order(tab.order)
    batch, dim = y0.shape

    t0v = jnp.broadcast_to(jnp.asarray(t0, f32), (batch,))
    t1v = jnp.broadcast_to(jnp.asarray(t1, f32), (batch,))
    tdir = jnp.sign(t1v - t0v)
    span = jnp.abs(t1v - t0v)

    shared_grid = False
    if saveat is not None:
        saveat = jnp.asarray(saveat, f32)
        shared_grid = saveat.ndim == 1
        if shared_grid:
            saveat = jnp.broadcast_to(saveat[None], (batch, saveat.shape[0]))
        if saveat.ndim != 2 or saveat.shape[0] != batch:
            raise ValueError(
                f"saveat must be (n_save,) or ({batch}, n_save); got "
                f"shape {saveat.shape}")
        # Entries at/before each lane's t0 hold the initial state
        # (OrdinaryDiffEq saves u0 when saveat contains t0 — same
        # seeding as ops.odeint).
        at_start = (saveat - t0v[:, None]) * tdir[:, None] <= 0
        ys0 = jnp.where(at_start[:, :, None],
                        y0[:, None, :],
                        jnp.zeros((batch, saveat.shape[1], dim), y0.dtype))
    else:
        ys0 = ()
        saveat = ()

    f0 = func(t0v, y0, args)
    if dt0 is None:
        dt_init, _ = _per_lane_initial_dt(
            func, t0v, y0, f0, args, tab.order, rtol, atol, t1v)
        nfe_init = 2
    else:
        dt_init = jnp.broadcast_to(jnp.asarray(dt0, f32), (batch,)) * tdir
        nfe_init = 1

    has_saveat = not isinstance(saveat, tuple)
    core = _make_step_core(func, tab, ctrl, rtol, atol, has_saveat)
    n_stages = tab.num_stages

    if mode == "adjoint":
        solve = _make_adjoint_solve(core, ctrl, max_steps, batch, dim,
                                    matmul_precision)
        y1, tel, ys, _tf, _dtf, _qoldf, done, na, nr = solve(
            t0v, t1v, dt_init, y0, f0, ys0, saveat, args)
    else:
        def body(carry, _):
            t, dt, qold, y, f0c, done, ys_buf, na, nr = carry
            (t_new, dt_out, qold_out, y_out, f0_out, done_new, ys_out,
             accept, live, row) = core(t, dt, qold, y, f0c, done, ys_buf,
                                       t0v, t1v, saveat, args)
            na_out = na + (accept & live).astype(jnp.int32)
            nr_out = nr + ((~accept) & live).astype(jnp.int32)
            return (t_new, dt_out, qold_out, y_out, f0_out, done_new,
                    ys_out, na_out, nr_out), row

        if remat:
            body = jax.checkpoint(body)

        qold0 = jnp.full((batch,), ctrl.qoldinit, f32)
        done0 = jnp.zeros((batch,), bool)
        zi = jnp.zeros((batch,), jnp.int32)
        carry0 = (t0v, dt_init, qold0, y0, f0, done0, ys0, zi, zi)
        (tf, _dtf, _qf, y1, _ff, done, ys, na, nr), tel = lax.scan(
            body, carry0, None, length=max_steps)

    nfe = nfe_init + (n_stages - 1) * (na + nr)
    stats = ODEStats(nfe=nfe, naccept=na, nreject=nr, success=done)
    # (max_steps, batch) -> the per-sample convention (batch, max_steps)
    tel = StepTelemetry(*(jnp.swapaxes(s, 0, 1) for s in tel))
    if has_saveat:
        # internal (batch, n_save, dim) -> engine convention
        # (n_save, batch, dim); ts mirrors odeint_per_sample's contract.
        ys_out = jnp.swapaxes(ys, 0, 1)
        ts = saveat[0] if shared_grid else saveat
        return ODESolution(y1=y1, ys=ys_out, ts=ts, stats=stats,
                           telemetry=tel)
    return ODESolution(y1=y1, ys=None, ts=None, stats=stats, telemetry=tel)

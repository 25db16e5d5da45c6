"""Per-lane-controller batched engine for per-sample adaptive SDE stepping.

The SDE twin of :mod:`regneuralde_tpu.ops.per_sample_batched`. The vmap
engine (:func:`regneuralde_tpu.ops.per_sample.sdeint_per_sample`) is
semantically exact but pays the same cost class as its ODE sibling
(per-lane dynamic-update-slices lower to full-buffer masked updates
under vmap).
This engine runs per-sample control DIRECTLY on the batched state:

* The whole batch advances in lockstep iterations; every SRI stage
  evaluation stays a full ``(batch, dim)`` matmul. ``sri_step`` is
  shape-generic, so the SAME tableau code the global ``sdeint`` runs is
  reused with per-lane ``(batch, 1)`` time/dt columns — per-lane math is
  op-for-op the vmap engine's.
* Controller state (``t``, ``dt``, ``qold``, ``done``, EEst) is
  vectorized per lane; ``EEst_i`` is the row RMS of the
  tolerance-scaled residual — exactly the vmap engine's per-lane
  ``error_ratio`` on its ``(1, dim)`` leaf.
* **Per-lane Brownian paths with rejection bridging**: each lane carries
  its own collapse-scheme tail ``(h, w, z)`` (``ops.sde._Tail``); one
  lane's rejection never perturbs another's increments. The fresh
  normal draws are PRESAMPLED per lane with the exact key chain
  ``sdeint`` consumes (``sde.presample_noise`` under ``vmap``
  over ``jax.random.split(key, batch)``), so lane *i* reproduces
  ``sdeint(..., key=split(key, batch)[i])`` on that sample alone,
  draw for draw — the vmap engine's documented contract.
* Finished lanes freeze (state, tail, telemetry ``live=False``); their
  sweep runs on harmless synthetic ``(t, dt)`` so ``sqrt(dt)`` and the
  ``1/dt`` stochastic-integral scalings never see ``dt == 0`` (the
  0-cotangent-times-inf-derivative NaN the global engine documents,
  ops/sde.py mode="scan" manual-axes note).

Gradient modes mirror the ODE batched engine: ``mode="adjoint"``
(early-exit while_loop forward storing the per-iteration step-start
carry incl. the Brownian tail; hand-written custom_vjp backward
replaying ONLY executed iterations) and ``mode="scan"`` (bounded
remat'd scan, traced AD, the oracle the adjoint is pinned against —
tests/test_per_sample.py).

Scope: single 2-D array state, diagonal noise, SRI tableaus
(sosri/sosri2/sriw1), ``brownian="collapse"`` (the default scheme; the
RSwM3 segment stack remains vmap-only). ``saveat`` is a shared
``(n_save,)`` or per-sample ``(batch, n_save)`` grid, written as one
dense masked LINEAR interpolation per accepted step (the global
``sdeint``'s in-step ``lin``).

Reference relation: the reference's Monte-Carlo fan-out repeats the
batch ``trajectories x`` and solves under ONE global controller
(src/models/supervised_classification.jl:92, src/models/neural_sde.jl:44-114);
per-trajectory control is a capability beyond it — and exactly the
workload class where one unlucky trajectory otherwise throttles the
whole fan-out. ``tools/bench_per_sample_sde.py`` times it against
global control.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from regneuralde_tpu.ops.controller import PIController
from regneuralde_tpu.ops.ode import (
    StepTelemetry,
    _materialize,
    _materialize_tree,
    _stamp_like,
)
from regneuralde_tpu.ops.sde import SDESolution, SDEStats
from regneuralde_tpu.ops.sri import (
    diffusion_evals_per_step,
    drift_evals_per_step,
    get_tableau,
    sri_step,
)

__all__ = ["sdeint_per_sample_batched"]

f32 = jnp.float32


def _row_norm(x: jnp.ndarray) -> jnp.ndarray:
    """Hairer RMS norm along features, per batch row; sqrt'(0)-safe."""
    ssq = jnp.sum(x * x, axis=-1)
    count = x.shape[-1]
    return jnp.where(ssq > 0,
                     jnp.sqrt(jnp.where(ssq > 0, ssq, 1.0) / count), 0.0)


def _presample_lanes(key: jax.Array, batch: int, dim: int, dtype,
                     max_steps: int):
    """Per-lane presampled fresh draws ``(max_steps, batch, dim)`` with
    the exact per-lane key chain the vmap engine consumes: lane *i*'s
    rows are ``sde.presample_noise(split(key, batch)[i], (1, dim))``
    — which is itself draw-for-draw ``ops.sde.sdeint``'s split-per-step
    chain (pinned by tests/test_sde.py)."""
    from regneuralde_tpu.ops.sde import presample_noise

    keys = jax.random.split(key, batch)
    xw, xz = jax.vmap(
        lambda k: presample_noise(k, (1, dim), dtype, max_steps))(keys)
    # (batch, max_steps, 1, dim) -> (max_steps, batch, dim)
    return (jnp.moveaxis(xw[:, :, 0], 0, 1),
            jnp.moveaxis(xz[:, :, 0], 0, 1))


def _make_step_core(drift, diffusion, tab, ctrl, rtol, atol, has_saveat):
    """One per-lane-controlled SRI trial step on the full batch.

    Pure in its arguments (the adjoint mode ``jax.vjp``'s the SAME
    function the forward ran). ``xi_w``/``xi_z`` are this iteration's
    presampled fresh draws — nondifferentiable inputs; gradients flow
    into the increments through the bridge's ``dt``-dependent scale and
    the carried tail, exactly as in ``ops.sde.sdeint``."""

    def core(t, dt, qold, y, tail_h, tail_w, tail_z, done, ys_buf,
             xi_w, xi_z, t0v, t1v, saveat, args):
        span = t1v - t0v  # forward-time only for SDEs (tdir = +1)
        live = ~done

        remaining = t1v - t
        is_last = dt >= remaining
        dt_raw = jnp.where(is_last, remaining, dt)
        # Done lanes sit at t == t1 (dt_eff == 0): sqrt(dt) and the
        # 1/dt stochastic-integral scalings are non-differentiable /
        # singular there, and 0-cotangent * inf-derivative = NaN would
        # poison the whole backward. Their outputs are masked out below,
        # so feed them a harmless synthetic step instead.
        span_safe = jnp.maximum(span, 1e-6)
        dt_eff = jnp.where(live, dt_raw, 0.5 * span_safe)
        t_in = jnp.where(live, t, t0v)
        de = dt_eff[:, None]

        # --- Brownian bridge conditioned on the committed per-lane tail
        # (vectorized ops.sde._sample_increment; same guards).
        h = tail_h
        safe_h = jnp.maximum(h, 1e-30)
        inside = dt_eff < h
        frac = jnp.where(inside, dt_eff / safe_h, 1.0)
        var = jnp.where(inside, dt_eff * (h - dt_eff) / safe_h,
                        jnp.maximum(dt_eff - h, 0.0))
        var = jnp.maximum(var, 0.0)
        std = jnp.where(var > 0, jnp.sqrt(jnp.where(var > 0, var, 1.0)),
                        0.0)
        dw = frac[:, None] * tail_w + std[:, None] * xi_w
        dz = frac[:, None] * tail_z + std[:, None] * xi_z
        ins = inside[:, None]
        rem_w = jnp.where(ins, tail_w - dw, 0.0)
        rem_z = jnp.where(ins, tail_z - dz, 0.0)
        tail_h_acc = jnp.where(inside, h - dt_eff, 0.0)

        # --- SRI stage sweep, per-lane (batch, 1) time/dt columns.
        # ``sri_step`` broadcasts them over the (batch, dim) state; the
        # dynamics receive (batch,) time (models.basic._t_row contract).
        drift_b = lambda tt, yy, aa: drift(jnp.squeeze(tt, -1), yy, aa)
        diff_b = lambda tt, yy, aa: diffusion(jnp.squeeze(tt, -1), yy, aa)
        y_new, err, stage_info = sri_step(
            tab, drift_b, diff_b, args, t_in[:, None], y, de, dw, dz)
        scaled = err / (atol + jnp.maximum(jnp.abs(y), jnp.abs(y_new))
                        * rtol)
        eest = _row_norm(scaled)
        accept = eest <= 1.0

        f_a, f_b, h_a, h_b = stage_info
        num = _row_norm(f_b - f_a)
        den = _row_norm(h_b - h_a)
        eigen_est = jnp.where(den > 0, num / jnp.maximum(den, 1e-30), 0.0)

        dt_next, qold_next = ctrl.propose(dt_eff, eest, qold, accept)
        dt_next = jnp.minimum(dt_next, span)

        upd = accept & live
        u = upd[:, None]
        t_new = jnp.where(upd, jnp.where(is_last, t1v, t + dt_eff), t)
        done_new = done | (accept & is_last & live)
        y_out = jnp.where(u, y_new, y)
        lv = live[:, None]
        tail_h_out = jnp.where(live, jnp.where(accept, tail_h_acc, dt_eff),
                               tail_h)
        tail_w_out = jnp.where(lv, jnp.where(u, rem_w, dw), tail_w)
        tail_z_out = jnp.where(lv, jnp.where(u, rem_z, dz), tail_z)
        dt_out = jnp.where(live, dt_next, dt)
        qold_out = jnp.where(live, qold_next, qold)

        ys_out = ys_buf
        if has_saveat:
            # Dense masked LINEAR write (matches ops.sde.sdeint's lin).
            t_end = jnp.where(is_last, t1v, t + dt_eff)
            win = (upd[:, None]
                   & (saveat - t[:, None] > 0)
                   & (saveat - t_end[:, None] <= 0))
            th = ((saveat - t[:, None])
                  / jnp.where(de == 0, 1.0, de))[:, :, None]
            yi = (1 - th) * y[:, None, :] + th * y_new[:, None, :]
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
        return (t_new, dt_out, qold_out, y_out, tail_h_out, tail_w_out,
                tail_z_out, done_new, ys_out, accept, live, tel_row)

    return core


# ---------------------------------------------------------------------------
# mode="adjoint": early-exit while_loop + custom_vjp backward replaying only
# executed iterations — the per-lane SDE analogue of
# per_sample_batched._make_adjoint_solve. The presampled draws are
# nondifferentiable; the stored step-start carry includes the Brownian
# tail, so the replay reproduces the exact sampled path.
# ---------------------------------------------------------------------------


def _make_adjoint_solve(core, ctrl, max_steps, batch, dim,
                        matmul_precision):
    def replay(t, dt, qold, y, th_, tw, tz, done, ys_buf, xi_w, xi_z,
               t0v, t1v, saveat, args):
        (t_new, dt_out, qold_out, y_out, th_o, tw_o, tz_o, _done_new,
         ys_out, _acc, _live, tel) = core(
            t, dt, qold, y, th_, tw, tz, done, ys_buf, xi_w, xi_z,
            t0v, t1v, saveat, args)
        return (t_new, dt_out, qold_out, y_out, th_o, tw_o, tz_o, ys_out,
                tel.t, tel.dt, tel.eest, tel.eigen_est)

    def _forward(t0v, t1v, dt_init, y0, tail0, ys_buf_init, xi_w, xi_z,
                 saveat, args):
        tel0 = StepTelemetry(
            t=jnp.zeros((max_steps, batch), f32),
            dt=jnp.zeros((max_steps, batch), f32),
            eest=jnp.zeros((max_steps, batch), f32),
            eigen_est=jnp.zeros((max_steps, batch), f32),
            accepted=jnp.zeros((max_steps, batch), bool),
            live=jnp.zeros((max_steps, batch), bool),
        )
        hist0 = (
            jnp.zeros((max_steps, batch), f32),            # t
            jnp.zeros((max_steps, batch), f32),            # dt
            jnp.zeros((max_steps, batch), f32),            # qold
            jnp.zeros((max_steps, batch, dim), y0.dtype),  # y
            jnp.zeros((max_steps, batch), f32),            # tail h
            jnp.zeros((max_steps, batch, dim), y0.dtype),  # tail w
            jnp.zeros((max_steps, batch, dim), y0.dtype),  # tail z
            jnp.zeros((max_steps, batch), bool),           # done at start
        )
        zi = jnp.zeros((batch,), jnp.int32)
        init = (jnp.asarray(0, jnp.int32), t0v, dt_init,
                jnp.full((batch,), ctrl.qoldinit, f32), y0,
                tail0[0], tail0[1], tail0[2],
                t1v - t0v == 0, ys_buf_init, zi, zi)
        init = _stamp_like(y0, init)
        tel0 = _stamp_like(y0, tel0)
        hist0 = _stamp_like(y0, hist0)

        def cond(state):
            c, _, _ = state
            return jnp.any(~c[8]) & (c[0] < max_steps)

        def body(state):
            (it, t, dt, qold, y, th_, tw, tz, done, ys_buf, na,
             nr), tel, hist = state
            hist = (
                hist[0].at[it].set(t), hist[1].at[it].set(dt),
                hist[2].at[it].set(qold), hist[3].at[it].set(y),
                hist[4].at[it].set(th_), hist[5].at[it].set(tw),
                hist[6].at[it].set(tz), hist[7].at[it].set(done),
            )
            (t_new, dt_out, qold_out, y_out, th_o, tw_o, tz_o, done_new,
             ys_out, accept, live, row) = core(
                t, dt, qold, y, th_, tw, tz, done, ys_buf,
                xi_w[it], xi_z[it], t0v, t1v, saveat, args)
            tel = StepTelemetry(*[b.at[it].set(o)
                                  for b, o in zip(tel, row)])
            na = na + (accept & live).astype(jnp.int32)
            nr = nr + ((~accept) & live).astype(jnp.int32)
            return ((it + 1, t_new, dt_out, qold_out, y_out, th_o, tw_o,
                     tz_o, done_new, ys_out, na, nr), tel, hist)

        (it, tf, dtf, qoldf, y1, _th, _tw, _tz, done, ys, na,
         nr), tel, hist = lax.while_loop(cond, body, (init, tel0, hist0))
        outs = (y1, tel, ys, tf, dtf, qoldf, done, na, nr)
        return outs, (hist, it)

    @jax.custom_vjp
    def solve(t0v, t1v, dt_init, y0, tail0, ys_buf_init, xi_w, xi_z,
              saveat, args):
        outs, _ = _forward(t0v, t1v, dt_init, y0, tail0, ys_buf_init,
                           xi_w, xi_z, saveat, args)
        return outs

    def solve_fwd(t0v, t1v, dt_init, y0, tail0, ys_buf_init, xi_w, xi_z,
                  saveat, args):
        outs, (hist, n_iters) = _forward(
            t0v, t1v, dt_init, y0, tail0, ys_buf_init, xi_w, xi_z,
            saveat, args)
        return outs, (hist, n_iters, t0v, t1v, y0, ys_buf_init, xi_w,
                      xi_z, saveat, args)

    def solve_bwd(res, cts):
        # PRECISION IS LOAD-BEARING — see per_sample_batched: the
        # custom_vjp backward traces lazily, OUTSIDE the forward's
        # default_matmul_precision context.
        if matmul_precision is not None:
            with jax.default_matmul_precision(matmul_precision):
                return _solve_bwd_impl(res, cts)
        return _solve_bwd_impl(res, cts)

    def _solve_bwd_impl(res, cts):
        (hist, n_iters, t0v, t1v, y0, ys_buf_init, xi_w, xi_z, saveat,
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
            zrow(),                       # ct tail h
            jnp.zeros_like(y0),           # ct tail w
            jnp.zeros_like(y0),           # ct tail z
            _materialize_tree(ct_ys_out, ys_buf_init),
            zlike(saveat),
            zrow(),                       # acc ct t0v
            zrow(),                       # acc ct t1v
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
            (i, ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_ys,
             ct_sa, ct_t0x, ct_t1x, ct_args) = state
            prim = (hist[0][i], hist[1][i], hist[2][i], hist[3][i],
                    hist[4][i], hist[5][i], hist[6][i], hist[7][i],
                    ys_zero, xi_w[i], xi_z[i], t0v, t1v, saveat, args)
            _, vjp_fn = jax.vjp(replay, *prim)
            (d_t, d_dt, d_qold, d_y, d_th, d_tw, d_tz, _d_done, d_ys,
             _d_xw, _d_xz, d_t0, d_t1, d_sa, d_args) = vjp_fn(
                (ct_t, ct_dt, ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_ys,
                 ct_tel_t[i], ct_tel_dt[i], ct_tel_eest[i],
                 ct_tel_eig[i]))
            return (i - 1, d_t, d_dt, d_qold, d_y, d_th, d_tw, d_tz,
                    d_ys,
                    jax.tree_util.tree_map(jnp.add, ct_sa, d_sa),
                    ct_t0x + d_t0, ct_t1x + d_t1,
                    jax.tree_util.tree_map(jnp.add, ct_args, d_args))

        (_, ct_t, ct_dt, _ct_qold, ct_y, ct_th, ct_tw, ct_tz, ct_ys,
         ct_sa, ct_t0x, ct_t1x, ct_args) = lax.while_loop(
            cond, body, carry0)

        return (
            ct_t + ct_t0x,                 # t0v
            ct_t1x,                        # t1v
            ct_dt,                         # dt_init
            ct_y,                          # y0
            (ct_th, ct_tw, ct_tz),         # tail0 (zeros at init)
            ct_ys,                         # ys_buf_init
            jnp.zeros_like(xi_w),          # presampled draws: nondiff
            jnp.zeros_like(xi_z),
            ct_sa,
            ct_args,
        )

    solve.defvjp(solve_fwd, solve_bwd)
    return solve


def sdeint_per_sample_batched(
    drift: Callable,
    diffusion: Callable,
    y0: jnp.ndarray,
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
    mode: str = "adjoint",
    saveat: Optional[jnp.ndarray] = None,
    controller: Optional[PIController] = None,
    remat: bool = True,
    matmul_precision: Optional[str] = "highest",
    brownian: str = "collapse",
) -> SDESolution:
    """Integrate every batch row's SDE under its own adaptive controller
    and its own Brownian path, as one dense batched program (see module
    docstring). Args/returns match :func:`sdeint_per_sample` for a
    single 2-D state."""
    if mode not in ("adjoint", "scan"):
        raise ValueError(
            f"mode must be 'adjoint' or 'scan' for the batched "
            f"per-sample SDE engine, got {mode!r}")
    if brownian != "collapse":
        raise NotImplementedError(
            "the batched per-sample SDE engine implements the collapse "
            "bridge scheme only; use engine='vmap' for brownian='stack'")
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return _run(drift, diffusion, y0, t0, t1, args, key, solver,
                        rtol, atol, dt0, max_steps, mode, saveat,
                        controller, remat, matmul_precision)
    return _run(drift, diffusion, y0, t0, t1, args, key, solver, rtol,
                atol, dt0, max_steps, mode, saveat, controller, remat,
                None)


def _run(drift, diffusion, y0, t0, t1, args, key, solver, rtol, atol,
         dt0, max_steps, mode, saveat, controller, remat,
         matmul_precision):
    y0 = jnp.asarray(y0)
    if y0.ndim != 2:
        raise ValueError(
            f"the batched per-sample SDE engine needs a 2-D (batch, dim) "
            f"state, got shape {y0.shape}; use engine='vmap' for pytree "
            f"states")
    tab = get_tableau(solver)
    ctrl = controller or PIController(beta1=0.5, beta2=0.0)
    batch, dim = y0.shape

    t0v = jnp.broadcast_to(jnp.asarray(t0, f32), (batch,))
    t1v = jnp.broadcast_to(jnp.asarray(t1, f32), (batch,))
    span = t1v - t0v  # forward-time only

    shared_grid = False
    if saveat is not None:
        saveat = jnp.asarray(saveat, f32)
        shared_grid = saveat.ndim == 1
        if shared_grid:
            saveat = jnp.broadcast_to(saveat[None],
                                      (batch, saveat.shape[0]))
        if saveat.ndim != 2 or saveat.shape[0] != batch:
            raise ValueError(
                f"saveat must be (n_save,) or ({batch}, n_save); got "
                f"shape {saveat.shape}")
        at_start = saveat - t0v[:, None] <= 0
        ys0 = jnp.where(at_start[:, :, None], y0[:, None, :],
                        jnp.zeros((batch, saveat.shape[1], dim),
                                  y0.dtype))
    else:
        ys0 = ()
        saveat = ()

    # Same initial dt rule as sdeint (no Hairer heuristic for SDEs).
    dt_init = jnp.broadcast_to(jnp.asarray(
        dt0 if dt0 is not None else 0.01, f32), (batch,))
    if dt0 is None:
        dt_init = jnp.minimum(dt_init, span)

    xi_w, xi_z = _presample_lanes(key, batch, dim, y0.dtype, max_steps)
    tail0 = (jnp.zeros((batch,), f32), jnp.zeros_like(y0),
             jnp.zeros_like(y0))

    has_saveat = not isinstance(saveat, tuple)
    core = _make_step_core(drift, diffusion, tab, ctrl, rtol, atol,
                           has_saveat)

    if mode == "adjoint":
        solve = _make_adjoint_solve(core, ctrl, max_steps, batch, dim,
                                    matmul_precision)
        y1, tel, ys, _tf, _dtf, _qoldf, done, na, nr = solve(
            t0v, t1v, dt_init, y0, tail0, ys0, xi_w, xi_z, saveat, args)
    else:
        def body(carry, xi):
            t, dt, qold, y, th_, tw, tz, done, ys_buf, na, nr = carry
            xw, xz = xi
            (t_new, dt_out, qold_out, y_out, th_o, tw_o, tz_o, done_new,
             ys_out, accept, live, row) = core(
                t, dt, qold, y, th_, tw, tz, done, ys_buf, xw, xz,
                t0v, t1v, saveat, args)
            na_out = na + (accept & live).astype(jnp.int32)
            nr_out = nr + ((~accept) & live).astype(jnp.int32)
            return (t_new, dt_out, qold_out, y_out, th_o, tw_o, tz_o,
                    done_new, ys_out, na_out, nr_out), row

        if remat:
            body = jax.checkpoint(body)

        qold0 = jnp.full((batch,), ctrl.qoldinit, f32)
        zi = jnp.zeros((batch,), jnp.int32)
        carry0 = (t0v, dt_init, qold0, y0, tail0[0], tail0[1], tail0[2],
                  span == 0, ys0, zi, zi)
        (tf, _dtf, _qf, y1, _th, _tw, _tz, done, ys, na, nr), tel = (
            lax.scan(body, carry0, (xi_w, xi_z), length=max_steps))

    nsteps = na + nr
    stats = SDEStats(
        nfe1=drift_evals_per_step(tab) * nsteps,
        nfe2=diffusion_evals_per_step(tab) * nsteps,
        naccept=na, nreject=nr, success=done,
    )
    tel = StepTelemetry(*(jnp.swapaxes(s, 0, 1) for s in tel))
    if has_saveat:
        ys_out = jnp.swapaxes(ys, 0, 1)
        ts = saveat[0] if shared_grid else saveat
        return SDESolution(y1=y1, ys=ys_out, ts=ts, stats=stats,
                           telemetry=tel)
    return SDESolution(y1=y1, ys=None, ts=None, stats=stats,
                       telemetry=tel)

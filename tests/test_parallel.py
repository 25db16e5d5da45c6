"""Mesh parallelism tests on the 8-device virtual CPU mesh.

The load-bearing property: a data-parallel solve with ``axis_name`` must
reproduce the single-device solve exactly — same EEst sequence, same
accept/reject pattern, same NFE — because the solver's error norms psum
over the mesh axis (globally synchronized step control).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import PartitionSpec as P

from regneuralde_tpu import parallel as par
from regneuralde_tpu import training as T
from regneuralde_tpu.models import MLP, MLPDynamics, NeuralODE
from regneuralde_tpu.ops import odeint


def _f(t, y, p):
    return jnp.tanh(y @ p) - 0.5 * y


class TestSynchronizedStepControl:
    def test_dp_solve_matches_single_device(self):
        assert jax.device_count() >= 8
        mesh = par.make_mesh(8)
        key = jax.random.PRNGKey(0)
        y0 = jax.random.normal(key, (16, 4))
        p = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (4, 4))

        ref = odeint(_f, y0, 0.0, 1.0, p, rtol=1e-5, atol=1e-5, max_steps=64)

        def shard_solve(y0, p):
            sol = odeint(_f, y0, 0.0, 1.0, p, rtol=1e-5, atol=1e-5,
                         max_steps=64, axis_name="data")
            return sol.y1, sol.stats.nfe, sol.telemetry.eest

        mapped = jax.jit(jax.shard_map(
            shard_solve, mesh=mesh,
            in_specs=(P("data", None), P()),
            out_specs=(P("data", None), P(), P()),
        ))
        y1, nfe, eest = mapped(par.shard_batch(mesh, y0), par.replicate(mesh, p))

        np.testing.assert_allclose(np.asarray(y1), np.asarray(ref.y1),
                                   rtol=2e-5, atol=1e-6)
        assert int(nfe) == int(ref.stats.nfe)
        # EEst is a catastrophic-cancellation quantity; psum-of-shard-sums
        # vs one global sum changes the f32 rounding, so compare coarsely —
        # the meaningful contract (identical accept/reject sequence, NFE,
        # and trajectory) is asserted exactly above.
        np.testing.assert_allclose(np.asarray(eest),
                                   np.asarray(ref.telemetry.eest),
                                   rtol=0.2, atol=1e-7)


class TestPerSampleDP:
    """Per-sample adaptive stepping composes with data parallelism for
    free: each lane has its own controller, so shards need NO cross-shard
    step synchronization (no axis_name) and no collectives inside the
    solve loops (regression: the implicit pvary/psum_invariant pairs JAX
    inserts for replicated params used to land inside the backward
    while_loop, where per-shard trip counts deadlock the all-reduce
    rendezvous — odeint/sdeint now stamp replicated inputs shard-varying
    at entry). Each shard reproduces the shape-matched unsharded
    per-sample solve's NFE exactly; trajectories and gradients agree with
    the full-batch solve to f32 rounding (XLA fuses the 2-lane shard
    program differently than the 16-lane vmap)."""

    def test_per_sample_dp_lane_parity_and_grads(self):
        from regneuralde_tpu.ops import odeint_per_sample

        assert jax.device_count() >= 8
        mesh = par.make_mesh(8)
        key = jax.random.PRNGKey(0)
        y0 = jax.random.normal(key, (16, 4))
        p = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (4, 4))
        kw = dict(rtol=1e-5, atol=1e-5, max_steps=64, mode="adjoint")

        ref = odeint_per_sample(_f, y0, 0.0, 1.0, p, **kw)

        def shard_solve(y0, p):
            sol = odeint_per_sample(_f, y0, 0.0, 1.0, p, **kw)
            return sol.y1, sol.stats.nfe

        mapped = jax.jit(jax.shard_map(
            shard_solve, mesh=mesh,
            in_specs=(P("data", None), P()),
            out_specs=(P("data", None), P("data")),
        ))
        y1, nfe = mapped(par.shard_batch(mesh, y0), par.replicate(mesh, p))
        np.testing.assert_allclose(np.asarray(y1), np.asarray(ref.y1),
                                   rtol=1e-5, atol=1e-7)
        # Exact NFE parity holds against the shape-matched (2-lane)
        # unsharded solve; vs the 16-lane vmap a reject can flip at f32
        # rounding edges, so pin shape-matched exactness per shard.
        solve2 = jax.jit(lambda y, p: odeint_per_sample(
            _f, y, 0.0, 1.0, p, **kw).stats.nfe)
        for s in range(8):
            np.testing.assert_array_equal(
                np.asarray(nfe[2 * s : 2 * s + 2]),
                np.asarray(solve2(y0[2 * s : 2 * s + 2], p)))

        def loss_single(p):
            return jnp.sum(odeint_per_sample(_f, y0, 0.0, 1.0, p, **kw).y1
                           ** 2)

        def shard_grad(p, y0s):
            # DP gradient: with replicated params inside shard_map,
            # jax.grad returns the invariant (= already all-reduced)
            # gradient — no explicit psum needed.
            local = lambda pp: jnp.sum(
                odeint_per_sample(_f, y0s, 0.0, 1.0, pp, **kw).y1 ** 2)
            return jax.grad(local)(p)

        g_ref = jax.jit(jax.grad(loss_single))(p)
        g_dp = jax.jit(jax.shard_map(
            shard_grad, mesh=mesh,
            in_specs=(P(), P("data", None)), out_specs=P(),
        ))(par.replicate(mesh, p), par.shard_batch(mesh, y0))
        np.testing.assert_allclose(np.asarray(g_dp), np.asarray(g_ref),
                                   rtol=1e-5, atol=1e-6)

    def test_per_sample_dp_sde(self):
        """SDE counterpart: per-trajectory controllers + independent
        Brownian paths shard over the mesh with finite, deadlock-free
        adjoint and scan gradients (the scan body's done lanes execute a
        discarded step; dt_eff=0 there would turn d(sqrt(dt)) into
        0*inf=NaN — regression for the sanitized synthetic carry)."""
        from regneuralde_tpu.ops import sdeint_per_sample

        mesh = par.make_mesh(8)
        y0 = jax.random.normal(jax.random.PRNGKey(0), (16, 4))
        p = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (4, 4))
        key = jax.random.PRNGKey(3)

        def diff(t, y, pp):
            return 0.1 * jnp.ones_like(y)

        for mode in ("scan", "adjoint"):
            kw = dict(rtol=1e-2, atol=1e-2, max_steps=64, mode=mode)

            def shard_grad(p, y0s):
                local = lambda pp: jnp.sum(sdeint_per_sample(
                    _f, diff, y0s, 0.0, 1.0, pp, key=key, **kw).y1 ** 2)
                return jax.grad(local)(p)

            g = jax.jit(jax.shard_map(
                shard_grad, mesh=mesh,
                in_specs=(P(), P("data", None)), out_specs=P(),
            ))(par.replicate(mesh, p), par.shard_batch(mesh, y0))
            assert np.isfinite(np.asarray(g)).all(), mode


class TestDPTraining:
    def test_dp_train_step_runs_and_descends(self):
        mesh = par.make_mesh(8)
        node = NeuralODE(MLPDynamics(dim=4, hidden=8), rtol=1e-3, atol=1e-3,
                         max_steps=48, axis_name=par.AXIS)
        x = jax.random.normal(jax.random.PRNGKey(0), (16, 4))
        target = jnp.flip(x, -1)
        params = node.init(jax.random.PRNGKey(1), x)

        def loss_fn(params, x, target):
            out = node(params, x)
            loss = jnp.mean((out.value - target) ** 2)
            return loss, {"nfe": out.nfe}

        opt = optax.adam(1e-2)
        state = T.create_train_state(par.replicate(mesh, params), opt)
        state = T.TrainState(state.params,
                             par.replicate(mesh, state.opt_state), 0)
        step = par.make_dp_train_step(loss_fn, opt, mesh)
        xb = par.shard_batch(mesh, x)
        tb = par.shard_batch(mesh, target)

        losses = []
        for _ in range(10):
            state, loss, aux = step(state, xb, tb)
            losses.append(float(loss))
        assert losses[-1] < losses[0]
        assert int(aux["nfe"]) > 0

    def test_dp_matches_single_device_gradients(self):
        mesh = par.make_mesh(8)
        x = jax.random.normal(jax.random.PRNGKey(0), (16, 4))

        def loss_single(p, x):
            sol = odeint(_f, x, 0.0, 1.0, p, rtol=1e-4, atol=1e-4, max_steps=48)
            return jnp.mean(sol.y1 ** 2)

        def loss_shard(p, x):
            sol = odeint(_f, x, 0.0, 1.0, p, rtol=1e-4, atol=1e-4,
                         max_steps=48, axis_name="data")
            return jnp.mean(sol.y1 ** 2)

        p = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (4, 4))
        g_ref = jax.grad(loss_single)(p, x)

        def shard_fn(p, x):
            # pmean the LOSS inside grad: with psum-coupled solves,
            # cotangents crossing psum accumulate over shards, so
            # grad-then-pmean would overcount by the axis size.
            g = jax.grad(lambda pp: jax.lax.pmean(loss_shard(pp, x), "data"))(p)
            return g

        g_dp = jax.jit(jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P("data", None)), out_specs=P(),
        ))(par.replicate(mesh, p), par.shard_batch(mesh, x))
        # Loose: gradients traverse the controller's EEst chain, whose f32
        # rounding differs between sharded and global reductions.
        np.testing.assert_allclose(np.asarray(g_dp), np.asarray(g_ref),
                                   rtol=5e-2, atol=1e-4)

    def test_dp_eval_step(self):
        mesh = par.make_mesh(8)

        def eval_fn(p, x):
            return {"m": jnp.mean(x * p)}

        ev = par.make_dp_eval_step(eval_fn, mesh)
        x = jnp.arange(16.0).reshape(16, 1)
        out = ev(par.replicate(mesh, jnp.asarray(2.0)), par.shard_batch(mesh, x))
        np.testing.assert_allclose(float(out["m"]), 15.0, rtol=1e-6)

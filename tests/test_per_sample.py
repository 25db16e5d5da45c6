"""Per-sample adaptive stepping (ops.per_sample / NeuralODE(per_sample=True)).

The contract under test: each batch element is integrated under its OWN
PI controller — bitwise-identical to solving that sample alone — while the
whole batch remains one XLA program (vmap of the single-sample solve; the
default engines' global-error-norm semantics mirror the reference,
src/models/neural_ode.jl:62, and per-sample mode is the strictly-additive
torchode-style alternative from the build plan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from regneuralde_tpu import reg
from regneuralde_tpu.models import (
    Dense, MLPDynamics, Module, NeuralODE, NeuralSDE)
from regneuralde_tpu.ops import (
    odeint,
    odeint_per_sample,
    sdeint,
    sdeint_per_sample,
)


def oscillator(t, y, args):
    """Harmonic oscillator with per-sample frequency carried in the state:
    y = (pos, vel, omega), omega' = 0 — heterogeneous difficulty in one
    batched dynamics function."""
    pos, vel, om = y[..., 0], y[..., 1], y[..., 2]
    return jnp.stack([vel, -(om ** 2) * pos, jnp.zeros_like(om)], -1)


OMEGAS = jnp.array([1.0, 3.0, 20.0])
Y0 = jnp.stack([jnp.ones(3), jnp.zeros(3), OMEGAS], -1)  # (3 samples, 3)
KW = dict(rtol=1e-6, atol=1e-6, max_steps=512)


class _Drift(Module):
    """``Dense(dim)(tanh(x))`` with ``dim`` taken from the input."""

    def _init(self, key, x):
        p = {"dense": Dense(x.shape[-1])._init(key, x)[0]}
        return p, self._apply(p, x)

    def _apply(self, p, x):
        return Dense(x.shape[-1])._apply(p["dense"], jnp.tanh(x))


class _Diffusion(_Drift):
    """``0.1 * tanh(Dense(dim)(x))``."""

    def _apply(self, p, x):
        return 0.1 * jnp.tanh(Dense(x.shape[-1])._apply(p["dense"], x))


class TestSolver:
    def test_matches_independent_solves_bitwise(self):
        sol = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan", **KW)
        assert bool(sol.stats.success.all())
        for i in range(Y0.shape[0]):
            si = odeint(oscillator, Y0[i : i + 1], 0.0, 1.0,
                        mode="scan", **KW)
            np.testing.assert_array_equal(
                np.asarray(sol.y1[i]), np.asarray(si.y1[0]))
            assert int(sol.stats.nfe[i]) == int(si.stats.nfe)
            assert int(sol.stats.naccept[i]) == int(si.stats.naccept)
            assert int(sol.stats.nreject[i]) == int(si.stats.nreject)

    def test_engines_agree(self):
        s = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan", **KW)
        w = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="while", **KW)
        a = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="adjoint", **KW)
        np.testing.assert_array_equal(np.asarray(s.y1), np.asarray(w.y1))
        np.testing.assert_array_equal(
            np.asarray(s.stats.nfe), np.asarray(w.stats.nfe))
        np.testing.assert_allclose(
            np.asarray(s.y1), np.asarray(a.y1), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(
            np.asarray(s.stats.nfe), np.asarray(a.stats.nfe))

    def test_easy_samples_keep_cheap_nfe(self):
        """The mode's point: per-sample NFE is honest. Easy samples cost a
        fraction of the batch's worst case, while the global-norm batched
        solve charges everyone roughly the hard sample's rate."""
        ps = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan", **KW)
        gl = odeint(oscillator, Y0, 0.0, 1.0, mode="scan", **KW)
        nfe = np.asarray(ps.stats.nfe)
        assert nfe[0] < nfe[2] / 3  # omega=1 vs omega=20
        # global control is dominated by the stiffest sample
        assert int(gl.stats.nfe) > 2 * nfe[0]

    def test_telemetry_and_reg_shapes(self):
        sol = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan", **KW)
        B, S = Y0.shape[0], KW["max_steps"]
        assert sol.telemetry.eest.shape == (B, S)
        assert sol.telemetry.accepted.shape == (B, S)
        r = reg.error_estimate(sol.telemetry, agg="mean")
        assert r.shape == () and bool(jnp.isfinite(r)) and float(r) >= 0

    def test_saveat_matches_independent(self):
        sa = jnp.linspace(0.0, 1.0, 7)
        sol = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan",
                                saveat=sa, **KW)
        assert sol.ys.shape == (7, Y0.shape[0], 3)
        np.testing.assert_array_equal(np.asarray(sol.ts), np.asarray(sa))
        for i in range(Y0.shape[0]):
            si = odeint(oscillator, Y0[i : i + 1], 0.0, 1.0, mode="scan",
                        saveat=sa, **KW)
            np.testing.assert_array_equal(
                np.asarray(sol.ys[:, i]), np.asarray(si.ys[:, 0]))

    def test_per_sample_saveat_matches_independent(self):
        """(batch, n_save) saveat: each sample decoded at its OWN sorted
        stamps, lane-for-lane equal to solving that sample alone with its
        row (the reference forces sample 1's grid on the whole batch,
        experiments/latent_ode.jl:137)."""
        sa = jnp.stack([
            jnp.linspace(0.1, 1.0, 5),
            jnp.linspace(0.0, 0.8, 5),
            jnp.array([0.25, 0.3, 0.5, 0.9, 1.0]),
        ])
        sol = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan",
                                saveat=sa, **KW)
        assert sol.ys.shape == (5, Y0.shape[0], 3)
        assert sol.ts.shape == sa.shape
        np.testing.assert_array_equal(np.asarray(sol.ts), np.asarray(sa))
        for i in range(Y0.shape[0]):
            si = odeint(oscillator, Y0[i : i + 1], 0.0, 1.0, mode="scan",
                        saveat=sa[i], **KW)
            np.testing.assert_array_equal(
                np.asarray(sol.ys[:, i]), np.asarray(si.ys[:, 0]))

    def test_per_sample_saveat_adjoint_grads(self):
        """mode="adjoint" (the training default) with a per-sample grid:
        regression for the custom_vjp closure capturing the vmap-batched
        saveat (UnexpectedTracerError); saveat is now threaded as an
        explicit solve argument with its own accumulated cotangent."""
        sa = jnp.stack([
            jnp.linspace(0.1, 1.0, 5),
            jnp.linspace(0.0, 0.8, 5),
            jnp.array([0.25, 0.3, 0.5, 0.9, 1.0]),
        ])

        def damped(t, y, args):
            (c,) = args
            return oscillator(t, y, ()) - c * y

        def loss(p, sa_, mode):
            s = odeint_per_sample(damped, Y0, 0.0, 1.0, p, mode=mode,
                                  saveat=sa_, **KW)
            return jnp.sum(s.ys ** 2)

        for wrt in (0, 1):  # d/d(params) and d/d(saveat)
            ga = jax.jit(jax.grad(loss, argnums=wrt),
                         static_argnums=2)((0.3,), sa, "adjoint")
            gs = jax.jit(jax.grad(loss, argnums=wrt),
                         static_argnums=2)((0.3,), sa, "scan")
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6),
                ga, gs)

    def test_per_sample_saveat_bad_shape(self):
        with pytest.raises(ValueError, match="saveat"):
            odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan",
                              saveat=jnp.zeros((2, 4)), **KW)

    def test_per_sample_tspan(self):
        """Per-sample t1 (e.g. per-sample STEER jitter; the reference
        jitters one shared t1 per minibatch, experiments/mnist_node.jl:133)."""
        t1s = jnp.array([0.5, 1.0, 1.5])
        sol = odeint_per_sample(oscillator, Y0, 0.0, t1s, mode="scan", **KW)
        for i in range(Y0.shape[0]):
            si = odeint(oscillator, Y0[i : i + 1], 0.0, float(t1s[i]),
                        mode="scan", **KW)
            np.testing.assert_allclose(
                np.asarray(sol.y1[i]), np.asarray(si.y1[0]),
                rtol=1e-6, atol=1e-7)

    def test_gradients_match_independent_and_adjoint(self):
        def loss_ps(y0, mode):
            sol = odeint_per_sample(oscillator, y0, 0.0, 1.0,
                                    mode=mode, **KW)
            return jnp.sum(sol.y1[:, 0] ** 2)

        g_scan = jax.grad(lambda y: loss_ps(y, "scan"))(Y0)
        g_adj = jax.grad(lambda y: loss_ps(y, "adjoint"))(Y0)
        np.testing.assert_allclose(
            np.asarray(g_scan), np.asarray(g_adj), rtol=1e-4, atol=1e-6)
        # row i of the batched gradient == the lone-sample gradient
        for i in range(Y0.shape[0]):
            gi = jax.grad(
                lambda y: jnp.sum(
                    odeint(oscillator, y, 0.0, 1.0, mode="scan", **KW)
                    .y1[:, 0] ** 2
                )
            )(Y0[i : i + 1])
            np.testing.assert_allclose(
                np.asarray(g_scan[i]), np.asarray(gi[0]),
                rtol=1e-5, atol=1e-7)

    def test_rejects_global_batch_kwargs(self):
        with pytest.raises(ValueError, match="axis_name"):
            odeint_per_sample(oscillator, Y0, 0.0, 1.0,
                              axis_name="dp", **KW)
        with pytest.raises(ValueError, match="sample axis"):
            odeint_per_sample(oscillator, jnp.zeros(()), 0.0, 1.0, **KW)


class TestModelLayer:
    def test_neural_ode_per_sample(self):
        dyn = MLPDynamics(dim=6, hidden=8)
        node = NeuralODE(dyn, time_dep=True, rtol=1e-5, atol=1e-5,
                         max_steps=128, per_sample=True)
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 6)) * 0.3
        p = node.init(jax.random.PRNGKey(1), x)
        out = node(p, x)
        assert out.value.shape == (4, 6)
        assert out.nfe.shape == (4,)
        assert bool(out.solution.stats.success.all())
        # matches the global-batch solve loosely (same dynamics, both
        # within tolerance of the true flow) but with per-sample control
        ref = NeuralODE(dyn, time_dep=True, rtol=1e-5, atol=1e-5,
                        max_steps=128)(p, x)
        np.testing.assert_allclose(
            np.asarray(out.value), np.asarray(ref.value),
            rtol=1e-3, atol=1e-4)
        # regularizers consume the (batch, steps) telemetry unchanged
        r = reg.error_estimate(out.telemetry, agg="mean")
        assert bool(jnp.isfinite(r))
        # and gradients flow end to end
        g = jax.grad(
            lambda pp: jnp.sum(node(pp, x).value ** 2)
            + 0.1 * reg.error_estimate(node(pp, x).telemetry, agg="mean")
        )(p)
        assert all(
            bool(jnp.all(jnp.isfinite(l)))
            for l in jax.tree_util.tree_leaves(g)
        )

    def test_saveat_trajectory_shape(self):
        dyn = MLPDynamics(dim=4, hidden=8)
        sa = jnp.linspace(0.0, 1.0, 5)
        node = NeuralODE(dyn, time_dep=True, rtol=1e-5, atol=1e-5,
                         max_steps=128, saveat=sa, per_sample=True)
        x = jax.random.normal(jax.random.PRNGKey(0), (3, 4)) * 0.3
        p = node.init(jax.random.PRNGKey(1), x)
        out = node(p, x)
        assert out.value.shape == (3, 5, 4)


def sde_drift(t, y, args):
    return -0.5 * y


def sde_diffusion(t, y, args):
    return 0.2 * jnp.ones_like(y)


SDE_Y0 = jnp.stack([jnp.ones(2), 2 * jnp.ones(2), -jnp.ones(2)])
SDE_KEY = jax.random.PRNGKey(7)
SDE_KW = dict(rtol=1e-2, atol=1e-2, max_steps=128)


class TestSDE:
    def test_matches_independent_solves_draw_for_draw(self):
        sol = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                                key=SDE_KEY, mode="scan", **SDE_KW)
        assert bool(sol.stats.success.all())
        keys = jax.random.split(SDE_KEY, SDE_Y0.shape[0])
        for i in range(SDE_Y0.shape[0]):
            si = sdeint(sde_drift, sde_diffusion, SDE_Y0[i : i + 1],
                        0.0, 1.0, key=keys[i], mode="scan", **SDE_KW)
            np.testing.assert_array_equal(
                np.asarray(sol.y1[i]), np.asarray(si.y1[0]))
            assert int(sol.stats.nfe1[i]) == int(si.stats.nfe1)
            assert int(sol.stats.nfe2[i]) == int(si.stats.nfe2)

    def test_engines_and_brownian_stack(self):
        s = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="scan", **SDE_KW)
        w = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="while", **SDE_KW)
        a = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="adjoint", **SDE_KW)
        st = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                               key=SDE_KEY, mode="scan",
                               brownian="stack", **SDE_KW)
        np.testing.assert_array_equal(np.asarray(s.y1), np.asarray(w.y1))
        np.testing.assert_allclose(
            np.asarray(s.y1), np.asarray(a.y1), rtol=1e-5, atol=1e-6)
        assert bool(st.stats.success.all())

    def test_per_sample_saveat_matches_independent(self):
        sa = jnp.stack([
            jnp.linspace(0.2, 1.0, 4),
            jnp.linspace(0.0, 0.7, 4),
            jnp.array([0.1, 0.5, 0.6, 1.0]),
        ])
        sol = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                                key=SDE_KEY, mode="scan", saveat=sa,
                                **SDE_KW)
        assert sol.ys.shape == (4, SDE_Y0.shape[0], 2)
        assert sol.ts.shape == sa.shape
        keys = jax.random.split(SDE_KEY, SDE_Y0.shape[0])
        for i in range(SDE_Y0.shape[0]):
            si = sdeint(sde_drift, sde_diffusion, SDE_Y0[i : i + 1],
                        0.0, 1.0, key=keys[i], mode="scan", saveat=sa[i],
                        **SDE_KW)
            np.testing.assert_array_equal(
                np.asarray(sol.ys[:, i]), np.asarray(si.ys[:, 0]))

    def test_per_sample_saveat_adjoint_grads(self):
        """mode="adjoint" with a per-sample grid (SDE counterpart of the
        ODE regression): the vmap-batched saveat must be threaded through
        the custom_vjp, not captured by its closure."""
        sa = jnp.stack([
            jnp.linspace(0.2, 1.0, 4),
            jnp.linspace(0.0, 0.7, 4),
            jnp.array([0.1, 0.5, 0.6, 1.0]),
        ])

        def pdrift(t, y, args):
            (k,) = args
            return -k * y

        def loss(p, mode):
            s = sdeint_per_sample(pdrift, sde_diffusion, SDE_Y0, 0.0,
                                  1.0, p, key=SDE_KEY, mode=mode,
                                  saveat=sa, **SDE_KW)
            return jnp.sum(s.ys ** 2)

        ga = jax.jit(jax.grad(loss), static_argnums=1)((0.5,), "adjoint")
        gs = jax.jit(jax.grad(loss), static_argnums=1)((0.5,), "scan")
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-6),
            ga, gs)

    def test_gradients_adjoint_matches_scan(self):
        """This batch is a regression pin: sample 1's solve rejects an
        is_last trial step, so the accepted retry consumes the committed
        Brownian tail EXACTLY (dt == h) — the case whose unguarded
        sqrt(0) backward used to poison gradients with NaN."""

        def loss(y, mode):
            sol = sdeint_per_sample(sde_drift, sde_diffusion, y, 0.0, 1.0,
                                    key=SDE_KEY, mode=mode, **SDE_KW)
            return jnp.sum(sol.y1 ** 2)

        gs = jax.grad(lambda y: loss(y, "scan"))(SDE_Y0)
        ga = jax.grad(lambda y: loss(y, "adjoint"))(SDE_Y0)
        assert bool(jnp.all(jnp.isfinite(gs)))
        np.testing.assert_allclose(
            np.asarray(gs), np.asarray(ga), rtol=1e-4, atol=1e-6)

    def test_neural_sde_per_sample(self):
        model = NeuralSDE(_Drift(), _Diffusion(), rtol=1.4e-1, atol=1.4e-1,
                          max_steps=64, per_sample=True)
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 3)) * 0.5
        p = model.init(jax.random.PRNGKey(1), x)
        out = model(p, x, jax.random.PRNGKey(2))
        assert out.value.shape == (4, 3)
        assert out.nfe1.shape == (4,)
        assert bool(out.solution.stats.success.all())


class TestBatchedEngine:
    """The per-lane-controller batched engine (ops.per_sample_batched):
    same per-sample semantics as the vmap engine, one dense batched
    program. Exact-bitwise parity with vmap is NOT the contract (the
    (batch, dim) and (1, dim) lowerings round differently, which can
    flip a controller decision at the accept boundary); step counts must
    agree within ONE trial step per lane and values to f32 roundoff."""

    def test_matches_vmap_engine(self):
        sv = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan", **KW)
        sb = odeint_per_sample(oscillator, Y0, 0.0, 1.0, engine="batched",
                               **KW)
        assert bool(sb.stats.success.all())
        nfe_v = np.asarray(sv.stats.nfe)
        nfe_b = np.asarray(sb.stats.nfe)
        assert (np.abs(nfe_v - nfe_b) <= 6).all(), (nfe_v, nfe_b)
        np.testing.assert_allclose(np.asarray(sb.y1), np.asarray(sv.y1),
                                   rtol=2e-4, atol=1e-6)
        # honest per-lane accounting: the easy lane stays far cheaper
        # than the stiff one
        assert nfe_b[0] < nfe_b[2] / 3
        assert sb.telemetry.t.shape == (Y0.shape[0], KW["max_steps"])
        # reg reductions accept the (batch, max_steps) telemetry
        r = reg.error_estimate(sb.telemetry, agg="mean")
        assert np.isfinite(float(r))

    def test_time_dependent_dynamics(self):
        from regneuralde_tpu.models.basic import _t_row

        def f(t, y, args):
            return -y * (1.0 + 0.5 * jnp.sin(3.0 * _t_row(y, t)))

        y0 = jnp.linspace(0.5, 2.0, 8).reshape(4, 2)
        kw = dict(rtol=1e-6, atol=1e-6, max_steps=128)
        sv = odeint_per_sample(f, y0, 0.0, 1.0, mode="scan", **kw)
        sb = odeint_per_sample(f, y0, 0.0, 1.0, engine="batched", **kw)
        np.testing.assert_allclose(np.asarray(sb.y1), np.asarray(sv.y1),
                                   rtol=2e-4, atol=1e-6)
        assert (np.abs(np.asarray(sv.stats.nfe)
                       - np.asarray(sb.stats.nfe)) <= 6).all()

    def test_gradients_match_vmap_adjoint(self):
        def loss(y0, engine, mode):
            if engine == "batched":
                s = odeint_per_sample(oscillator, y0, 0.0, 1.0,
                                      engine="batched", **KW)
            else:
                s = odeint_per_sample(oscillator, y0, 0.0, 1.0,
                                      mode=mode, **KW)
            return jnp.sum(s.y1[:, :2] ** 2)

        gb = jax.grad(lambda y: loss(y, "batched", None))(Y0)
        gv = jax.grad(lambda y: loss(y, "vmap", "adjoint"))(Y0)
        np.testing.assert_allclose(np.asarray(gb), np.asarray(gv),
                                   rtol=5e-3, atol=1e-4)

    def test_per_sample_tspan(self):
        t1 = jnp.asarray([0.5, 1.0, 1.5])
        sb = odeint_per_sample(oscillator, Y0, 0.0, t1, engine="batched",
                               **KW)
        for i, t1_i in enumerate([0.5, 1.0, 1.5]):
            si = odeint(oscillator, Y0[i : i + 1], 0.0, t1_i, mode="scan",
                        **KW)
            np.testing.assert_allclose(np.asarray(sb.y1[i]),
                                       np.asarray(si.y1[0]),
                                       rtol=2e-4, atol=1e-6)

    def test_scope_errors(self):
        # Pytree states are ACCEPTED since round 5 (the flatten
        # adapter; see TestBatchedPytreeState) — only the engine/mode
        # names remain scope errors here.
        sol = odeint_per_sample(lambda t, y, a: y, {"a": Y0}, 0.0, 1.0,
                                engine="batched", mode="scan", **KW)
        assert sol.y1["a"].shape == Y0.shape
        with pytest.raises(ValueError, match="engine"):
            odeint_per_sample(oscillator, Y0, 0.0, 1.0, engine="nope", **KW)
        with pytest.raises(ValueError, match="mode"):
            odeint_per_sample(oscillator, Y0, 0.0, 1.0, engine="batched",
                              mode="nope", **KW)


class TestBatchedAdjointMode:
    """engine='batched' mode='adjoint' (the default): early-exit
    while_loop forward + custom_vjp backward replaying only the executed
    iterations. Pinned against mode='scan' (traced AD through the
    bounded remat'd scan), whose forward runs the identical op sequence
    for live iterations — values and per-lane step counts must match
    EXACTLY, gradients to adjoint-replay roundoff."""

    def test_forward_matches_scan_mode(self):
        ss = odeint_per_sample(oscillator, Y0, 0.0, 1.0, engine="batched",
                               mode="scan", **KW)
        sa = odeint_per_sample(oscillator, Y0, 0.0, 1.0, engine="batched",
                               mode="adjoint", **KW)
        np.testing.assert_array_equal(np.asarray(ss.stats.nfe),
                                      np.asarray(sa.stats.nfe))
        np.testing.assert_array_equal(np.asarray(ss.stats.nreject),
                                      np.asarray(sa.stats.nreject))
        np.testing.assert_allclose(np.asarray(sa.y1), np.asarray(ss.y1),
                                   rtol=1e-6, atol=1e-7)
        assert bool(sa.stats.success.all())
        # telemetry streams agree row-for-row (incl. zeroed dead rows)
        for name in ("t", "dt", "eest", "accepted", "live"):
            np.testing.assert_allclose(
                np.asarray(getattr(sa.telemetry, name)),
                np.asarray(getattr(ss.telemetry, name)),
                rtol=1e-6, atol=1e-7, err_msg=name)

    def test_gradients_match_scan_mode(self):
        def loss(y0, t1, mode):
            s = odeint_per_sample(oscillator, y0, 0.0, t1,
                                  engine="batched", mode=mode, **KW)
            task = jnp.sum(s.y1[:, :2] ** 2)
            r = reg.error_estimate(s.telemetry, agg="mean")
            return task + 0.1 * r

        t1 = jnp.asarray([0.5, 1.0, 1.5])  # per-sample tspan on the tape
        ga = jax.grad(lambda y, t: loss(y, t, "adjoint"), argnums=(0, 1))(
            Y0, t1)
        gs = jax.grad(lambda y, t: loss(y, t, "scan"), argnums=(0, 1))(
            Y0, t1)
        np.testing.assert_allclose(np.asarray(ga[0]), np.asarray(gs[0]),
                                   rtol=5e-3, atol=1e-4)
        # d/dt1 flows through is_last clamps and the EEst*dt reg
        np.testing.assert_allclose(np.asarray(ga[1]), np.asarray(gs[1]),
                                   rtol=5e-3, atol=1e-4)

    def test_args_gradients_match_scan_mode(self):
        A = jax.random.normal(jax.random.PRNGKey(0), (3, 3)) * 0.4

        def f(t, y, args):
            (A,) = args
            return jnp.tanh(y @ A)

        y0 = jnp.stack([jnp.ones(3), 2 * jnp.ones(3), -jnp.ones(3)])

        def loss(A, mode):
            s = odeint_per_sample(f, y0, 0.0, 1.0, (A,), engine="batched",
                                  mode=mode, rtol=1e-6, atol=1e-6,
                                  max_steps=64)
            return jnp.sum(s.y1 ** 2)

        ga = jax.grad(lambda a: loss(a, "adjoint"))(A)
        gs = jax.grad(lambda a: loss(a, "scan"))(A)
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gs),
                                   rtol=5e-3, atol=1e-5)

    def test_saveat_matches_vmap_engine(self):
        """Shared-grid saveat: the dense masked Hermite write must
        reproduce the vmap engine's per-lane save cursor (same window
        convention, same interpolant, u0 seeding at stamps <= t0)."""
        sa = jnp.asarray([0.0, 0.2, 0.5, 0.8, 1.0])
        sv = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan",
                               saveat=sa, **KW)
        for mode in ("scan", "adjoint"):
            sb = odeint_per_sample(oscillator, Y0, 0.0, 1.0,
                                   engine="batched", mode=mode, saveat=sa,
                                   **KW)
            assert sb.ys.shape == (5, 3, 3)
            np.testing.assert_allclose(np.asarray(sb.ys),
                                       np.asarray(sv.ys),
                                       rtol=2e-4, atol=1e-5, err_msg=mode)
            np.testing.assert_array_equal(np.asarray(sb.ts),
                                          np.asarray(sa))

    def test_per_sample_saveat_grid_matches_vmap(self):
        """Per-sample (batch, n_save) grids: each lane decoded at its OWN
        stamps."""
        sa = jnp.stack([jnp.linspace(0.0, 1.0, 4),
                        jnp.linspace(0.1, 0.9, 4),
                        jnp.linspace(0.0, 0.5, 4)])
        sv = odeint_per_sample(oscillator, Y0, 0.0, 1.0, mode="scan",
                               saveat=sa, **KW)
        sb = odeint_per_sample(oscillator, Y0, 0.0, 1.0, engine="batched",
                               saveat=sa, **KW)
        assert sb.ys.shape == sv.ys.shape == (4, 3, 3)
        np.testing.assert_allclose(np.asarray(sb.ys), np.asarray(sv.ys),
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(sb.ts), np.asarray(sa))

    def test_saveat_gradients_match_scan(self):
        sa = jnp.asarray([0.3, 0.6, 1.0])

        def loss(y0, sa, mode):
            s = odeint_per_sample(oscillator, y0, 0.0, 1.0,
                                  engine="batched", mode=mode, saveat=sa,
                                  **KW)
            return jnp.sum(s.ys[:, :, :2] ** 2)

        ga = jax.grad(lambda y, s: loss(y, s, "adjoint"), argnums=(0, 1))(
            Y0, sa)
        gs = jax.grad(lambda y, s: loss(y, s, "scan"), argnums=(0, 1))(
            Y0, sa)
        np.testing.assert_allclose(np.asarray(ga[0]), np.asarray(gs[0]),
                                   rtol=5e-3, atol=1e-4)
        # d/d(saveat) flows through the Hermite interpolation stamps
        np.testing.assert_allclose(np.asarray(ga[1]), np.asarray(gs[1]),
                                   rtol=5e-3, atol=1e-4)
        assert float(np.abs(np.asarray(ga[1])).max()) > 0

    def test_neural_ode_saveat_routing(self):
        """NeuralODE(per_sample='batched', saveat=...) returns the
        (batch, n_save, dim) trajectory like the vmap engine."""
        dyn = MLPDynamics(dim=4, hidden=8)
        sa = jnp.linspace(0.0, 1.0, 5)
        x = jax.random.normal(jax.random.PRNGKey(0), (3, 4)) * 0.3
        node_b = NeuralODE(dyn, time_dep=True, rtol=1e-5, atol=1e-5,
                           max_steps=128, saveat=sa, per_sample="batched")
        p = node_b.init(jax.random.PRNGKey(1), x)
        out_b = node_b(p, x)
        assert out_b.value.shape == (3, 5, 4)
        node_v = NeuralODE(dyn, time_dep=True, rtol=1e-5, atol=1e-5,
                           max_steps=128, saveat=sa, per_sample=True)
        out_v = node_v(p, x, mode="scan")
        np.testing.assert_allclose(np.asarray(out_b.value),
                                   np.asarray(out_v.value),
                                   rtol=2e-4, atol=1e-5)

    def test_neural_ode_mode_routing(self):
        """NeuralODE(per_sample='batched') threads its call mode into the
        engine; 'while' maps onto the adjoint forward."""
        model = NeuralODE(MLPDynamics(dim=6, hidden=8), time_dep=True,
                          per_sample="batched", rtol=1e-4, atol=1e-4,
                          max_steps=64)
        x = jax.random.normal(jax.random.PRNGKey(1), (4, 6)) * 0.3
        params = model.init(jax.random.PRNGKey(2), x)
        outs = {m: model(params, x, mode=m)
                for m in ("adjoint", "scan", "while")}
        for m in ("scan", "while"):
            np.testing.assert_allclose(
                np.asarray(outs[m].value), np.asarray(outs["adjoint"].value),
                rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(outs[m].nfe),
                                          np.asarray(outs["adjoint"].nfe))


class TestBatchedSDEEngine:
    """Per-lane-controller batched SDE engine
    (ops.per_sample_sde_batched): the same per-lane semantics and
    per-lane Brownian paths as the vmap engine, as one dense batched
    program. Contract: draws/NFE matched to the vmap engine per lane,
    gradients pinned to the scan mode."""

    def test_matches_vmap_engine_per_lane(self):
        b = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="scan", engine="batched",
                              **SDE_KW)
        v = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="scan", **SDE_KW)
        assert bool(b.stats.success.all())
        # Same per-lane draw chain and controller: identical per-lane
        # accept/reject counts and (to broadcast-order rounding)
        # identical trajectories.
        np.testing.assert_array_equal(np.asarray(b.stats.naccept),
                                      np.asarray(v.stats.naccept))
        np.testing.assert_array_equal(np.asarray(b.stats.nreject),
                                      np.asarray(v.stats.nreject))
        np.testing.assert_array_equal(np.asarray(b.stats.nfe1),
                                      np.asarray(v.stats.nfe1))
        np.testing.assert_allclose(np.asarray(b.y1), np.asarray(v.y1),
                                   rtol=1e-5, atol=1e-6)

    def test_adjoint_matches_scan_forward(self):
        s = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="scan", engine="batched",
                              **SDE_KW)
        a = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="adjoint",
                              engine="batched", **SDE_KW)
        np.testing.assert_array_equal(np.asarray(s.y1), np.asarray(a.y1))
        np.testing.assert_array_equal(np.asarray(s.stats.nfe1),
                                      np.asarray(a.stats.nfe1))

    def test_gradients_adjoint_matches_scan(self):
        def pdrift(t, y, args):
            (k,) = args
            return -k * y

        def loss(p, y, mode):
            s = sdeint_per_sample(pdrift, sde_diffusion, y, 0.0, 1.0, p,
                                  key=SDE_KEY, mode=mode,
                                  engine="batched", **SDE_KW)
            return (jnp.sum(s.y1 ** 2)
                    + reg.error_estimate(s.telemetry, agg="mean"))

        ga = jax.jit(jax.grad(loss, argnums=(0, 1)),
                     static_argnums=2)((0.5,), SDE_Y0, "adjoint")
        gs = jax.jit(jax.grad(loss, argnums=(0, 1)),
                     static_argnums=2)((0.5,), SDE_Y0, "scan")
        for a, b in zip(jax.tree_util.tree_leaves(ga),
                        jax.tree_util.tree_leaves(gs)):
            assert bool(jnp.all(jnp.isfinite(b)))
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-6)

    def test_gradients_match_vmap_engine(self):
        def pdrift(t, y, args):
            (k,) = args
            return -k * y

        def loss(p, engine):
            s = sdeint_per_sample(pdrift, sde_diffusion, SDE_Y0, 0.0,
                                  1.0, p, key=SDE_KEY, mode="scan",
                                  engine=engine, **SDE_KW)
            return jnp.sum(s.y1 ** 2)

        gb = jax.grad(lambda p: loss(p, "batched"))((0.5,))
        gv = jax.grad(lambda p: loss(p, "vmap"))((0.5,))
        np.testing.assert_allclose(np.asarray(gb[0]), np.asarray(gv[0]),
                                   rtol=1e-4, atol=1e-6)

    def test_saveat_matches_vmap(self):
        sa = jnp.stack([
            jnp.linspace(0.2, 1.0, 4),
            jnp.linspace(0.0, 0.7, 4),
            jnp.array([0.1, 0.5, 0.6, 1.0]),
        ])
        b = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="scan", engine="batched",
                              saveat=sa, **SDE_KW)
        v = sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, mode="scan", saveat=sa,
                              **SDE_KW)
        assert b.ys.shape == (4, SDE_Y0.shape[0], 2)
        assert b.ts.shape == sa.shape
        np.testing.assert_allclose(np.asarray(b.ys), np.asarray(v.ys),
                                   rtol=1e-5, atol=1e-6)

    def test_saveat_adjoint_grads(self):
        sa = jnp.linspace(0.1, 1.0, 5)

        def loss(y, mode):
            s = sdeint_per_sample(sde_drift, sde_diffusion, y, 0.0, 1.0,
                                  key=SDE_KEY, mode=mode,
                                  engine="batched", saveat=sa, **SDE_KW)
            return jnp.sum(s.ys ** 2)

        ga = jax.grad(lambda y: loss(y, "adjoint"))(SDE_Y0)
        gs = jax.grad(lambda y: loss(y, "scan"))(SDE_Y0)
        assert bool(jnp.all(jnp.isfinite(gs)))
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gs),
                                   rtol=1e-4, atol=1e-6)

    def test_neural_sde_batched_routing(self):
        model = NeuralSDE(_Drift(), _Diffusion(), rtol=1.4e-1, atol=1.4e-1,
                          max_steps=64, per_sample="batched")
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 3)) * 0.5
        p = model.init(jax.random.PRNGKey(1), x)
        out = model(p, x, jax.random.PRNGKey(2))
        assert out.value.shape == (4, 3)
        assert out.nfe1.shape == (4,)
        assert bool(out.solution.stats.success.all())

    def test_scope_errors(self):
        with pytest.raises(NotImplementedError, match="collapse"):
            sdeint_per_sample(sde_drift, sde_diffusion, SDE_Y0, 0.0, 1.0,
                              key=SDE_KEY, engine="batched",
                              brownian="stack", **SDE_KW)
        with pytest.raises(ValueError, match="2-D"):
            sdeint_per_sample(
                sde_drift, sde_diffusion,
                jnp.zeros((3, 2, 2)), 0.0, 1.0, key=SDE_KEY,
                engine="batched", **SDE_KW)


class TestBatchedLatentShape:
    """The latent-ODE workload shape through the batched per-sample
    engine (VERDICT-r4 #9): 20-dim latent state decoded at a 49-stamp
    saveat grid. Lane parity vs the vmap engine and adjoint-vs-scan
    gradients at this shape."""

    def _setup(self):
        from regneuralde_tpu.models import AlternatingMLP

        m = AlternatingMLP(dim=20, hidden=16, depth=2)
        y0 = jax.random.normal(jax.random.PRNGKey(2), (6, 20)) * 0.4
        p = m.init(jax.random.PRNGKey(3), y0)
        f = lambda t, y, pp: m.apply(pp, y)
        sa = jnp.linspace(0.0, 1.0, 49)
        kw = dict(rtol=1e-4, atol=1e-4, max_steps=96, saveat=sa)
        return f, y0, p, kw

    def test_lane_parity_vs_vmap(self):
        f, y0, p, kw = self._setup()
        b = odeint_per_sample(f, y0, 0.0, 1.0, p, engine="batched",
                              mode="scan", **kw)
        v = odeint_per_sample(f, y0, 0.0, 1.0, p, mode="scan", **kw)
        np.testing.assert_array_equal(np.asarray(b.stats.nfe),
                                      np.asarray(v.stats.nfe))
        assert b.ys.shape == (49, 6, 20)
        # The engines evaluate the same math in different batch layouts
        # ((1, dim) lanes vs the dense (batch, dim) block), so their
        # trajectories agree to solve tolerance, not bitwise.
        np.testing.assert_allclose(np.asarray(b.ys), np.asarray(v.ys),
                                   rtol=3e-3, atol=1e-5)

    def test_adjoint_grads_at_latent_shape(self):
        f, y0, p, kw = self._setup()

        def loss(p, mode):
            s = odeint_per_sample(f, y0, 0.0, 1.0, p, engine="batched",
                                  mode=mode, **kw)
            return (jnp.sum(s.ys ** 2)
                    + 10.0 * reg.error_estimate(s.telemetry, agg="mean"))

        ga = jax.grad(lambda p: loss(p, "adjoint"))(p)
        gs = jax.grad(lambda p: loss(p, "scan"))(p)
        for a, b in zip(jax.tree_util.tree_leaves(ga),
                        jax.tree_util.tree_leaves(gs)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=3e-3, atol=5e-5)

    def test_latent_model_routing(self):
        # per_sample="batched" end-to-end through LatentTimeSeriesModel.
        from regneuralde_tpu.models import (
            MLP, AlternatingMLP, LatentGRU, LatentTimeSeriesModel)

        sa = jnp.linspace(0.0, 1.0, 12)
        node = NeuralODE(AlternatingMLP(dim=8, hidden=12, depth=2),
                         time_dep=False, rtol=1e-3, atol=1e-3,
                         max_steps=64, saveat=sa, per_sample="batched")
        model = LatentTimeSeriesModel(
            rnn=LatentGRU(in_dim=5, hidden=8, latent_dim=10),
            enc=MLP(features=(10, 2 * 8)), node=node, dec=Dense(5))
        x = jax.random.normal(jax.random.PRNGKey(0), (4, 12, 11)) * 0.3
        p = model.init(jax.random.PRNGKey(1), x)
        out = model(p, x, jax.random.PRNGKey(2), saveat=sa)
        assert out.result.shape == (4, 12, 5)
        assert out.nfe.shape == (4,)
        assert bool(jnp.all(out.success))


class TestBatchedPytreeState:
    """Pytree states through the batched engine's flatten adapter
    (round 5): the per-lane error scale is elementwise and the lane norm
    is an rms over all the lane's elements, so flattening leaves into
    one dense (batch, D) state must reproduce the vmap engine's step
    sequence exactly."""

    def _setup(self):
        w = jax.random.normal(jax.random.PRNGKey(4), (4, 4)) * 0.4

        def f(t, y, w):
            # FFJORD-shaped coupled pytree: a state block plus a
            # per-sample scalar accumulator driven by it.
            dz = jnp.tanh(y["z"] @ w)
            dlogp = -jnp.sum(dz, axis=-1)
            return {"z": dz, "logp": dlogp}

        y0 = {
            "z": jax.random.normal(jax.random.PRNGKey(5), (5, 4)) * 0.5,
            "logp": jnp.zeros((5,)),
        }
        kw = dict(rtol=1e-4, atol=1e-4, max_steps=96)
        return f, y0, w, kw

    def test_lane_parity_vs_vmap(self):
        f, y0, w, kw = self._setup()
        b = odeint_per_sample(f, y0, 0.0, 1.0, w, engine="batched",
                              mode="scan", **kw)
        v = odeint_per_sample(f, y0, 0.0, 1.0, w, mode="scan", **kw)
        # The vmap engine sums the lane norm leaf-by-leaf; the adapter
        # reduces one concatenated row. Same math, different f32
        # summation order — a borderline accept can flip, moving a lane
        # by one trial step (6 NFE). Most lanes must still agree
        # exactly.
        dn = np.abs(np.asarray(b.stats.nfe) - np.asarray(v.stats.nfe))
        assert dn.max() <= 6, dn
        assert (dn == 0).sum() >= 3, dn
        assert b.y1["z"].shape == (5, 4)
        assert b.y1["logp"].shape == (5,)
        for k in ("z", "logp"):
            np.testing.assert_allclose(np.asarray(b.y1[k]),
                                       np.asarray(v.y1[k]),
                                       rtol=3e-3, atol=1e-5)

    def test_saveat_shapes(self):
        f, y0, w, kw = self._setup()
        sa = jnp.linspace(0.0, 1.0, 7)
        b = odeint_per_sample(f, y0, 0.0, 1.0, w, engine="batched",
                              mode="scan", saveat=sa, **kw)
        assert b.ys["z"].shape == (7, 5, 4)
        assert b.ys["logp"].shape == (7, 5)

    def test_adjoint_grads_match_scan(self):
        f, y0, w, kw = self._setup()

        def loss(w, mode):
            s = odeint_per_sample(f, y0, 0.0, 1.0, w, engine="batched",
                                  mode=mode, **kw)
            return (jnp.sum(s.y1["z"] ** 2) + jnp.sum(s.y1["logp"])
                    + 10.0 * reg.error_estimate(s.telemetry, agg="mean"))

        ga = jax.grad(lambda w: loss(w, "adjoint"))(w)
        gs = jax.grad(lambda w: loss(w, "scan"))(w)
        # Task-gradient agreement is ~5e-7 (measured with the reg term
        # off); the residual tolerance here is the EEst gradient's f32
        # cancellation noise through the 10x reg weight, not adjoint
        # error.
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gs),
                                   rtol=3e-3, atol=2e-3)

    def test_mixed_dtype_rejected(self):
        f, y0, w, kw = self._setup()
        y0 = dict(y0, logp=y0["logp"].astype(jnp.float64))
        if y0["logp"].dtype == y0["z"].dtype:
            pytest.skip("x64 disabled; dtypes coincide")
        with pytest.raises(ValueError, match="common leaf dtype"):
            odeint_per_sample(f, y0, 0.0, 1.0, w, engine="batched", **kw)

"""The differentiable early-exit solve (mode="adjoint").

mode="adjoint" is the training fast path: while_loop forward, custom_vjp
backward replaying only live steps. Its gradient contract is EXACT
equivalence with the bounded-scan discrete adjoint (the reference's
SensitivityADPassThrough semantics) — pinned here in float64, where the
comparison is free of the 1/tol noise amplification through the EEst
chain that dominates float32 deviations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from regneuralde_tpu.ops.norms import hairer_norm
from regneuralde_tpu.ops.ode import odeint


def _dyn(t, y, args):
    (A,) = args
    return jnp.tanh(y @ A) * (1.0 + 0.3 * jnp.sin(3 * t))


def _setup(dtype):
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((6, 6)).astype(dtype) * 0.5)
    y0 = jnp.asarray(rng.standard_normal((4, 6)).astype(dtype))
    return y0, A


class TestAdjointEquivalence:
    def test_forward_identical_to_while(self):
        y0, A = _setup(np.float32)
        kw = dict(rtol=1e-5, atol=1e-5, max_steps=64)
        sa = odeint(_dyn, y0, 0.0, 1.0, (A,), mode="adjoint", **kw)
        sw = odeint(_dyn, y0, 0.0, 1.0, (A,), mode="while", **kw)
        np.testing.assert_array_equal(sa.y1, sw.y1)
        np.testing.assert_array_equal(sa.stats.nfe, sw.stats.nfe)
        np.testing.assert_array_equal(sa.telemetry.eest, sw.telemetry.eest)
        assert bool(sa.stats.success)

    def test_gradients_match_scan_f64(self):
        with jax.enable_x64(True):
            y0, A = _setup(np.float64)
            saveat = jnp.asarray([0.0, 0.3, 0.7, 1.0], jnp.float64)

            def loss(y0, A, t1, mode):
                sol = odeint(
                    _dyn, y0, 0.0, t1, (A,), rtol=1e-5, atol=1e-5,
                    max_steps=64, saveat=saveat, mode=mode,
                )
                reg = jnp.sum(
                    jnp.where(
                        sol.telemetry.accepted,
                        sol.telemetry.eest * sol.telemetry.dt,
                        0.0,
                    )
                )
                return (
                    jnp.sum(sol.y1**2)
                    + 0.1 * jnp.sum(sol.ys**2)
                    + 10.0 * reg
                )

            t1 = jnp.asarray(1.0, jnp.float64)
            grads = {}
            for mode in ("scan", "adjoint"):
                grads[mode] = jax.grad(
                    lambda y0, A, t1: loss(y0, A, t1, mode), argnums=(0, 1, 2)
                )(y0, A, t1)
            for ga, gs in zip(grads["adjoint"], grads["scan"]):
                np.testing.assert_allclose(ga, gs, rtol=1e-9, atol=1e-12)

    def test_loss_value_matches_scan_f32(self):
        y0, A = _setup(np.float32)

        def run(mode):
            sol = odeint(
                _dyn, y0, 0.0, 1.0, (A,), rtol=1e-5, atol=1e-5,
                max_steps=64, mode=mode,
            )
            return sol.y1, sol.stats.naccept, sol.stats.nreject

        ya, na, nra = run("adjoint")
        ys, ns, nrs = run("scan")
        np.testing.assert_array_equal(ya, ys)
        assert int(na) == int(ns) and int(nra) == int(nrs)

    def test_gradients_close_to_scan_f32(self):
        # The replay reruns the forward step from the stored carry (incl.
        # the FSAL derivative), so the only float32 divergence from the
        # scan backward is XLA op-scheduling noise — percent-level at most
        # even through the ~1/tol EEst amplification (exact equality is
        # pinned in f64 above).
        y0, A = _setup(np.float32)

        def loss(A, mode):
            sol = odeint(
                _dyn, y0, 0.0, 1.0, (A,), rtol=1e-5, atol=1e-5,
                max_steps=64, mode=mode,
            )
            reg = jnp.sum(
                jnp.where(
                    sol.telemetry.accepted,
                    sol.telemetry.eest * sol.telemetry.dt,
                    0.0,
                )
            )
            return jnp.sum(sol.y1**2) + 10.0 * reg

        ga = jax.grad(lambda A: loss(A, "adjoint"))(A)
        gs = jax.grad(lambda A: loss(A, "scan"))(A)
        np.testing.assert_allclose(ga, gs, rtol=1e-2, atol=1e-4)

    def test_rejections_present_and_matching(self):
        # A stiff-ish start forces rejections; both modes must agree.
        y0 = jnp.asarray([[1.0, -1.0]], jnp.float32)

        def f(t, y, args):
            return -50.0 * y + jnp.sin(40.0 * t)

        kw = dict(rtol=1e-4, atol=1e-4, max_steps=256, dt0=0.3)
        sa = odeint(f, y0, 0.0, 1.0, None, mode="adjoint", **kw)
        ss = odeint(f, y0, 0.0, 1.0, None, mode="scan", **kw)
        assert int(sa.stats.nreject) > 0
        assert int(sa.stats.nreject) == int(ss.stats.nreject)
        assert int(sa.stats.naccept) == int(ss.stats.naccept)

    def test_failure_is_visible(self):
        y0, A = _setup(np.float32)
        sol = odeint(
            _dyn, y0, 0.0, 1.0, (A,), rtol=1e-8, atol=1e-8, max_steps=4,
            mode="adjoint",
        )
        assert not bool(sol.stats.success)
        assert np.isfinite(np.asarray(sol.y1)).all()

    def test_grad_finite_with_max_steps_headroom(self):
        # Regression: generous max_steps must not poison gradients (the
        # zero-dt final trial step makes the embedded error identically
        # zero; sqrt'(0)=inf used to turn the zero cotangent into NaN).
        y0, A = _setup(np.float32)

        def loss(A):
            sol = odeint(
                _dyn, y0, 0.0, 1.0, (A,), rtol=1e-5, atol=1e-5,
                max_steps=128, mode="adjoint",
            )
            return jnp.sum(sol.y1**2)

        g = jax.grad(loss)(A)
        assert np.isfinite(np.asarray(g)).all()

    def test_mode_error_message(self):
        y0, A = _setup(np.float32)
        with pytest.raises(ValueError, match="adjoint"):
            odeint(_dyn, y0, 0.0, 1.0, (A,), mode="bogus")


class TestHairerNormZeroSafety:
    def test_grad_at_zero_is_zero_not_nan(self):
        g = jax.grad(lambda x: hairer_norm(x))(jnp.zeros((4, 4)))
        assert np.isfinite(np.asarray(g)).all()
        np.testing.assert_array_equal(g, 0.0)

    def test_value_and_grad_away_from_zero(self):
        x = jnp.asarray([[3.0, 4.0]], jnp.float32)
        v, g = jax.value_and_grad(lambda x: hairer_norm(x))(x)
        np.testing.assert_allclose(v, 5.0 / np.sqrt(2.0), rtol=1e-6)
        assert np.isfinite(np.asarray(g)).all()


class TestSDEAdjoint:
    """mode="adjoint" for the SDE core: while_loop forward storing the
    carry incl. the Brownian tail, reverse while_loop over live steps."""

    def _setup(self):
        drift = lambda t, y, a: -a[0] * y
        diff_ = lambda t, y, a: a[1] * y
        y0 = jnp.ones((6, 4)) * 1.5
        args = (jnp.float32(0.8), jnp.float32(0.3))
        return drift, diff_, y0, args

    def test_forward_matches_scan(self):
        from regneuralde_tpu.ops.sde import sdeint

        drift, diff_, y0, args = self._setup()
        key = jax.random.PRNGKey(0)
        kw = dict(key=key, solver="sosri", rtol=1e-2, atol=1e-2, max_steps=64)
        sa = sdeint(drift, diff_, y0, 0.0, 1.0, args, mode="adjoint", **kw)
        ss = sdeint(drift, diff_, y0, 0.0, 1.0, args, mode="scan", **kw)
        np.testing.assert_array_equal(sa.y1, ss.y1)
        assert int(sa.stats.naccept) == int(ss.stats.naccept)
        assert int(sa.stats.nfe1) == int(ss.stats.nfe1)
        assert bool(sa.stats.success)

    def test_grads_match_scan(self):
        from regneuralde_tpu.ops.sde import sdeint

        drift, diff_, y0, args = self._setup()
        key = jax.random.PRNGKey(0)
        saveat = jnp.asarray([0.0, 0.5, 1.0])

        def loss(args, y0, mode):
            sol = sdeint(drift, diff_, y0, 0.0, 1.0, args, key=key,
                         solver="sosri", rtol=1e-2, atol=1e-2, max_steps=64,
                         saveat=saveat, mode=mode)
            reg = jnp.sum(jnp.where(sol.telemetry.accepted,
                                    sol.telemetry.eest * sol.telemetry.dt,
                                    0.0))
            return (jnp.sum(sol.y1**2) + 0.1 * jnp.sum(sol.ys**2)
                    + 5.0 * reg)

        ga = jax.grad(lambda a, y: loss(a, y, "adjoint"), argnums=(0, 1))(
            args, y0)
        gs = jax.grad(lambda a, y: loss(a, y, "scan"), argnums=(0, 1))(
            args, y0)
        for a, b in zip(jax.tree_util.tree_leaves(ga),
                        jax.tree_util.tree_leaves(gs)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=2e-4, atol=1e-6)

    def test_grads_match_scan_with_rejections(self):
        from regneuralde_tpu.ops.sde import sdeint

        # A large initial dt forces rejections so the Brownian-bridge tail
        # path (and its replay) is exercised.
        drift = lambda t, y, a: -20.0 * y * a
        diff_ = lambda t, y, a: 0.5 * y
        y0 = jnp.ones((4, 3))
        a0 = jnp.float32(1.0)
        key = jax.random.PRNGKey(3)

        def solve(a, mode):
            return sdeint(drift, diff_, y0, 0.0, 1.0, a, key=key,
                          solver="sosri", rtol=1e-2, atol=1e-2,
                          max_steps=128, dt0=0.5, mode=mode)

        sa = solve(a0, "adjoint")
        assert int(sa.stats.nreject) > 0
        assert int(sa.stats.nreject) == int(solve(a0, "scan").stats.nreject)

        def loss(a, mode):
            return jnp.sum(solve(a, mode).y1 ** 2)

        ga = jax.grad(lambda a: loss(a, "adjoint"))(a0)
        gs = jax.grad(lambda a: loss(a, "scan"))(a0)
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gs),
                                   rtol=1e-3, atol=1e-6)


@pytest.mark.chip
def test_adjoint_grads_survive_accelerator_precision():
    """The adjoint backward is traced outside the forward's
    default_matmul_precision context; without baking the precision into
    solve_bwd, replayed dynamics contractions run at the GPU's TF32
    default and the controller pullback amplifies the noise into wrong
    parameter gradients. CPU cannot catch this (its default matmul is
    exact f32), so the test runs on the card only."""
    A = jax.random.normal(jax.random.PRNGKey(0), (8, 8)) * 0.3
    y0 = jnp.ones((4, 8))

    def f(t, y, args):
        (A,) = args
        return jnp.tanh(y @ A)

    def loss(args, mode):
        sol = odeint(f, y0, 0.0, 1.0, args, rtol=1e-5, atol=1e-5,
                     max_steps=64, mode=mode)
        return jnp.sum(sol.y1 ** 2)

    ga = jax.jit(jax.grad(lambda a: loss(a, "adjoint")))((A,))
    gs = jax.jit(jax.grad(lambda a: loss(a, "scan")))((A,))
    np.testing.assert_allclose(np.asarray(ga[0]), np.asarray(gs[0]),
                               rtol=1e-3, atol=1e-5)

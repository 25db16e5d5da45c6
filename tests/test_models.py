"""Model-layer tests: modules, DE layers, composites (tiny shapes)."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from regneuralde_tpu.models import (
    FFJORD,
    MLP,
    AlternatingMLP,
    CSLDynamics,
    ClassifierNODE,
    ClassifierNSDE,
    Dense,
    LatentGRU,
    LatentTimeSeriesModel,
    MLPDynamics,
    NeuralODE,
    NeuralSDE,
    RecognitionRNN,
    TDChain,
)

KEY = jax.random.PRNGKey(0)


class TestModules:
    def test_mlp_dynamics_time_dependence(self):
        m = MLPDynamics(dim=6, hidden=8)
        x = jax.random.normal(KEY, (3, 6))
        p = m.init(KEY, x, 0.0)
        y0 = m.apply(p, x, 0.0)
        y1 = m.apply(p, x, 0.7)
        assert y0.shape == (3, 6)
        assert np.abs(np.asarray(y0 - y1)).max() > 1e-6  # t actually matters

    def test_tdchain(self):
        m = TDChain(features=(10, 2))
        x = jax.random.normal(KEY, (4, 3))
        p = m.init(KEY, x, 0.0)
        assert m.apply(p, x, 0.5).shape == (4, 2)

    def test_csl_analytic_vjp_matches_jax_vjp(self):
        # The hand-derived e^T J must equal autodiff's to float precision
        # (the reference hand-derives it at ffjord_tabular.jl:97-106).
        m = CSLDynamics(dim=5, hidden=7)
        x = jax.random.normal(KEY, (4, 5))
        e = jax.random.normal(jax.random.PRNGKey(1), (4, 5))
        p = m.init(KEY, x, 0.3)
        f1, eJ1 = m.apply(p, x, 0.3, e, method=CSLDynamics.forw_n_back)
        f2, vjp = jax.vjp(lambda z: m.apply(p, z, 0.3), x)
        eJ2 = vjp(e)[0]
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), rtol=1e-5)
        np.testing.assert_allclose(np.asarray(eJ1), np.asarray(eJ2), rtol=1e-4,
                                   atol=1e-6)

    def test_latent_gru_freezes_unobserved(self):
        in_dim, latent = 3, 4
        m = LatentGRU(in_dim=in_dim, hidden=5, latent_dim=latent)
        # (batch=2, time=4, 2*in+1); all masks zero -> state stays zero.
        xs = jnp.concatenate(
            [jax.random.normal(KEY, (2, 4, in_dim)),
             jnp.zeros((2, 4, in_dim)),
             jnp.ones((2, 4, 1))], -1)
        p = m.init(KEY, xs)
        out = m.apply(p, xs)
        np.testing.assert_allclose(np.asarray(out), 0.0, atol=1e-7)
        # With masks on, the state moves.
        xs_obs = xs.at[:, :, in_dim : 2 * in_dim].set(1.0)
        out2 = m.apply(p, xs_obs)
        assert np.abs(np.asarray(out2)).max() > 1e-4

    def test_recognition_rnn_shape(self):
        m = RecognitionRNN(latent_dim=4, hidden=6)
        xs = jax.random.normal(KEY, (3, 5, 2))
        p = m.init(KEY, xs)
        assert m.apply(p, xs).shape == (3, 8)

    def test_alternating_mlp(self):
        m = AlternatingMLP(dim=4, hidden=6, depth=2)
        x = jax.random.normal(KEY, (3, 4))
        p = m.init(KEY, x)
        assert m.apply(p, x).shape == (3, 4)


class TestNeuralODE:
    def test_forward_and_grad(self):
        node = NeuralODE(MLPDynamics(dim=4, hidden=6), rtol=1e-4, atol=1e-4,
                         max_steps=64)
        x = jax.random.normal(KEY, (5, 4))
        p = node.init(KEY, x)
        out = node(p, x)
        assert out.value.shape == (5, 4)
        assert int(out.nfe) > 0

        def loss(p):
            return jnp.sum(node(p, x).value ** 2)

        g = jax.grad(loss)(p)
        assert all(np.isfinite(np.asarray(l)).all()
                   for l in jax.tree_util.tree_leaves(g))

    def test_trajectory_output(self):
        node = NeuralODE(MLPDynamics(dim=3, hidden=4), rtol=1e-4, atol=1e-4,
                         saveat=jnp.linspace(0, 1, 7), max_steps=64)
        x = jax.random.normal(KEY, (2, 3))
        p = node.init(KEY, x)
        out = node(p, x)
        assert out.value.shape == (2, 7, 3)
        np.testing.assert_allclose(np.asarray(out.value[:, 0]), np.asarray(x),
                                   rtol=1e-5)

    def test_time_independent_dynamics(self):
        node = NeuralODE(MLP(features=(6, 3)), time_dep=False,
                         rtol=1e-4, atol=1e-4, max_steps=64)
        x = jax.random.normal(KEY, (2, 3))
        p = node.init(KEY, x)
        assert node(p, x).value.shape == (2, 3)


class TestNeuralSDE:
    def test_forward_shapes_and_counters(self):
        nsde = NeuralSDE(MLP(features=(8, 4)), MLP(features=(4,)),
                         rtol=0.14, atol=0.14, max_steps=64)
        x = jax.random.normal(KEY, (6, 4))
        p = nsde.init(KEY, x)
        out = nsde(p, x, jax.random.PRNGKey(5))
        assert out.value.shape == (6, 4)
        # default solver is the 4+4-evaluation SOSRI-opt tableau
        from regneuralde_tpu.ops import sri

        tab = sri.get_tableau("sosri")
        ratio = (sri.diffusion_evals_per_step(tab)
                 / sri.drift_evals_per_step(tab))
        assert int(out.nfe1) * ratio == int(out.nfe2)

    def test_saveat_trajectory(self):
        nsde = NeuralSDE(MLP(features=(4,)), MLP(features=(4,)),
                         rtol=0.3, atol=0.3, max_steps=64,
                         saveat=jnp.linspace(0, 1, 5))
        x = jax.random.normal(KEY, (2, 4))
        p = nsde.init(KEY, x)
        out = nsde(p, x, jax.random.PRNGKey(5))
        assert out.value.shape == (2, 5, 4)


class TestFFJORD:
    def test_zero_flow_gives_base_density(self):
        m = CSLDynamics(dim=3, hidden=4)
        ff = FFJORD(m, input_dim=3, rtol=1e-6, atol=1e-6, max_steps=64)
        x = jax.random.normal(KEY, (5, 3))
        p = ff.init(KEY, x)
        p0 = jax.tree_util.tree_map(jnp.zeros_like, p)  # zero dynamics
        out = ff(p0, x, jax.random.PRNGKey(1))
        expected = np.sum(
            -(math.log(2 * math.pi) + np.asarray(x) ** 2) / 2, axis=-1
        )
        np.testing.assert_allclose(np.asarray(out.logpx), expected, rtol=1e-4)

    def test_hutchinson_vs_exact_vjp_paths(self):
        m = CSLDynamics(dim=3, hidden=4)
        x = jax.random.normal(KEY, (4, 3))
        e = jax.random.normal(jax.random.PRNGKey(2), (4, 3))
        ff_a = FFJORD(m, input_dim=3, rtol=1e-5, atol=1e-5, analytic_vjp=True)
        ff_b = FFJORD(m, input_dim=3, rtol=1e-5, atol=1e-5, analytic_vjp=False)
        p = ff_a.init(KEY, x)
        o_a = ff_a(p, x, KEY, e=e)
        o_b = ff_b(p, x, KEY, e=e)
        np.testing.assert_allclose(np.asarray(o_a.logpx), np.asarray(o_b.logpx),
                                   rtol=1e-4, atol=1e-4)

    def test_kinetic_reg_terms(self):
        m = CSLDynamics(dim=2, hidden=4)
        ff = FFJORD(m, input_dim=2, rtol=1e-4, atol=1e-4)
        x = jax.random.normal(KEY, (3, 2))
        p = ff.init(KEY, x)
        out = ff(p, x, KEY, kinetic_reg=True)
        assert np.all(np.asarray(out.kinetic) >= 0)
        assert np.all(np.asarray(out.jacobian) >= 0)
        assert np.abs(np.asarray(out.kinetic)).max() > 0

    def test_sample_roundtrip_zero_flow(self):
        m = CSLDynamics(dim=2, hidden=4)
        ff = FFJORD(m, input_dim=2, rtol=1e-5, atol=1e-5)
        p = ff.init(KEY, jnp.ones((1, 2)))
        p0 = jax.tree_util.tree_map(jnp.zeros_like, p)
        s = ff.sample(p0, jax.random.PRNGKey(3), 64)
        assert s.shape == (64, 2)
        # zero flow -> samples are exactly the base draws: std ~ 1
        assert 0.7 < float(jnp.std(s)) < 1.3

    def test_grad_through_logpx(self):
        m = CSLDynamics(dim=2, hidden=4)
        ff = FFJORD(m, input_dim=2, rtol=1e-4, atol=1e-4, max_steps=64)
        x = jax.random.normal(KEY, (4, 2))
        p = ff.init(KEY, x)

        def loss(p):
            return -jnp.mean(ff(p, x, jax.random.PRNGKey(1)).logpx)

        g = jax.grad(loss)(p)
        assert all(np.isfinite(np.asarray(l)).all()
                   for l in jax.tree_util.tree_leaves(g))


class TestComposites:
    def test_classifier_node(self):
        node = NeuralODE(MLPDynamics(dim=8, hidden=6), rtol=1e-3, atol=1e-3,
                         max_steps=64)
        clf = ClassifierNODE(None, node, Dense(3))
        x = jax.random.normal(KEY, (4, 8))
        p = clf.init(KEY, x)
        out = clf(p, x)
        assert out.logits.shape == (4, 3)

        def loss(p):
            return jnp.sum(clf(p, x).logits ** 2)

        g = jax.grad(loss)(p)
        assert all(np.isfinite(np.asarray(l)).all()
                   for l in jax.tree_util.tree_leaves(g))

    def test_classifier_nsde_trajectories(self):
        nsde = NeuralSDE(MLP(features=(8, 4)), MLP(features=(4,)),
                         rtol=0.3, atol=0.3, max_steps=64)
        clf = ClassifierNSDE(Dense(4), nsde, Dense(3))
        x = jax.random.normal(KEY, (5, 7))
        p = clf.init(KEY, x)
        out = clf(p, x, jax.random.PRNGKey(9), trajectories=3)
        assert out.logits.shape == (5, 3)

    def test_latent_time_series(self):
        in_dim, latent = 3, 4
        rnn = LatentGRU(in_dim=in_dim, hidden=6, latent_dim=5)
        enc = MLP(features=(6, 2 * latent))
        node = NeuralODE(AlternatingMLP(dim=latent, hidden=6, depth=1),
                         time_dep=False, rtol=1e-3, atol=1e-3, max_steps=64,
                         saveat=jnp.linspace(0, 1, 6))
        dec = Dense(in_dim)
        model = LatentTimeSeriesModel(rnn, enc, node, dec)
        xs = jax.random.normal(KEY, (2, 6, 2 * in_dim + 1))
        p = model.init(KEY, xs)
        out = model(p, xs, jax.random.PRNGKey(3))
        assert out.result.shape == (2, 6, in_dim)
        assert out.mu0.shape == (2, latent)
        assert out.logvar.shape == (2, latent)

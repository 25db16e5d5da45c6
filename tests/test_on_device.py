"""On-device checks the CPU suite cannot make (marker ``chip``).

The CPU's default matmul is exact float32; the GPU's is TF32. A custom
backward traced outside the forward's ``default_matmul_precision``
context, or an engine that forgets to bake ``HIGHEST`` in, is invisible on
the CPU and corrupts gradients or step counts on the card. These tests
skip here and run on the GPU (``python chip_smoke.py``, or
``REGNDE_CHIP_TESTS=1 python -m pytest tests -m chip -n 0``). The
companion ``test_adjoint.py::test_adjoint_grads_survive_accelerator_precision``
covers the global adjoint engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from regneuralde_tpu.ops import odeint, odeint_per_sample

pytestmark = pytest.mark.chip


def _dynamics():
    A = jax.random.normal(jax.random.PRNGKey(4), (8, 8)) * 0.3

    def f(t, y, args):
        (A,) = args
        return jnp.tanh(y @ A)

    y0 = jnp.stack([jnp.ones(8), 2 * jnp.ones(8), -0.5 * jnp.ones(8)])
    return f, (A,), y0


def test_per_sample_lane_parity_and_grads_on_device():
    """Per-sample mode compiled for the card: each lane matches solving
    its sample alone (equal NFE; values to float32 roundoff, since the
    vmap'd batch and the lone (1, 8) solve lower to different fusions)
    and adjoint gradients match the scan oracle."""
    f, args, y0 = _dynamics()
    kw = dict(rtol=1e-5, atol=1e-5, max_steps=64)
    sol = jax.jit(lambda y: odeint_per_sample(f, y, 0.0, 1.0, args,
                                              mode="while", **kw))(y0)
    for i in range(3):
        si = jax.jit(lambda y: odeint(f, y, 0.0, 1.0, args, mode="while",
                                      **kw))(y0[i : i + 1])
        assert int(sol.stats.nfe[i]) == int(si.stats.nfe), (
            f"lane {i}: nfe {int(sol.stats.nfe[i])} != {int(si.stats.nfe)}")
        np.testing.assert_allclose(np.asarray(sol.y1[i]),
                                   np.asarray(si.y1[0]),
                                   rtol=5e-5, atol=1e-6)

    def loss(a, mode):
        s = odeint_per_sample(f, y0, 0.0, 1.0, a, mode=mode, **kw)
        return jnp.sum(s.y1 ** 2)

    ga = jax.jit(jax.grad(lambda a: loss(a, "adjoint")))(args)
    gs = jax.jit(jax.grad(lambda a: loss(a, "scan")))(args)
    np.testing.assert_allclose(np.asarray(ga[0]), np.asarray(gs[0]),
                               rtol=1e-3, atol=1e-5)


def test_per_sample_batched_engine_on_device():
    """The per-lane-controller batched engine on the card: per-lane step
    counts track the vmap engine within one trial step, and values,
    gradients and saveat trajectories agree. Guards the reduced-precision
    EEst failure class: without the engine's baked matmul precision,
    default (TF32) dots flood the per-lane error estimate and lanes run
    to the step cap."""
    f, args, y0 = _dynamics()
    kw = dict(rtol=1e-6, atol=1e-6, max_steps=64)
    sv = jax.jit(lambda y: odeint_per_sample(f, y, 0.0, 1.0, args,
                                             mode="while", **kw))(y0)
    sb = jax.jit(lambda y: odeint_per_sample(f, y, 0.0, 1.0, args,
                                             engine="batched", **kw))(y0)
    assert bool(np.asarray(sb.stats.success).all()), "batched lanes capped"
    dn = np.abs(np.asarray(sv.stats.nfe) - np.asarray(sb.stats.nfe))
    assert (dn <= 6).all(), (
        f"per-lane NFE drift vmap={np.asarray(sv.stats.nfe)} "
        f"batched={np.asarray(sb.stats.nfe)}")
    np.testing.assert_allclose(np.asarray(sb.y1), np.asarray(sv.y1),
                               rtol=2e-4, atol=1e-6)

    def loss(a, engine):
        s = odeint_per_sample(f, y0, 0.0, 1.0, a, engine=engine, **kw)
        return jnp.sum(s.y1 ** 2)

    gb = jax.jit(jax.grad(lambda a: loss(a, "batched")))(args)
    gv = jax.jit(jax.grad(lambda a: loss(a, "vmap")))(args)
    np.testing.assert_allclose(np.asarray(gb[0]), np.asarray(gv[0]),
                               rtol=5e-3, atol=1e-4)

    sa = jnp.asarray([0.0, 0.4, 1.0])
    tv = jax.jit(lambda y: odeint_per_sample(
        f, y, 0.0, 1.0, args, mode="scan", saveat=sa, **kw))(y0)
    tb = jax.jit(lambda y: odeint_per_sample(
        f, y, 0.0, 1.0, args, engine="batched", saveat=sa, **kw))(y0)
    np.testing.assert_allclose(np.asarray(tb.ys), np.asarray(tv.ys),
                               rtol=2e-4, atol=1e-5)

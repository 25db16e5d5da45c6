"""Validation of the SRI solver core (ops/sri.py).

The reference integrates neural SDEs with StochasticDiffEq's
SOSRI/SOSRI2 (src/models/neural_sde.jl:54-55). This suite validates our
tableau-driven rebuild the hard way:

* algebraic: every registered tableau satisfies the diagonal-noise
  strong-order-1.5 order conditions to machine precision;
* deterministic: with g == 0 the drift tableau converges at order 2;
* stochastic: strong self-convergence at order ~1.5 on a nonlinear
  diagonal SDE, with (dW, I10) aggregated *exactly* across refinement
  levels (the multilevel coupling that makes the measured slope the
  method's true strong order);
* stability: the derived SOSRI-opt/SOSRI2-opt tableaus have the computed
  stability intervals (~12.0 / ~11.3 vs SRIW1's 2.0) and actually remain
  stable on a stiff linear problem where SRIW1's region is exceeded;
* accounting: per-step NFE counts derive from tableau sparsity.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from regneuralde_tpu.ops import sri

@pytest.fixture(autouse=True, scope="module")
def _x64():
    """Convergence-order measurement needs float64; scope it to this
    module so the float32 expectations elsewhere are untouched."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


_SQRT3 = math.sqrt(3.0)
ALL = ["sriw1", "sosri", "sosri2"]


# ---------------------------------------------------------------------------
# Algebraic order conditions + stability
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL)
def test_order_conditions(name):
    tab = sri.get_tableau(name)
    res = sri.order_condition_residuals(tab)
    worst = max(abs(v) for v in res.values())
    assert worst < 1e-12, res


def test_stability_sizes():
    assert sri.stability_size(sri.get_tableau("sriw1")) == pytest.approx(2.0, abs=1e-6)
    assert sri.stability_size(sri.get_tableau("sosri")) == pytest.approx(12.0, abs=0.1)
    assert sri.stability_size(sri.get_tableau("sosri2")) == pytest.approx(11.3, abs=0.1)


def test_nfe_accounting_from_sparsity():
    assert sri.drift_evals_per_step(sri.get_tableau("sriw1")) == 2
    assert sri.diffusion_evals_per_step(sri.get_tableau("sriw1")) == 4
    assert sri.drift_evals_per_step(sri.get_tableau("sosri")) == 4
    assert sri.diffusion_evals_per_step(sri.get_tableau("sosri")) == 4


def test_stiff_linear_stability():
    """Fixed-step on y' = lambda*y with lambda*h = -8: inside SOSRI-opt's
    stability interval (12.0), far outside SRIW1's (2.0)."""
    z = -8.0

    def growth(name):
        coeffs = sri.stability_function_coeffs(sri.get_tableau(name))
        return abs(sum(c * z ** k for k, c in enumerate(coeffs)))

    assert growth("sosri") < 1.0
    assert growth("sosri2") < 1.0
    assert growth("sriw1") > 1.0


# ---------------------------------------------------------------------------
# Fixed-step integration harness (drives sri_step directly, float64)
# ---------------------------------------------------------------------------

def _run_fixed(tab, drift, diffusion, y0, T, dW, dZ):
    """Integrate with fixed steps; dW/dZ are (n_steps,) + y0.shape."""
    n = dW.shape[0]
    dt = jnp.asarray(T / n, jnp.float64)

    def body(carry, inc):
        t, y = carry
        dw, dz = inc
        y1, _, _ = sri.sri_step(tab, drift, diffusion, None, t, y, dt, dw, dz)
        return (t + dt, y1), None

    (_, y1), _ = jax.lax.scan(body, (jnp.asarray(0.0, jnp.float64), y0), (dW, dZ))
    return y1


@pytest.mark.parametrize("name", ALL)
def test_deterministic_order2(name):
    """g == 0: the drift tableau is an order-2 RK method."""
    tab = sri.get_tableau(name)
    drift = lambda t, y, a: y - y ** 3 + jnp.sin(3.0 * t)
    diffusion = lambda t, y, a: jnp.zeros_like(y)
    y0 = jnp.asarray([0.4], jnp.float64)
    T = 1.0

    def solve(n):
        z = jnp.zeros((n, 1), jnp.float64)
        return _run_fixed(tab, drift, diffusion, y0, T, z, z)

    ref = solve(4096)
    errs, hs = [], []
    for n in (16, 32, 64, 128):
        errs.append(float(jnp.abs(solve(n) - ref).max()))
        hs.append(T / n)
    slope = np.polyfit(np.log(hs), np.log(errs), 1)[0]
    assert 1.8 < slope < 2.3, (slope, errs)


@pytest.mark.parametrize("name", ALL)
def test_strong_order_1p5_diagonal(name):
    """Strong self-convergence at order ~1.5 on a nonlinear diagonal SDE.

    The Brownian data is refined EXACTLY: coarse dW sums fine dW; coarse
    I10 aggregates as I10_H = sum_j (I10_j + (W_tj - W_t0) h_j), then is
    re-expressed as the dZ the stepper consumes. With exact (I1, I10) per
    step, the Rößler theorem gives strong order 1.5 — a wrong tableau
    drops to ~1.0 and fails the slope band.
    """
    tab = sri.get_tableau(name)
    drift = lambda t, y, a: y - y ** 3
    diffusion = lambda t, y, a: 0.4 * y + 0.2 * jnp.cos(y)
    n_paths = 4096
    fine = 512
    T = 1.0
    hf = T / fine
    rng = np.random.default_rng(42)
    dW_f = rng.normal(0.0, math.sqrt(hf), (fine, n_paths)).astype(np.float64)
    dZ_f = rng.normal(0.0, math.sqrt(hf), (fine, n_paths)).astype(np.float64)
    I10_f = hf / 2.0 * (dW_f + dZ_f / _SQRT3)

    y0 = jnp.full((n_paths,), 0.5, jnp.float64)
    ref = _run_fixed(tab, drift, diffusion, y0, T, jnp.asarray(dW_f),
                     jnp.asarray(dZ_f))

    errs, hs = [], []
    for n in (16, 32, 64):
        k = fine // n
        H = T / n
        dW_c = dW_f.reshape(n, k, n_paths)
        # W at fine-subinterval starts, relative to each coarse start
        w_prefix = np.cumsum(dW_c, axis=1) - dW_c  # exclusive prefix sums
        I10_c = (I10_f.reshape(n, k, n_paths) + w_prefix * hf).sum(axis=1)
        dW_agg = dW_c.sum(axis=1)
        dZ_agg = _SQRT3 * (2.0 * I10_c / H - dW_agg)
        y = _run_fixed(tab, drift, diffusion, y0, T, jnp.asarray(dW_agg),
                       jnp.asarray(dZ_agg))
        errs.append(float(jnp.abs(y - ref).mean()))
        hs.append(H)
    slope = np.polyfit(np.log(hs), np.log(errs), 1)[0]
    assert 1.25 < slope < 1.8, (slope, errs)


@pytest.mark.parametrize("name", ALL)
def test_gbm_weak_mean(name):
    """Weak sanity: E[y(T)] on GBM matches y0*exp(mu*T) within MC error."""
    tab = sri.get_tableau(name)
    mu, sig = 0.3, 0.5
    drift = lambda t, y, a: mu * y
    diffusion = lambda t, y, a: sig * y
    n_paths, n_steps = 200_000, 32
    hf = 1.0 / n_steps
    rng = np.random.default_rng(7)
    dW = jnp.asarray(rng.normal(0, math.sqrt(hf), (n_steps, n_paths)))
    dZ = jnp.asarray(rng.normal(0, math.sqrt(hf), (n_steps, n_paths)))
    y0 = jnp.ones((n_paths,), jnp.float64)
    y1 = _run_fixed(tab, drift, diffusion, y0, 1.0, dW, dZ)
    expect = math.exp(mu)
    se = float(jnp.std(y1)) / math.sqrt(n_paths)
    assert abs(float(jnp.mean(y1)) - expect) < 5 * se + 1e-4


# ---------------------------------------------------------------------------
# Adaptive behavior through sdeint
# ---------------------------------------------------------------------------

def test_nfe_vs_tolerance_monotone():
    """mnist_nsde-shaped config: NFE decreases as tolerance loosens, and
    the step count at the reference's rtol=atol=1.4e-1 lands in a sane
    band (the tolerance-for-tolerance comparability axis of
    experiments/mnist_nsde.jl:79-80)."""
    from regneuralde_tpu.ops.sde import sdeint

    rng = np.random.default_rng(0)
    W1 = jnp.asarray(rng.standard_normal((32, 64)) * 0.3)
    W2 = jnp.asarray(rng.standard_normal((64, 32)) * 0.3)
    Wd = jnp.asarray(rng.standard_normal((32, 32)) * 0.2)
    drift = lambda t, y, a: jnp.tanh(y @ W1) @ W2
    diffusion = lambda t, y, a: y @ Wd * 0.1
    y0 = jnp.asarray(rng.standard_normal((16, 32)), jnp.float64)

    nfes = []
    for tol in (1.4e-2, 1.4e-1, 4e-1):
        sol = sdeint(drift, diffusion, y0, 0.0, 1.0,
                     key=jax.random.PRNGKey(1), solver="sosri",
                     rtol=tol, atol=tol, max_steps=512)
        assert bool(sol.stats.success)
        nfes.append(int(sol.stats.nfe1))
    assert nfes[0] >= nfes[1] >= nfes[2], nfes
    steps_at_ref_tol = nfes[1] // 4
    assert 2 <= steps_at_ref_tol <= 80, nfes


def test_sosri_fewer_steps_than_sriw1_when_stiff():
    """On a stiff drift the stability-optimized tableau should not need
    more accepted steps than SRIW1 (usually far fewer rejections)."""
    from regneuralde_tpu.ops.sde import sdeint

    drift = lambda t, y, a: -40.0 * y
    diffusion = lambda t, y, a: 0.05 * y
    y0 = jnp.ones((8, 4), jnp.float64)
    counts = {}
    for name in ("sriw1", "sosri"):
        sol = sdeint(drift, diffusion, y0, 0.0, 1.0,
                     key=jax.random.PRNGKey(3), solver=name,
                     rtol=1.4e-1, atol=1.4e-1, max_steps=1024)
        assert bool(sol.stats.success)
        counts[name] = int(sol.stats.naccept) + int(sol.stats.nreject)
    assert counts["sosri"] <= counts["sriw1"], counts


def test_unknown_tableau_raises():
    with pytest.raises(ValueError, match="sosri"):
        sri.get_tableau("nope")

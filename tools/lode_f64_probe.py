"""Latent-ODE regularizer-gradient SNR probe: f32 vs f64 (VERDICT r2 #2).

The round-2 latent-ODE experiment found the EEst*dt regularizer neutral-to-
harmful on the physionet surrogate, conjecturing that at rtol=1.4e-8 the
20-dim latent state's embedded error estimate sits at the float32
cancellation-noise floor, so d(reg)/d(theta) carries noise rather than
signal. This probe tests that causally WITHOUT a 120-epoch run: at
matched parameters (init + after a few f32 training steps), compute the
regularizer gradient in f32 and in f64 (the ground truth — the x64 solver
path is test-proven) and report cosine similarity + norm ratio per
parameter group. cos ~ 1 kills the precision explanation; cos ~ 0
confirms it. Runs on the default device (the GPU computes float64 in
hardware):

    python tools/lode_f64_probe.py [rtol]
"""
import sys
from pathlib import Path as _P
sys.path.insert(0, str(_P(__file__).resolve().parent.parent))
import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import optax

from regneuralde_tpu import reg
from regneuralde_tpu.data import load_physionet
from regneuralde_tpu.models import (MLP, AlternatingMLP, Dense, LatentGRU,
                                    LatentTimeSeriesModel, NeuralODE)
from regneuralde_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
from regneuralde_tpu.training import create_train_state, latent_ode_optimizer

B = 64
# Round 4: the tolerance is the probe's control variable. Sweeping it
# (argv, default = the reference's 1.4e-8) located the regime where the
# f32 reg gradient carries real signal on this surrogate: at rtol=1e-3,
# step6 measures cos(f32,f64)=+0.95 (smooth surrogate) / +0.93 (rough,
# REGNDE_SURROGATE_FREQ=4,12), vs +0.03..0.45 at 1e-5..1.4e-8 — the
# noise is NOT tolerance-relative; only loose-tolerance solves whose
# EEst sits well above f32 cancellation give a clean direction. That
# rtol=1e-3 regime is where the round-4 vanilla-vs-ERNODE latent
# training pair demonstrates the NFE-reduction mechanism.
RTOL = float(sys.argv[1]) if len(sys.argv) > 1 else 1.4e-8
train_loader, _ = load_physionet(B, seed=0)
batches = []
for b in train_loader:
    if b[0].shape[0] == B:
        batches.append(tuple(np.asarray(a) for a in b[:6]))
    if len(batches) >= 4:
        break
d0, m0, _, _, tp0, _ = batches[0]
saveat64 = jnp.sort(jnp.asarray(tp0[0], jnp.float64))


def build(dtype, compensated=False, stage_round32=False):
    """``compensated``: double-f32 estimator arithmetic (ops.compensated,
    round 5). ``stage_round32``: keep every estimator/controller op at
    ``dtype`` (f64) but round each stage EVALUATION's input and output to
    f32 — the 'perfect estimator arithmetic, f32-limited stages' ceiling
    leg: if THIS leg's cos is low, no estimator-side arithmetic (however
    compensated) can recover the signal, because it never reaches the
    estimator."""
    dyn = AlternatingMLP(dim=20, hidden=50, depth=4)
    if stage_round32:
        r32 = lambda v: jnp.asarray(jnp.asarray(v, jnp.float32), dtype)
        dynamics = lambda p, y: r32(dyn.apply(p, r32(y)))
    else:
        dynamics = dyn
    node = NeuralODE(dynamics,
                     time_dep=False, solver="tsit5", rtol=RTOL,
                     atol=RTOL, max_steps=768,
                     compensated_eest=compensated,
                     # pin the time dtype: under x64, python-float tspan
                     # promotes the whole solve to f64
                     tspan=(jnp.asarray(0.0, dtype), jnp.asarray(1.0, dtype)),
                     saveat=saveat64.astype(dtype))
    model = LatentTimeSeriesModel(
        rnn=LatentGRU(in_dim=37, hidden=40, latent_dim=50),
        enc=MLP(features=(50, 2 * 20)), node=node, dec=Dense(37))
    return model


def inputs(d, m, tp, dtype):
    d = jnp.asarray(d, dtype); m = jnp.asarray(m, dtype)
    tp = jnp.asarray(tp, dtype)
    dt = jnp.concatenate([tp[:, 1:] - tp[:, :-1],
                          jnp.zeros_like(tp[:, :1])], 1)
    return jnp.concatenate([d, m, dt[..., None]], axis=-1)


def cast_tree(tree, dtype):
    return jax.tree_util.tree_map(lambda l: jnp.asarray(l, dtype), tree)


def reg_grad(model, params, batch, dtype, key, which="reg"):
    d, m, _, _, tp, _ = batch
    x = inputs(d, m, tp, dtype)

    def loss(p):
        out = model(p, x, key, saveat=saveat64.astype(dtype), mode="scan")
        if which == "reg":
            return reg.error_estimate(out.telemetry, agg="mean")
        # task control: masked Gaussian LL (sans constants) — expected to
        # carry clean f32 gradients (cos ~ 1), isolating the reg term
        err = (out.result - jnp.asarray(d, dtype)) * jnp.asarray(m, dtype)
        return jnp.mean(jnp.sum(jnp.square(err), axis=(1, 2)))

    return jax.grad(loss)(cast_tree(params, dtype))


def full_loss_fn(model, saveat, sigma=0.01):
    def loss_fn(params, d, m, tp, key):
        x = inputs(d, m, tp, jnp.float32)
        out = model(params, x, key, saveat=saveat, mode="scan")
        err = (out.result - jnp.asarray(d, jnp.float32)) * jnp.asarray(m, jnp.float32)
        ll = jnp.sum(-jnp.square(err) / (2 * sigma ** 2), axis=(1, 2))
        ll = ll / jnp.maximum(jnp.sum(jnp.asarray(m, jnp.float32), (1, 2)), 1.0)
        kl = jnp.mean(jnp.exp(out.logvar) + jnp.square(out.mu0) - 1
                      - out.logvar, axis=-1) / 2
        return -jnp.mean(ll - kl)
    return loss_fn


def cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return float("nan")
    return float(a @ b / (na * nb))


m32 = build(jnp.float32)
m64 = build(jnp.float64)
key = jax.random.PRNGKey(3)
params = m32.init(key, inputs(d0, m0, tp0, jnp.float32))
params = cast_tree(params, jnp.float32)

# a few f32 training steps on the task loss to move off init
opt = latent_ode_optimizer()
loss_fn = full_loss_fn(m32, saveat64.astype(jnp.float32))
state = create_train_state(params, opt)
step = jax.jit(lambda s, d, m, tp, k: _step(s, d, m, tp, k))
def _step(s, d, m, tp, k):
    l, g = jax.value_and_grad(loss_fn)(s.params, d, m, tp, k)
    u, os_ = opt.update(g, s.opt_state, s.params)
    return type(s)(optax.apply_updates(s.params, u), os_, s.step + 1), l

ckpts = {"init": state.params}
k = jax.random.PRNGKey(11)
for i in range(6):
    k, sk = jax.random.split(k)
    state, l = step(state, *batches[i % len(batches)][:2],
                    batches[i % len(batches)][4], sk)
ckpts["step6"] = state.params
print("moved off init; task loss:", float(l))

probe_key = jax.random.PRNGKey(42)
for which in ("reg", "task"):
    for name, p in ckpts.items():
        g32 = reg_grad(m32, p, batches[0], jnp.float32, probe_key, which)
        g64 = reg_grad(m64, p, batches[0], jnp.float64, probe_key, which)
        # dynamics ("de") params are what the reg term is supposed to shape
        for group in ("de", "rnn", "enc"):
            a = jnp.concatenate([x.ravel() for x in
                                 jax.tree_util.tree_leaves(g32[group])])
            b = jnp.concatenate([x.ravel() for x in
                                 jax.tree_util.tree_leaves(g64[group])])
            print(f"rtol={RTOL:g} {which:4s} {name:6s} {group:4s} "
                  f"cos(f32,f64)={cos(a,b):+.4f} "
                  f"|f32|={float(jnp.linalg.norm(a)):.3e} "
                  f"|f64|={float(jnp.linalg.norm(b.astype(jnp.float32))):.3e}")

# ---------------------------------------------------------------------------
# Round-5 estimator-arithmetic legs (VERDICT-r4 #3): can compensated
# (double-f32) estimator arithmetic push the EEst noise floor below the
# tolerance? Three legs against the same f64 truth, reg gradient, "de"
# group:
#   f32        the baseline (known low cos at 1.4e-8)
#   f32comp    double-f32 error combination + scaled norm (ops.compensated)
#   f64stage32 PERFECT (f64) estimator/controller arithmetic with only the
#              stage evaluations rounded to f32 — the information-theoretic
#              ceiling of ANY estimator-side arithmetic on f32 stages
# If f64stage32 is already low, the floor is stage-input rounding amplified
# through the dynamics, and no compensated summation can recover it.
# ---------------------------------------------------------------------------
print("\n# round-5 estimator-arithmetic legs")
m32c = build(jnp.float32, compensated=True)
m64r = build(jnp.float64, stage_round32=True)
legs = [("f32", m32, jnp.float32), ("f32comp", m32c, jnp.float32),
        ("f64stage32", m64r, jnp.float64)]
for name, p in ckpts.items():
    g64 = reg_grad(m64, p, batches[0], jnp.float64, probe_key, "reg")
    b = jnp.concatenate([x.ravel() for x in
                         jax.tree_util.tree_leaves(g64["de"])])
    for label, mdl, dtype in legs:
        g = reg_grad(mdl, p, batches[0], dtype, probe_key, "reg")
        a = jnp.concatenate([x.ravel() for x in
                             jax.tree_util.tree_leaves(g["de"])])
        print(f"rtol={RTOL:g} reg {name:6s} de   "
              f"cos({label},f64)={cos(a, b):+.4f} "
              f"|{label}|={float(jnp.linalg.norm(a.astype(jnp.float32))):.3e}")

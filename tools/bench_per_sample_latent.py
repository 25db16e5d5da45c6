"""Latent-shape per-sample cost: batched engine vs vmap vs global.

Costs per-sample adaptive stepping on the latent-ODE workload (batch 256,
latent-20 AlternatingMLP dynamics decoded at 49 stamps, Tsit5
rtol=atol=1.4e-8 — the bench.py latent leg's shape): full value_and_grad
of the masked-LL + KL + EEst*dt loss. One process, round-robin medians,
scalar-synced.

  global      shared controller, adjoint engine
  ps_batched  per-series controllers, dense per-lane engine
  ps_vmap     per-series controllers, vmap engine (known-bad cost class)

    python tools/bench_per_sample_latent.py
"""
import json
import sys
import time
from pathlib import Path as _P

sys.path.insert(0, str(_P(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

from regneuralde_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import numpy as np  # noqa: E402

from regneuralde_tpu import reg  # noqa: E402
from regneuralde_tpu.data import load_physionet  # noqa: E402
from regneuralde_tpu.models import (  # noqa: E402
    MLP, AlternatingMLP, Dense, LatentGRU, LatentTimeSeriesModel, NeuralODE)

B = 256
RT = 1.4e-8
MAX_STEPS = 256
ROUNDS = 5
INNER = 3


def main():
    train_loader, _ = load_physionet(B, seed=0)
    for b in train_loader:
        if b[0].shape[0] == B:
            d0, m0, _, _, tp0, _ = (jnp.asarray(a) for a in b[:6])
            break
    saveat = jnp.sort(tp0[0])
    dt = jnp.concatenate([tp0[:, 1:] - tp0[:, :-1],
                          jnp.zeros_like(tp0[:, :1])], 1)
    x = jnp.concatenate([d0, m0, dt[..., None]], axis=-1)
    key = jax.random.PRNGKey(9)
    sync = lambda r: float(np.asarray(jax.tree_util.tree_leaves(r)[0]
                                      ).ravel()[0])

    variants = {
        "global": dict(per_sample=False),
        "ps_batched": dict(per_sample="batched"),
        "ps_vmap": dict(per_sample=True),
    }

    fns = {}
    nfes = {}
    for name, kw in variants.items():
        node = NeuralODE(AlternatingMLP(dim=20, hidden=50, depth=4),
                         time_dep=False, solver="tsit5", rtol=RT, atol=RT,
                         max_steps=MAX_STEPS, saveat=saveat, **kw)
        model = LatentTimeSeriesModel(
            rnn=LatentGRU(in_dim=37, hidden=40, latent_dim=50),
            enc=MLP(features=(50, 2 * 20)), node=node, dec=Dense(37))
        if name == "global":
            p0 = model.init(jax.random.PRNGKey(3), x)
        p = p0

        def loss(params, model=model):
            out = model(params, x, key, saveat=saveat)
            err = (out.result - d0) * m0
            ll = jnp.sum(-jnp.square(err) / (2 * 0.01**2), axis=(1, 2))
            ll = ll / jnp.maximum(jnp.sum(m0, axis=(1, 2)), 1.0)
            kl = jnp.mean(jnp.exp(out.logvar) + jnp.square(out.mu0) - 1
                          - out.logvar, axis=-1) / 2
            r = reg.error_estimate(out.telemetry, agg="mean")
            return -jnp.mean(ll - kl) + 1e3 * r, out.nfe

        fn = jax.jit(lambda pp, loss=loss: jax.value_and_grad(
            loss, has_aux=True)(pp))
        (l, nfe), _ = fn(p)
        sync(l)
        fns[name] = (fn, p)
        nfe = np.asarray(nfe)
        nfes[name] = ([int(nfe.mean()), int(np.median(nfe)), int(nfe.max())]
                      if nfe.ndim else int(nfe))
        print("compiled", name, "nfe:", nfes[name], flush=True)

    times = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k, (fn, p) in fns.items():
            sync(fn(p)[0][0])
            t0 = time.perf_counter()
            for _ in range(INNER):
                out = fn(p)
            sync(out[0][0])
            times[k].append((time.perf_counter() - t0) / INNER * 1e3)

    med = {k: round(float(np.median(v)), 3) for k, v in times.items()}
    print(json.dumps({
        "backend": jax.devices()[0].platform, "batch": B,
        **{k + "_ms": v for k, v in med.items()},
        **{k + "_samples_per_sec": round(B / (v / 1e3), 1)
           for k, v in med.items()},
        "ps_batched_vs_global": round(med["ps_batched"] / med["global"], 2),
        "ps_vmap_vs_global": round(med["ps_vmap"] / med["global"], 2),
        "nfe": nfes,
    }))


if __name__ == "__main__":
    main()

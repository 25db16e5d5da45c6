"""Cost of per-sample adaptive stepping on the flagship.

Per-sample mode (torchode-style: every batch element gets its own PI
controller, honest per-sample NFE) is a batch-semantics capability the
reference lacks (it solves the whole batch as ONE ODE state with one
global error norm, src/models/neural_ode.jl:62). This times what it costs
at the flagship shape.

One process, round-robin medians. Each timed call is a full
value_and_grad of the flagship loss (CE + error_est reg) at batch 512,
rtol=atol=1.4e-8:

  global                   the default: one controller, adjoint engine
  per_sample               per-sample controllers (vmap'd adjoint)
  per_sample_batched       per-lane-controller dense engine
  per_sample_batched_scan  the same engine's bounded-scan gradient

``REGNDE_PS_LEGS=global,per_sample_batched`` selects legs.

    python tools/bench_per_sample.py

Also reports the per-sample NFE distribution (mean/p50/max) vs the
global solve's single NFE — the honest-cost argument for the mode.
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
import optax  # noqa: E402

from regneuralde_tpu import reg  # noqa: E402
from regneuralde_tpu.models import ClassifierNODE, Dense, MLPDynamics, NeuralODE  # noqa: E402

B, D, H = 512, 784, 100
RT = 1.4e-8
ROUNDS = 7
INNER = 5


def main():
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (B, D)) * 0.3
    y = jax.nn.one_hot(jax.random.randint(key, (B,), 0, 10), 10)

    sync = lambda r: float(np.asarray(jax.tree_util.tree_leaves(r)[0]
                                      ).ravel()[0])

    variants = {
        "global": dict(per_sample=False),
        "per_sample": dict(per_sample=True),
        # per-lane-controller dense engine (ops.per_sample_batched).
        # Default mode="adjoint": early-exit while forward + custom_vjp
        # backward over only the executed iterations; the _scan leg pays
        # all max_steps iterations.
        "per_sample_batched": dict(per_sample="batched"),
        "per_sample_batched_scan": dict(per_sample="batched", mode="scan"),
    }
    import os
    legs = os.environ.get("REGNDE_PS_LEGS")
    if legs:
        keep = set(legs.split(","))
        variants = {n: kw for n, kw in variants.items() if n in keep}
    fns, nfes = {}, {}
    for name, kw in variants.items():
        kw = dict(kw)
        loss_mode = kw.pop("mode", "adjoint")
        node = NeuralODE(MLPDynamics(dim=D, hidden=H), tspan=(0.0, 1.0),
                         time_dep=True, rtol=RT, atol=RT, max_steps=96, **kw)
        clf = ClassifierNODE(None, node, Dense(10))
        p = clf.init(jax.random.PRNGKey(1), x)

        def loss(p, clf=clf, loss_mode=loss_mode):
            out = clf(p, x, mode=loss_mode)
            ce = optax.softmax_cross_entropy(out.logits, y).mean()
            return ce + 1e2 * reg.error_estimate(out.telemetry, agg="mean")

        fn = jax.jit(jax.value_and_grad(loss))
        sync(fn(p))
        fns[name] = (fn, p)
        nfe = jax.jit(lambda p, clf=clf: clf(p, x, mode="while").nfe)(p)
        nfes[name] = np.asarray(nfe)
        print(f"compiled {name}", flush=True)

    times = {n: [] for n in fns}
    for _ in range(ROUNDS):
        for n, (fn, p) in fns.items():
            sync(fn(p))
            t0 = time.perf_counter()
            for _ in range(INNER):
                out = fn(p)
            sync(out)
            times[n].append((time.perf_counter() - t0) / INNER * 1e3)

    out = {"device": jax.devices()[0].device_kind, "batch": B, "rtol": RT}
    for n in fns:
        med = float(np.median(times[n]))
        out[n + "_ms"] = round(med, 3)
        out[n + "_samples_per_sec"] = round(B / med * 1e3, 1)
        out[n + "_spread"] = round(
            float(np.max(times[n]) - np.min(times[n])), 3)

    def dist(name):
        v = nfes[name].astype(np.float64)
        return {"mean": round(float(v.mean()), 1), "p50": int(np.median(v)),
                "min": int(v.min()), "max": int(v.max())}

    if "global" in fns:
        out["nfe_global"] = int(nfes["global"].max())
    if "per_sample" in fns:
        out["nfe_per_sample"] = dist("per_sample")
        if "global" in fns:
            out["per_sample_vs_global"] = round(
                out["per_sample_ms"] / out["global_ms"], 2)
    if "per_sample_batched" in fns:
        out["nfe_per_sample_batched"] = dist("per_sample_batched")
        if "global" in fns:
            out["per_sample_batched_vs_global"] = round(
                out["per_sample_batched_ms"] / out["global_ms"], 2)
        if "per_sample" in fns:
            out["batched_vs_vmap_speedup"] = round(
                out["per_sample_ms"] / out["per_sample_batched_ms"], 2)
        if "per_sample_batched_scan" in fns:
            out["adjoint_vs_scan_speedup"] = round(
                out["per_sample_batched_scan_ms"]
                / out["per_sample_batched_ms"], 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Cost of per-sample adaptive SDE stepping on the mnist_nsde fan-out.

The reference's ClassifierNSDE repeats each input ``trajectories x`` and
solves the whole fan-out as ONE SDE state under ONE controller
(src/models/supervised_classification.jl:92, src/models/neural_sde.jl:44-114)
— exactly the workload where per-trajectory control pays: one unlucky
trajectory otherwise throttles every other. This measures the per-lane
batched SDE engine on the mnist_nsde shapes.

One process, round-robin medians, scalar-synced. Each timed call is a full value_and_grad of CE + error_est
reg through the MC fan-out (batch 128 x 4 trajectories = 512 lanes,
32-dim latent, SOSRI, rtol=atol=1.4e-1 — experiments/mnist_nsde.jl:70-84):

  global        one controller for the whole fan-out (the reference's
                semantics), adjoint engine
  ps_vmap       per-sample controllers + per-lane Brownian paths, vmap
                engine (the known-bad cost class)
  ps_batched    the per-lane-controller dense engine (mode="adjoint")

Also reports per-lane NFE stats vs the global solve's single NFE.

    python tools/bench_per_sample_sde.py
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
from regneuralde_tpu.models import ClassifierNSDE, Dense, MLP, NeuralSDE  # noqa: E402

B, TRAJ, LATENT = 128, 4, 32
RT = 1.4e-1
MAX_STEPS = 64
ROUNDS = 7
INNER = 5


def main():
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (B, 784)) * 0.3
    y = jax.nn.one_hot(jax.random.randint(key, (B,), 0, 10), 10)
    bkey = jax.random.PRNGKey(5)

    sync = lambda r: float(np.asarray(jax.tree_util.tree_leaves(r)[0]
                                      ).ravel()[0])

    variants = {
        "global": dict(per_sample=False),
        "ps_vmap": dict(per_sample=True),
        "ps_batched": dict(per_sample="batched"),
    }

    fns = {}
    nfes = {}
    for name, kw in variants.items():
        nsde = NeuralSDE(
            MLP(features=(64, LATENT)), MLP(features=(LATENT,)),
            solver="sosri", rtol=RT, atol=RT, max_steps=MAX_STEPS, **kw)
        clf = ClassifierNSDE(Dense(LATENT), nsde, Dense(10))
        p = clf.init(jax.random.PRNGKey(1), x)

        def loss(p, clf=clf):
            out = clf(p, x, bkey, trajectories=TRAJ)
            ce = optax.softmax_cross_entropy(out.logits, y).mean()
            return ce + 10.0 * reg.error_estimate(out.telemetry,
                                                  agg="mean")

        fn = jax.jit(lambda pp, loss=loss: jax.value_and_grad(loss)(pp))
        sync(fn(p))
        fns[name] = (fn, p)

        nfe1 = jax.jit(lambda pp, clf=clf: clf(
            pp, x, bkey, trajectories=TRAJ).nfe1)(p)
        nfe1 = np.asarray(nfe1)
        nfes[name] = (
            [int(nfe1.mean()), int(np.median(nfe1)), int(nfe1.max())]
            if nfe1.ndim else int(nfe1))
        print("compiled", name, "nfe1:", nfes[name], flush=True)

    times = {k: [] for k in fns}
    for _ in range(ROUNDS):
        for k, (fn, p) in fns.items():
            sync(fn(p))
            t0 = time.perf_counter()
            for _ in range(INNER):
                out = fn(p)
            sync(out)
            times[k].append((time.perf_counter() - t0) / INNER * 1e3)

    med = {k: round(float(np.median(v)), 3) for k, v in times.items()}
    lanes = B * TRAJ
    print(json.dumps({
        "backend": jax.devices()[0].platform,
        "lanes": lanes,
        **{k + "_ms": v for k, v in med.items()},
        **{k + "_samples_per_sec": round(B / (v / 1e3), 1)
           for k, v in med.items()},
        "ps_batched_vs_global": round(med["ps_batched"] / med["global"], 2),
        "ps_vmap_vs_global": round(med["ps_vmap"] / med["global"], 2),
        "nfe1": nfes,
    }))


if __name__ == "__main__":
    main()

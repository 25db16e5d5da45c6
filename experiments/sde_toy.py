"""Toy 2-D SDE fit: match trajectory means/variances of a ground-truth SDE.

JAX rebuild of the reference experiment (reference:
experiments/sde_toy_problem.jl): drift Chain(x -> x^3, 2->50 tanh->2),
diagonal diffusion Dense(2,2) (:45-46), adaptive SRI solve at
rtol=atol=3e-1 with 30 saveat points on [0,1] (:50-59), AdaBelief(0.01)
for 250 iterations over 100 Monte-Carlo trajectories (:61-76); loss is the
L2 distance of per-timestep means and variances to the data (:28-33), plus
0.2 * sum(EEst*dt) when regularizing (:26-39). Also times prediction like
the reference's @belapsed benchmark (:82). The ground truth is the
reference's actual data/sde_demo.bson (decoded by the BSON.jl codec) when
findable — incl. the mounted reference checkout — with a regenerated
synthetic SDE as fallback; results.yml records which (``data_source``).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
from common import (HealthMonitor, Timer, block, finish, guarded_train_step, provenance,
                    parse_args, setup)
from regneuralde_tpu import reg
from regneuralde_tpu.data import make_sde_demo
from regneuralde_tpu.models import Dense, Module, NeuralSDE
from regneuralde_tpu.training import create_train_state, sde_toy_optimizer


class CubicDrift(Module):
    """Chain(x -> x.^3, Dense(2,50,tanh), Dense(50,2))."""

    def _init(self, key, x):
        k1, k2 = jax.random.split(key)
        p = {"Dense_0": Dense(50)._init(k1, x**3)[0]}
        p["Dense_1"] = Dense(2)._init(k2, jnp.tanh(Dense(50)._apply(
            p["Dense_0"], x**3)))[0]
        return p, self._apply(p, x)

    def _apply(self, p, x):
        h = jnp.tanh(Dense(50)._apply(p["Dense_0"], x**3))
        return Dense(2)._apply(p["Dense_1"], h)


def main():
    args = parse_args("experiments/configs/sde_toy.yml")
    cfg, h, run_dir = setup(args, "sde_toy")
    seed = cfg.get("seed", 5)
    iters = args.epochs or h.get("iters", 250)
    trajectories = args.batch_size or h.get("batch_size", 100)
    regularize = bool(h.get("regularize", False))
    c = float(h.get("reg_coeff", 0.2))
    max_steps = args.max_steps or h.get("max_steps", 128)

    sde_means, sde_vars, tsteps, data_source = make_sde_demo(seed=0)
    print(f"[sde_toy] ground truth: {data_source}")
    sde_means = jnp.asarray(sde_means)  # (30, 2)
    sde_vars = jnp.asarray(sde_vars)
    saveat = jnp.asarray(tsteps)

    nsde = NeuralSDE(
        CubicDrift(),
        Dense(2),
        tspan=(0.0, 1.0 + np.finfo(np.float32).eps),
        solver="sosri",
        rtol=3e-1,
        atol=3e-1,
        max_steps=max_steps,
        saveat=saveat,
    )
    u0 = jnp.tile(jnp.asarray([[2.0, 0.0]], jnp.float32), (trajectories, 1))
    params = nsde.init(jax.random.PRNGKey(seed), u0)
    optimizer = sde_toy_optimizer()

    def loss_fn(params, key):
        out = nsde(params, u0, key)  # value: (traj, 30, 2)
        means = jnp.mean(out.value, axis=0)
        vars_ = jnp.var(out.value, axis=0)
        l2_means = jnp.mean(jnp.square(sde_means - means))
        l2_vars = jnp.mean(jnp.square(sde_vars - vars_))
        r = c * reg.error_estimate(out.telemetry, agg="sum") if regularize else 0.0
        return l2_means + l2_vars + r, {
            "l2_means": l2_means, "l2_vars": l2_vars, "reg": r,
            "nfe1": out.nfe1, "nfe2": out.nfe2,
            "success": jnp.asarray(out.solution.stats.success, jnp.float32),
        }

    train_step = guarded_train_step(loss_fn, optimizer)

    @jax.jit
    def predict(params, key):
        out = nsde(params, u0, key, mode="while")
        return out.value, out.nfe1, out.nfe2

    state = create_train_state(params, optimizer)
    health = HealthMonitor("sde_toy")
    key = jax.random.PRNGKey(seed + 1)
    losses = []
    total_time = 0.0
    for it in range(1, iters + 1):
        key, sk = jax.random.split(key)
        t0 = time.time()
        state, loss, aux = train_step(state, sk)
        block(loss)
        total_time += time.time() - t0
        health.update(aux)
        losses.append(float(loss))
        if it % 50 == 0 or it == 1:
            print(f"iter {it:4d} loss={float(loss):.5f} "
                  f"means={float(aux['l2_means']):.5f} "
                  f"vars={float(aux['l2_vars']):.5f} reg={float(aux['reg']):.4f} "
                  f"nfe1={int(aux['nfe1'])} nfe2={int(aux['nfe2'])}")

    # Prediction timing (reference: @belapsed, :82).
    _, n1, n2 = block(predict(state.params, key))
    ptimes = []
    for _ in range(5):
        key, sk = jax.random.split(key)
        with Timer() as t:
            block(predict(state.params, sk))
        ptimes.append(t.elapsed)
    ptime = min(ptimes)
    print(f"final loss={losses[-1]:.5f} nfe1={int(n1)} nfe2={int(n2)} "
          f"predict_time={ptime*1000:.2f}ms train_time={total_time:.1f}s")

    finish(run_dir, {
        "losses": losses,
        "final_loss": losses[-1],
        "nfe1": int(n1),
        "nfe2": int(n2),
        "prediction_time": ptime,
        "train_time": total_time,
        **provenance(None, data_source=data_source, solver="sosri",
                     mode="adjoint", rtol=3e-1, atol=3e-1,
                     regularize=regularize),
        **health.results(),
    }, params=state.params)


if __name__ == "__main__":
    main()

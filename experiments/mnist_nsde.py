"""MNIST classification with a regularized Neural SDE.

JAX rebuild of the reference experiment (reference:
experiments/mnist_nsde.jl): Dense(784->32) encoder, drift 32->64(tanh)->32,
diagonal diffusion Dense(32->32), Dense(32->10) head. Adaptive SRI solve at
rtol=atol=1.4e-1, trained with 1 Monte-Carlo trajectory and evaluated with
10 (mnist_nsde.jl:100,154-155). Regularizers: error_est (lambda 10, mean)
or stiff_est (lambda 0.1, mean) (:45-65). Unlike the reference — whose SDE
path only runs on CPU (:11-13) — this runs on the accelerator like everything else.
"""

import functools
import time

import jax
import jax.numpy as jnp
import optax

from common import (HealthMonitor, Timer, block, finish, guarded_train_step, provenance,
                    parse_args, setup)
from regneuralde_tpu import reg
from regneuralde_tpu.data import load_mnist
from regneuralde_tpu.models import MLP, ClassifierNSDE, Dense, NeuralSDE
from regneuralde_tpu.training import (
    Checkpointer,
    create_train_state,
    mnist_nsde_optimizer,
)
from regneuralde_tpu.utils import accuracy, table_logger

def main():
    args = parse_args("experiments/configs/mnist_nsde.yml")
    cfg, h, run_dir = setup(args, "mnist_nsde")
    seed = cfg.get("seed", 1999)
    epochs = h["epochs"]
    regularize = bool(h.get("regularize", False))
    reg_type = h.get("type", "error_est")
    max_steps = args.max_steps or h.get("max_steps", 128)

    train_loader, test_loader = load_mnist(h["batch_size"], flatten=True,
                                           seed=seed)
    print(f"data source: {train_loader.source}")

    # Solver parity with the reference: SOSRI for error_est, the
    # damping-optimized SOSRI2 tableau when harvesting the stiffness
    # estimate (mnist_nsde.jl:45-65 uses AutoSOSRI2(SOSRI2()) there).
    solver = "sosri2" if reg_type == "stiff_est" else "sosri"
    # --per-sample-engine batched (default): the per-lane-controller
    # dense engine; "vmap" forces the fully general engine.
    # (True selects the fully general vmap engine.)
    per_sample = ((True if args.per_sample_engine == "vmap" else "batched")
                  if args.per_sample else False)
    nsde = NeuralSDE(
        MLP(features=(64, 32)),
        MLP(features=(32,)),
        tspan=(0.0, 1.0),
        solver=solver,
        rtol=1.4e-1,
        atol=1.4e-1,
        max_steps=max_steps,
        # --per-sample: each Monte-Carlo trajectory in the classifier's
        # fan-out gets its own controller and Brownian bridge — one
        # unlucky trajectory no longer forces small steps on all of them.
        per_sample=per_sample,
    )
    clf = ClassifierNSDE(Dense(32), nsde, Dense(10))
    x0, _ = train_loader.first_batch()
    params = clf.init(jax.random.PRNGKey(seed), jnp.asarray(x0))

    if reg_type == "stiff_est":
        # The real alg_stability_size of the tableau in use (the reference
        # hardcodes alg_stability_size(SOSRI2()); ours is computed from
        # the tableau's deterministic stability polynomial).
        from regneuralde_tpu.ops import sri as sri_mod

        stability = sri_mod.stability_size(sri_mod.get_tableau(solver))
        reg_fn = functools.partial(
            reg.stiffness_estimate, stability_size=stability, agg="mean"
        )
        lam_sched = lambda e: jnp.asarray(0.1, jnp.float32)
    else:
        reg_fn = functools.partial(reg.error_estimate, agg="mean")
        lam_sched = lambda e: jnp.asarray(10.0, jnp.float32)

    optimizer = mnist_nsde_optimizer()

    def loss_fn(params, x, y, key, lam):
        out = clf(params, x, key, trajectories=1)
        ce = optax.softmax_cross_entropy(out.logits, y).mean()
        r = reg_fn(out.telemetry) if regularize else 0.0
        # max/mean reduce (trajectories*batch,) vectors under
        # --per-sample and are identity on the default scalars.
        return ce + lam * r, {"ce": ce, "reg": r,
                              "nfe1": jnp.max(out.nfe1),
                              "nfe2": jnp.max(out.nfe2),
                              "success": jnp.mean(
                                  jnp.asarray(out.success, jnp.float32))}

    train_step = guarded_train_step(loss_fn, optimizer)

    @functools.partial(jax.jit, static_argnums=(3,))
    def infer(params, x, key, trajectories=10):
        out = clf(params, x, key, trajectories=trajectories, mode="while")
        # max == the solve's wall-clock cost; the mean (recorded under
        # --per-sample) is the honest average per-trajectory cost.
        return (out.logits, jnp.max(out.nfe1), jnp.max(out.nfe2),
                jnp.mean(out.nfe1.astype(jnp.float32)))

    eval_key = jax.random.PRNGKey(seed + 7)

    def sweep_accuracy(params, loader):
        return accuracy(lambda p, x: infer(p, x, eval_key, 10)[0:1], params,
                        loader, batches=args.limit_batches)

    logger = table_logger(
        ["Epoch", "NFE1", "NFE2", "Train Acc", "Test Acc", "Train Time",
         "Infer Time"],
        ["Total Loss", "Cross Entropy", "Regularization"],
    )
    ckpt = Checkpointer(run_dir / "ckpt", save_every=5)
    state = create_train_state(params, optimizer)
    health = HealthMonitor("mnist_nsde")

    nfe1s, nfe2s, train_accs, test_accs = [], [], [], []
    train_times, infer_times, nfe1_means = [], [], []

    dummy = jnp.asarray(train_loader.first_batch()[0])
    with Timer() as t:
        _, n1, n2, n1_mean = block(infer(state.params, dummy, eval_key, 10))
    nfe1s.append(int(n1)); nfe2s.append(int(n2)); infer_times.append(t.elapsed)
    nfe1_means.append(float(n1_mean))
    train_times.append(0.0)
    train_accs.append(sweep_accuracy(state.params, train_loader))
    test_accs.append(sweep_accuracy(state.params, test_loader))
    logger(False, {}, 0, n1, n2, train_accs[0], test_accs[0], 0.0,
           infer_times[0])

    key = jax.random.PRNGKey(seed + 13)
    for epoch in range(1, epochs + 1):
        lam = lam_sched(epoch - 1)
        timing = 0.0
        for i, (x, y) in enumerate(train_loader):
            if args.limit_batches is not None and i >= args.limit_batches:
                break
            key, sk = jax.random.split(key)
            t0 = time.time()
            state, loss, aux = train_step(state, jnp.asarray(x),
                                          jnp.asarray(y), sk, lam)
            block(loss)
            timing += time.time() - t0
            health.update(aux)
            logger(False, {"Total Loss": float(loss),
                           "Cross Entropy": float(aux["ce"]),
                           "Regularization": float(aux["reg"])})

        with Timer() as t:
            _, n1, n2, n1_mean = block(infer(state.params, dummy,
                                             eval_key, 10))
        nfe1s.append(int(n1)); nfe2s.append(int(n2))
        nfe1_means.append(float(n1_mean))
        if per_sample:
            print(f"  per-trajectory NFE1: mean {n1_mean:.1f}, "
                  f"max {int(n1)}")
        infer_times.append(t.elapsed); train_times.append(timing)
        train_accs.append(sweep_accuracy(state.params, train_loader))
        test_accs.append(sweep_accuracy(state.params, test_loader))
        logger(False, {}, epoch, n1, n2, train_accs[-1], test_accs[-1],
               timing, infer_times[-1])
        ckpt.maybe_save(epoch, state.params, state.opt_state)

    logger(True, {})
    extra_results = (
        {"nfe1_means_per_sample": nfe1_means, "per_sample": True}
        if per_sample else {}
    )
    finish(run_dir, {
        "nfe1_counts": nfe1s,
        "nfe2_counts": nfe2s,
        **extra_results,
        "train_accuracies": train_accs,
        "test_accuracies": test_accs,
        "train_runtimes": train_times,
        "inference_runtimes": infer_times,
        **provenance(train_loader, solver=solver, mode="adjoint",
                     rtol=1.4e-1, atol=1.4e-1,
                     regularize=bool(h.get("regularize", False)),
                     reg_type=reg_type),
        **health.results(),
    }, params=state.params)
    ckpt.close()


if __name__ == "__main__":
    main()

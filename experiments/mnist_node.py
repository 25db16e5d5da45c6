"""MNIST classification with a regularized Neural ODE (flagship experiment).

JAX rebuild of the reference experiment (reference:
experiments/mnist_node.jl): time-dependent MLP dynamics (784 ->(+t) 100
->(+t) 784, tanh) under an adaptive Tsit5 solve at rtol=atol=1.4e-8,
classified by a linear head, trained with logit cross-entropy plus an
annealed solver-heuristic regularizer:

  * error_est:       lambda 1e2 -> 1e1 (exp), mean(EEst * dt)     (:62-69)
  * stiff_est:       lambda 0.1, max(|eigen_est|)/stability_size  (:70-81)
  * error_stiff_est: lambda 1e1, combined, mean                   (:82-99)
  * STEER baseline:  t1 ~ U(1-b, 1+b), b = 0.5                    (:104-105)

Whereas the reference re-traces the Julia integrator per call and fights
tape growth with per-batch GC (:237), here the entire epoch step — adaptive
solve, loss, discrete adjoint, optimizer — is ONE jitted XLA program, and
`--data-parallel N` shards the batch over a mesh with globally synchronized
step control.

Usage:
  python experiments/mnist_node.py --config experiments/configs/mnist_node.yml
  python experiments/mnist_node.py --epochs 1 --limit-batches 3  # smoke
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
from regneuralde_tpu.models import ClassifierNODE, Dense, MLPDynamics, NeuralODE
from regneuralde_tpu.ops.tableaus import TSIT5
from regneuralde_tpu.training import (
    Checkpointer,
    TrainState,
    create_train_state,
    mnist_node_optimizer,
)
from regneuralde_tpu.utils import accuracy, table_logger


def build_reg(reg_type: str, epochs: int):
    """Regularizer + lambda schedule per reference mode (mnist_node.jl:62-108)."""
    if reg_type == "error_est":
        sched = reg.exp_decay_schedule(1e2, 1e1, epochs)
        fn = functools.partial(reg.error_estimate, agg="mean")
    elif reg_type == "stiff_est":
        sched = lambda e: jnp.asarray(0.1, jnp.float32)
        fn = functools.partial(
            reg.stiffness_estimate, stability_size=TSIT5.stability_size, agg="max"
        )
    elif reg_type == "error_stiff_est":
        sched = lambda e: jnp.asarray(10.0, jnp.float32)
        fn = functools.partial(
            reg.error_stiffness, stability_size=TSIT5.stability_size, agg="mean"
        )
    else:
        raise ValueError(reg_type)
    return fn, sched


def main():
    args = parse_args("experiments/configs/mnist_node.yml")
    cfg, h, run_dir = setup(args, "mnist_node")
    seed = cfg.get("seed", 1999)
    epochs = h["epochs"]
    regularize = bool(h.get("regularize", False))
    reg_type = h.get("type", "error_est")
    steer = bool(h.get("steer", False))
    max_steps = args.max_steps or h.get("max_steps", 128)

    train_loader, test_loader = load_mnist(h["batch_size"], flatten=True,
                                           seed=seed)
    print(f"data source: {train_loader.source}")

    axis_name = "data" if args.data_parallel else None
    # --per-sample-engine batched (default): the per-lane-controller
    # dense engine; "vmap" forces the fully general engine.
    # (True selects the fully general vmap engine.)
    per_sample = ((True if args.per_sample_engine == "vmap" else "batched")
                  if args.per_sample else False)
    node = NeuralODE(
        MLPDynamics(dim=784, hidden=100),
        tspan=(0.0, 1.0),
        time_dep=True,
        solver="tsit5",
        rtol=args.rtol if args.rtol is not None else 1.4e-8,
        atol=args.atol if args.atol is not None else 1.4e-8,
        max_steps=max_steps,
        axis_name=axis_name,
        per_sample=per_sample,
    )
    clf = ClassifierNODE(None, node, Dense(10))
    key = jax.random.PRNGKey(seed)
    x0, _ = train_loader.first_batch()
    params = clf.init(key, jnp.asarray(x0))

    reg_fn, lam_sched = build_reg(reg_type if regularize else "error_est", epochs)
    optimizer = mnist_node_optimizer()

    def loss_fn(params, x, y, lam, t1):
        out = clf(params, x, tspan=(0.0, t1))
        ce = optax.softmax_cross_entropy(out.logits, y).mean()
        r = reg_fn(out.telemetry) if regularize else 0.0
        # Per-sample mode yields (batch,) nfe/success vectors; the max NFE
        # is the solve's wall-clock cost (slowest lane), and mean success
        # is the fraction of samples integrated to t1. Scalars unchanged.
        return ce + lam * r, {"ce": ce, "reg": r, "nfe": jnp.max(out.nfe),
                              "success": jnp.mean(
                                  jnp.asarray(out.success, jnp.float32))}

    if args.data_parallel:
        from regneuralde_tpu import parallel as par

        mesh = par.make_mesh(args.data_parallel)
        train_step = par.make_dp_train_step(loss_fn, optimizer, mesh,
                                            nan_guard=True)
        state = TrainState(par.replicate(mesh, params),
                           par.replicate(mesh, optimizer.init(params)), 0)
        prep = lambda *b: tuple(par.shard_batch(mesh, x) for x in b)
    else:
        train_step = guarded_train_step(loss_fn, optimizer)
        state = create_train_state(params, optimizer)
        prep = lambda *b: b

    @jax.jit
    def infer(params, x):
        out = clf(params, x, mode="while")
        # max == mean == nfe for the default global-control solve; they
        # differ only under --per-sample (max = wall-clock cost of the
        # solve, mean = the honest average per-sample cost).
        return (out.logits, jnp.max(out.nfe),
                jnp.mean(out.nfe.astype(jnp.float32)))

    def sweep_accuracy(params, loader):
        return accuracy(lambda p, x: infer(p, x), params, loader,
                        batches=args.limit_batches)

    logger = table_logger(
        ["Epoch", "NFE", "Train Acc", "Test Acc", "Train Time", "Infer Time"],
        ["Total Loss", "Cross Entropy", "Regularization"],
    )
    ckpt = Checkpointer(run_dir / "ckpt", save_every=5)
    health = HealthMonitor("mnist_node")

    start_epoch = 1
    if args.resume_from:
        from pathlib import Path

        prev = Checkpointer(Path(args.resume_from) / "ckpt")
        # Restore against a template so optax NamedTuple states keep their
        # structure (orbax returns raw dicts otherwise).
        template = {"params": params, "opt_state": optimizer.init(params),
                    "extra": {"epoch": 0}}
        step_num, payload = prev.restore_latest(template)
        if step_num is None:
            raise SystemExit(f"no checkpoint found under {args.resume_from}")
        if args.data_parallel:
            from regneuralde_tpu import parallel as par

            state = TrainState(par.replicate(mesh, payload["params"]),
                               par.replicate(mesh, payload["opt_state"]), 0)
        else:
            state = TrainState(payload["params"], payload["opt_state"], 0)
        start_epoch = int(payload.get("extra", {}).get("epoch", step_num)) + 1
        prev.close()
        print(f"resumed from {args.resume_from} at epoch {start_epoch - 1}")

    nfe_counts, train_accs, test_accs = [], [], []
    train_times, infer_times = [], []

    nfe_means = []
    dummy = jnp.asarray(train_loader.first_batch()[0])
    with Timer() as t:
        _, nfe0, nfe0_mean = block(infer(state.params, dummy))
    nfe_counts.append(int(nfe0)); infer_times.append(t.elapsed)
    nfe_means.append(float(nfe0_mean))
    train_times.append(0.0)
    train_accs.append(sweep_accuracy(state.params, train_loader))
    test_accs.append(sweep_accuracy(state.params, test_loader))
    logger(False, {}, 0, nfe_counts[0], train_accs[0], test_accs[0], 0.0,
           infer_times[0])

    steer_key = jax.random.PRNGKey(seed + 1)
    for epoch in range(start_epoch, epochs + 1):
        lam = lam_sched(epoch - 1)
        timing = 0.0
        for i, (x, y) in enumerate(train_loader):
            if args.limit_batches is not None and i >= args.limit_batches:
                break
            if steer:
                steer_key, sk = jax.random.split(steer_key)
                if per_sample and not args.data_parallel:
                    # Per-sample STEER: an independent end-time draw per
                    # sample (the per-sample solver takes a (batch,) t1).
                    _, t1 = reg.steer_tspan_per_sample(
                        sk, int(jnp.asarray(x).shape[0]), b=0.5)
                else:
                    _, t1 = reg.steer_tspan(sk, b=0.5)
            else:
                t1 = jnp.asarray(1.0, jnp.float32)
            xb, yb = prep(jnp.asarray(x), jnp.asarray(y))
            t0 = time.time()
            state, loss, aux = train_step(state, xb, yb, lam, t1)
            block(loss)
            timing += time.time() - t0
            health.update(aux)
            logger(False, {"Total Loss": float(loss),
                           "Cross Entropy": float(aux["ce"]),
                           "Regularization": float(aux["reg"])})

        with Timer() as t:
            _, nfe, nfe_mean = block(infer(state.params, dummy))
        nfe_counts.append(int(nfe)); infer_times.append(t.elapsed)
        nfe_means.append(float(nfe_mean))
        if per_sample:
            print(f"  per-sample NFE: mean {nfe_mean:.1f}, max {int(nfe)}")
        train_times.append(timing)
        train_accs.append(sweep_accuracy(state.params, train_loader))
        test_accs.append(sweep_accuracy(state.params, test_loader))
        logger(False, {}, epoch, nfe_counts[-1], train_accs[-1], test_accs[-1],
               timing, infer_times[-1])
        ckpt.maybe_save(epoch, state.params, state.opt_state,
                        extra={"epoch": epoch})

    logger(True, {})
    extra_results = (
        {"nfe_means_per_sample": nfe_means, "per_sample": True}
        if per_sample else {}
    )
    finish(run_dir, {
        "nfe_counts": nfe_counts,
        **extra_results,
        "train_accuracies": train_accs,
        "test_accuracies": test_accs,
        "train_runtimes": train_times,
        "inference_runtimes": infer_times,
        **provenance(train_loader, solver="tsit5", mode="adjoint",
                     rtol=node.rtol, atol=node.atol,
                     regularize=bool(h.get("regularize", False)),
                     reg_type=h.get("type")),
        **health.results(),
    }, params=state.params)
    ckpt.close()


if __name__ == "__main__":
    main()

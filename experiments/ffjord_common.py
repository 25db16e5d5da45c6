"""Shared FFJORD experiment loop (gaussian + tabular share everything but
data, sizes, and hyperparameters — as in the reference scripts)."""

import time

import jax
import jax.numpy as jnp

from common import (HealthMonitor, Timer, block, finish, guarded_train_step,
                    provenance)
from regneuralde_tpu import reg
from regneuralde_tpu.models import CSLDynamics, FFJORD
from regneuralde_tpu.training import (
    Checkpointer,
    create_train_state,
    ffjord_optimizer,
)
from regneuralde_tpu.utils import loglikelihood, table_logger


def run_ffjord_experiment(args, h, run_dir, seed, train_loader, test_loader,
                          input_dim, hidden, lam0, lam1, lr):
    epochs = h["epochs"]
    regularize = bool(h.get("regularize", False))
    max_steps = args.max_steps or h.get("max_steps", 128)
    print(f"data source: {train_loader.source}")

    ff = FFJORD(
        CSLDynamics(dim=input_dim, hidden=hidden),
        input_dim=input_dim,
        solver="tsit5",
        rtol=1.4e-8,
        atol=1.4e-8,
        max_steps=max_steps,
        analytic_vjp=True,
    )
    x0 = jnp.asarray(train_loader.first_batch())
    params = ff.init(jax.random.PRNGKey(seed), x0)

    lam_sched = reg.exp_decay_schedule(lam0, lam1, epochs)
    optimizer = ffjord_optimizer(lr)

    def loss_fn(params, x, key, lam):
        out = ff(params, x, key)
        nll = -jnp.mean(out.logpx)
        r = reg.error_estimate(out.telemetry, agg="mean") if regularize else 0.0
        return nll + lam * r, {
            "nll": nll, "reg": r, "nfe": out.nfe,
            "success": jnp.asarray(out.solution.stats.success, jnp.float32)}

    train_step = guarded_train_step(loss_fn, optimizer)

    @jax.jit
    def infer(params, x, key):
        out = ff(params, x, key, mode="while")
        return out.logpx, out.nfe

    eval_key = jax.random.PRNGKey(seed + 5)

    def sweep_ll(params, loader):
        return loglikelihood(lambda p, x: infer(p, x, eval_key)[0:1], params,
                             loader, batches=args.limit_batches)

    logger = table_logger(
        ["Epoch", "NFE", "Train LL", "Test LL", "Train Time", "Infer Time"],
        ["Total Loss", "Neg Log Likelihood", "Regularization"],
    )
    ckpt = Checkpointer(run_dir / "ckpt", save_every=10)
    state = create_train_state(params, optimizer)
    health = HealthMonitor("ffjord")

    nfe_counts, train_lls, test_lls = [], [], []
    train_times, infer_times = [], []

    dummy = jnp.asarray(train_loader.first_batch())
    with Timer() as t:
        _, nfe0 = block(infer(state.params, dummy, eval_key))
    nfe_counts.append(int(nfe0)); infer_times.append(t.elapsed)
    train_times.append(0.0)
    train_lls.append(sweep_ll(state.params, train_loader))
    test_lls.append(sweep_ll(state.params, test_loader))
    logger(False, {}, 0, nfe_counts[0], train_lls[0], test_lls[0], 0.0,
           infer_times[0])

    key = jax.random.PRNGKey(seed + 11)
    for epoch in range(1, epochs + 1):
        lam = lam_sched(epoch - 1)
        timing = 0.0
        for i, x in enumerate(train_loader):
            if args.limit_batches is not None and i >= args.limit_batches:
                break
            key, sk = jax.random.split(key)
            t0 = time.time()
            state, loss, aux = train_step(state, jnp.asarray(x), sk, lam)
            block(loss)
            timing += time.time() - t0
            health.update(aux)
            logger(False, {"Total Loss": float(loss),
                           "Neg Log Likelihood": float(aux["nll"]),
                           "Regularization": float(aux["reg"])})

        with Timer() as t:
            _, nfe = block(infer(state.params, dummy, eval_key))
        nfe_counts.append(int(nfe)); infer_times.append(t.elapsed)
        train_times.append(timing)
        train_lls.append(sweep_ll(state.params, train_loader))
        test_lls.append(sweep_ll(state.params, test_loader))
        logger(False, {}, epoch, nfe_counts[-1], train_lls[-1], test_lls[-1],
               timing, infer_times[-1])
        ckpt.maybe_save(epoch, state.params, state.opt_state)

    logger(True, {})

    # Sampling timing: min over 10 reverse-flow draws (ffjord_tabular.jl:262-268).
    nsamples = min(h["batch_size"], 1024)
    sample_fn = jax.jit(lambda p, k: ff.sample(p, k, nsamples))
    timings = []
    skey = jax.random.PRNGKey(seed + 23)
    for i in range(10 if args.limit_batches is None else 3):
        skey, sk = jax.random.split(skey)
        with Timer() as t:
            block(sample_fn(state.params, sk))
        timings.append(t.elapsed)
    sampling_time = min(timings)
    print(f"Time for sampling {nsamples} points: {sampling_time:.4f}s")

    finish(run_dir, {
        "nfe_counts": nfe_counts,
        "train_likelihood": train_lls,
        "test_likelihood": test_lls,
        "train_runtimes": train_times,
        "inference_runtimes": infer_times,
        "sampling_time": sampling_time,
        **provenance(train_loader, solver="tsit5", mode="adjoint",
                     rtol=ff.rtol, atol=ff.atol,
                     regularize=regularize),
        **health.results(),
    }, params=state.params)
    ckpt.close()
    return state

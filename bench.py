"""Headline benchmark: the two training cells on one GPU.

1. MNIST Neural-ODE regularized training throughput — wall-clock
   throughput of the flagship classifier with error-estimate
   regularization at the reference configuration (batch 512, Tsit5,
   rtol=atol=1.4e-8, lambda=1e2, InvDecay+Momentum — reference:
   experiments/mnist_node.jl:115-130), one jitted program per step.
2. Physionet latent-ODE training throughput — the regularized latent-ODE
   train step (batch 256, saveat=49 stamps, Tsit5 rtol=atol=1.4e-8 —
   reference: experiments/latent_ode.jl:104-192) on the physionet-schema
   data (real bundle when present, synthetic surrogate otherwise).

Both run on the plain XLA path (``NeuralODE``'s ``mode="adjoint"``
engine). The run refuses a backend other than the GPU: a CPU run is only
a rehearsal of the control flow (``--rehearsal``), and says so in its
output.

Prints a device block (platform, device kind, count, ``XLA_FLAGS``, the
card's name and power limit, the data source) and then, as the last line,
ONE JSON object: {"metric", "value", "unit", "vs_baseline"} for the
primary (MNIST) metric, with the latent-ODE numbers carried as extra keys
(``latent_ode_samples_per_sec``, ``latent_ode_vs_baseline``).

``vs_baseline`` compares against a CPU stand-in for the reference's
training throughput: the reference publishes no numbers and Julia is not
available, so the baseline is this same workload executed by XLA:CPU on
one core (measured once, recorded below).

    python bench.py              # on the GPU
    python bench.py --rehearsal  # CPU control-flow rehearsal, no timings
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

BATCH = 512
# Solves take ~30-40 trial steps at rtol=1.4e-8 with the accurate-tanh
# dynamics. mode="adjoint" (the NeuralODE default) pays only for live
# steps in both directions, so the cap is pure safety headroom —
# raising it costs history memory (max_steps x state), not time.
MAX_STEPS = 96
WARMUP = 2
MEASURE = 10

# Reference-CPU stand-in: this benchmark body on XLA:CPU (one core,
# batch 64: 0.60 s/step = 106.5 samples/s; throughput is
# batch-size-invariant because flops scale linearly and the adaptive step
# count is set by the global error norm).
CPU_BASELINE_SAMPLES_PER_SEC = 106.5

# Latent-ODE stand-in measured the same way (XLA:CPU, one core, batch 256).
LATENT_BATCH = 256
LATENT_MAX_STEPS = 256
LATENT_CPU_BASELINE_SAMPLES_PER_SEC = 852.6
LATENT_MEASURE = 6

# The flagship's NFE per train step at rtol=1.4e-8 (synthetic-MNIST data,
# seed 0, the last measured step, WARMUP + MEASURE = 12), pinned so a
# speed "win" can never come from silent step-count drift: a violation
# makes the bench exit nonzero (after printing the JSON). Measured with
# `python bench.py` on one NVIDIA H100 80GB HBM3 (400 W power limit),
# JAX 0.9.0, where both engines gave 188. The single-dispatch engine is
# pinned EXACTLY; the multi-step scan engine lowers to different XLA
# fusions, whose f32 roundoff may flip an accept/reject on the controller
# boundary, so it is allowed ONE Tsit5 trial step (6 fresh evals under
# FSAL) of drift — reported as its own field and CHARGED: the headline
# throughput is scaled by nfe/expected, so fewer steps can never read as
# a speed-up.
EXPECTED_FLAGSHIP_NFE = 188
NFE_TRIAL_STEP = 6


def nvidia_smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (``"not available"`` where there is no ``nvidia-smi``)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.stdout.strip() or "not available"


def device_block() -> dict:
    """What the numbers were measured on: JAX's view of the device, the
    XLA flags in force, and the card as ``nvidia-smi`` names it."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "card": nvidia_smi_line(),
    }


def require_gpu(rehearsal: bool = False) -> None:
    """Refuse any backend but the GPU, unless this is a rehearsal."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu" and not rehearsal:
        raise SystemExit(
            f"bench: backend is {platform!r}, not 'gpu'; timings here "
            "would not be device numbers. Pass --rehearsal for a CPU "
            "control-flow rehearsal.")


def flagship_model(axis_name=None):
    """The flagship classifier: 784->100->784 time-concat MLP dynamics,
    Tsit5 at rtol=atol=1.4e-8, a Dense(10) head. ``axis_name`` turns on
    globally synchronized step control under ``shard_map``."""
    from regneuralde_tpu.models import (
        ClassifierNODE, Dense, MLPDynamics, NeuralODE)

    node = NeuralODE(
        MLPDynamics(dim=784, hidden=100),
        tspan=(0.0, 1.0),
        solver="tsit5",
        rtol=1.4e-8,
        atol=1.4e-8,
        max_steps=MAX_STEPS,
        axis_name=axis_name,
    )
    return ClassifierNODE(None, node, Dense(10))


def flagship_loss(clf, mode="adjoint", lam=100.0):
    """``loss_fn(params, x, y) -> (ce + lam * EEst*dt reg, (nfe,
    success))`` for :func:`flagship_model`, solved with ``mode``."""
    import optax

    from regneuralde_tpu import reg

    def loss_fn(params, x, y):
        out = clf(params, x, mode=mode)
        ce = optax.softmax_cross_entropy(out.logits, y).mean()
        r = reg.error_estimate(out.telemetry, agg="mean")
        return ce + lam * r, (out.nfe, out.success)

    return loss_fn


def build():
    """The flagship train step at the reference shape. Returns
    ``(train_step, multi_step, state, batches, source)``: the jitted
    single step, the K-steps-per-dispatch engine, the initial train state,
    ``WARMUP + MEASURE`` batches and the data source (``"synthetic"`` or
    the file it was read from)."""
    import jax
    import jax.numpy as jnp
    import optax

    from regneuralde_tpu.data import load_mnist
    from regneuralde_tpu.training import (
        TrainState, create_train_state, make_multi_step,
        mnist_node_optimizer)

    clf = flagship_model()
    # Real data when present, iterated batch-to-batch as in the
    # experiment: repeating one batch (or random labels) overfits within
    # a dozen steps and drives the dynamics into an arbitrarily stiff
    # regime whose NFE diverges to the step cap.
    train_loader, _ = load_mnist(BATCH, flatten=True, seed=0)
    batches = []
    while len(batches) < WARMUP + MEASURE:  # cycle epochs if needed
        for xb, yb in train_loader:
            if xb.shape[0] == BATCH:
                batches.append((jnp.asarray(xb), jnp.asarray(yb)))
            if len(batches) >= WARMUP + MEASURE:
                break
    x, y = batches[0]
    params = clf.init(jax.random.PRNGKey(2), x)
    optimizer = mnist_node_optimizer()
    loss_fn = flagship_loss(clf)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, x, y):
        (loss, (nfe, success)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, x, y)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        return (TrainState(params, opt_state, state.step + 1), loss, nfe,
                success)

    # Multi-step engine: K train steps per dispatch (lax.scan over stacked
    # batches). donate=False so the warm (compile) call and the timed call
    # replay the IDENTICAL trajectory from the same post-warmup state.
    multi_step = make_multi_step(
        lambda p, x, y: (lambda lo: (lo[0], {"nfe": lo[1][0]}))(
            loss_fn(p, x, y)),
        optimizer, has_aux=True, donate=False)

    return (train_step, multi_step, create_train_state(params, optimizer),
            batches, train_loader.source)


def build_latent():
    """The latent-ODE regularized train step at the reference shape
    (experiments/latent_ode.jl:104-192): masked-GRU encoder, latent-20 ODE
    with AlternatingMLP dynamics decoded at the 49 stamps, masked Gaussian
    LL (sigma=0.01) + KL + EEst*dt regularizer. Returns ``(train_step,
    multi_step, state, batches, source)`` like :func:`build`; each batch
    is ``(data, mask, _, _, times, _)``."""
    import jax
    import jax.numpy as jnp
    import optax

    from regneuralde_tpu import reg
    from regneuralde_tpu.data import load_physionet
    from regneuralde_tpu.models import (
        MLP, AlternatingMLP, Dense, LatentGRU, LatentTimeSeriesModel,
        NeuralODE)
    from regneuralde_tpu.training import (
        TrainState, create_train_state, latent_ode_optimizer,
        make_multi_step)

    train_loader, _ = load_physionet(LATENT_BATCH, seed=0)
    batches = []
    while len(batches) < WARMUP + LATENT_MEASURE:
        for b in train_loader:
            if b[0].shape[0] == LATENT_BATCH:
                batches.append(tuple(jnp.asarray(a) for a in b[:6]))
            if len(batches) >= WARMUP + LATENT_MEASURE:
                break
    d0, m0, _, _, tp0, _ = batches[0]
    saveat = jnp.sort(tp0[0])

    node = NeuralODE(
        AlternatingMLP(dim=20, hidden=50, depth=4), time_dep=False,
        solver="tsit5", rtol=1.4e-8, atol=1.4e-8,
        max_steps=LATENT_MAX_STEPS, saveat=saveat,
    )
    model = LatentTimeSeriesModel(
        rnn=LatentGRU(in_dim=37, hidden=40, latent_dim=50),
        enc=MLP(features=(50, 2 * 20)), node=node, dec=Dense(37))

    def inputs(d, m, tp):
        dt = jnp.concatenate([tp[:, 1:] - tp[:, :-1],
                              jnp.zeros_like(tp[:, :1])], 1)
        return jnp.concatenate([d, m, dt[..., None]], axis=-1)

    params = model.init(jax.random.PRNGKey(3), inputs(d0, m0, tp0))
    optimizer = latent_ode_optimizer()
    sigma = 0.01

    def loss_fn(params, d, m, tp, key):
        out = model(params, inputs(d, m, tp), key, saveat=saveat)
        err = (out.result - d) * m
        ll = jnp.sum(-jnp.square(err) / (2 * sigma**2), axis=(1, 2))
        ll = ll / jnp.maximum(jnp.sum(m, axis=(1, 2)), 1.0)
        kl = jnp.mean(jnp.exp(out.logvar) + jnp.square(out.mu0) - 1
                      - out.logvar, axis=-1) / 2
        r = reg.error_estimate(out.telemetry, agg="mean")
        return -jnp.mean(ll - kl) + 1e3 * r, (out.nfe, out.success)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, d, m, tp, key):
        (loss, (nfe, success)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params, d, m, tp, key)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = optax.apply_updates(state.params, updates)
        return (TrainState(params, opt_state, state.step + 1), loss, nfe,
                success)

    multi_step = make_multi_step(
        lambda p, d, m, tp, k: (lambda lo: (lo[0], {"nfe": lo[1][0]}))(
            loss_fn(p, d, m, tp, k)),
        optimizer, has_aux=True, donate=False)

    return (train_step, multi_step, create_train_state(params, optimizer),
            batches, train_loader.source)


def measure_latent():
    import jax
    import jax.numpy as jnp
    import numpy as np

    train_step, multi_step, state, batches, source = build_latent()
    key = jax.random.PRNGKey(9)
    for d, m, _, _, tp, _ in batches[:WARMUP]:
        key, sk = jax.random.split(key)
        state, loss, nfe, _ = train_step(state, d, m, tp, sk)
    float(np.asarray(loss))

    meas = batches[WARMUP:WARMUP + LATENT_MEASURE]
    ds = jnp.stack([b[0] for b in meas])
    ms = jnp.stack([b[1] for b in meas])
    tps = jnp.stack([b[4] for b in meas])
    sks = jax.random.split(key, LATENT_MEASURE)
    _, losses, auxs = multi_step(state, ds, ms, tps, sks)  # compile + warm
    float(np.asarray(losses[-1]))
    times = []
    for _ in range(3):  # median of 3 replays of the same trajectory
        t0 = time.perf_counter()
        _, losses, auxs = multi_step(state, ds, ms, tps, sks)
        float(np.asarray(losses[-1]))
        times.append(time.perf_counter() - t0)
    return (LATENT_BATCH * LATENT_MEASURE / float(np.median(times)),
            int(auxs["nfe"][-1]), source)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rehearsal", action="store_true",
                    help="allow a non-GPU backend: a control-flow "
                         "rehearsal whose numbers are not device numbers")
    args = ap.parse_args(argv)

    from regneuralde_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    import numpy as np

    require_gpu(args.rehearsal)

    train_step, multi_step, state, batches, source = build()
    device = dict(device_block(), data_source=source,
                  rehearsal=args.rehearsal)
    print("device: " + json.dumps(device), flush=True)
    if args.rehearsal:
        print("REHEARSAL: backend is not the GPU; the numbers below are "
              "not device numbers", file=sys.stderr, flush=True)

    for x, y in batches[:WARMUP]:
        state, loss, nfe, _ = train_step(state, x, y)
    float(np.asarray(loss))
    # Both engines replay the SAME trajectory from this state, so the
    # multi-step aux NFE is comparable to the single-dispatch one and the
    # NFE pin below cannot trip on extra optimization progress.
    # Deep-copy: train_step donates its state argument.
    state0 = jax.tree.map(jnp.array, state)

    # Median of REPS replays of the identical trajectory; each rep
    # restarts from a fresh copy of state0, so every rep times the same
    # device program on the same data.
    REPS = 3
    single_times = []
    for _ in range(REPS):
        st = jax.tree.map(jnp.array, state0)
        t0 = time.perf_counter()
        for x, y in batches[WARMUP:WARMUP + MEASURE]:
            st, loss, nfe, _ = train_step(st, x, y)
        float(np.asarray(loss))  # device-to-host read ends the window
        single_times.append(time.perf_counter() - t0)

    single_dispatch_sps = BATCH * MEASURE / float(np.median(single_times))
    nfe_single = int(nfe)

    # Multi-step (K=MEASURE steps per dispatch): the headline. Same
    # gradients/optimizer chain per step (pinned by
    # tests/test_data_utils_training.py); the only difference is ONE
    # dispatch instead of MEASURE.
    xs = jnp.stack([b[0] for b in batches[WARMUP:WARMUP + MEASURE]])
    ys = jnp.stack([b[1] for b in batches[WARMUP:WARMUP + MEASURE]])
    _, losses, auxs = multi_step(state0, xs, ys)  # compile + warm
    float(np.asarray(losses[-1]))
    multi_times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        _, losses, auxs = multi_step(state0, xs, ys)  # same trajectory
        float(np.asarray(losses[-1]))
        multi_times.append(time.perf_counter() - t0)
    samples_per_sec = BATCH * MEASURE / float(np.median(multi_times))
    nfe = auxs["nfe"][-1]

    latent_sps, latent_nfe, _ = measure_latent()

    # The pin (and the equal-work normalization) only mean anything at
    # the flagship configuration; smoke harnesses shrink BATCH/MAX_STEPS
    # and legitimately land on a different step count.
    flagship_shape = BATCH == 512 and MAX_STEPS == 96
    drift = int(nfe) - EXPECTED_FLAGSHIP_NFE
    nfe_ok = (not flagship_shape
              or (nfe_single == EXPECTED_FLAGSHIP_NFE
                  and abs(drift) <= NFE_TRIAL_STEP))
    # Equal-work normalization: charge the multi-step engine as if it had
    # executed exactly the pinned NFE. Exact-pin runs are unchanged.
    samples_per_sec_norm = (samples_per_sec
                            * (int(nfe) / EXPECTED_FLAGSHIP_NFE)
                            if flagship_shape else samples_per_sec)

    print(json.dumps({
        "metric": "mnist_node_regularized_train_throughput",
        "value": round(samples_per_sec_norm, 2),
        "unit": "samples/sec (batch 512, Tsit5 rtol=1.4e-8, reg on, "
                f"nfe_per_step={int(nfe)}, {MEASURE} steps/dispatch, "
                "NFE-normalized)",
        "vs_baseline": round(
            samples_per_sec_norm / CPU_BASELINE_SAMPLES_PER_SEC, 2),
        "single_dispatch_samples_per_sec": round(single_dispatch_sps, 2),
        "raw_samples_per_sec": round(samples_per_sec, 2),
        "nfe_per_step": int(nfe),
        "nfe_single_dispatch": nfe_single,
        "nfe_pin": {"expected": EXPECTED_FLAGSHIP_NFE,
                    "multi_step_drift": drift,
                    "multi_step_tolerance": NFE_TRIAL_STEP, "ok": nfe_ok},
        "latent_ode_samples_per_sec": round(latent_sps, 2),
        "latent_ode_nfe_per_step": latent_nfe,
        "latent_ode_vs_baseline": round(
            latent_sps / LATENT_CPU_BASELINE_SAMPLES_PER_SEC, 2),
        "device": device,
    }))
    if not nfe_ok:
        print(f"NFE PIN VIOLATION: flagship nfe single={nfe_single} "
              f"multi={int(nfe)} vs pin {EXPECTED_FLAGSHIP_NFE} "
              f"(multi tolerance +-{NFE_TRIAL_STEP}) — throughput not "
              "comparable to the recorded runs", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()

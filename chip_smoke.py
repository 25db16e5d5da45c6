"""Smoke run of the training path on the GPU: the quickest proof that the
system still starts on the card and computes the right thing.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: data parallelism only

One card, one process, in order:

1. startup — the card's name and power limit (``nvidia-smi``, before JAX
   is imported), the compile cache, and a device gate: anything but a
   GPU backend exits nonzero before any result is printed;
2. flagship — ``bench.build()``'s MNIST Neural-ODE train step (784->100
   ->784 MLP dynamics, batch 512, Tsit5 at rtol=atol=1.4e-8, EEst*dt
   regularizer, discrete adjoint), 3 full-width steps: compile time,
   ``memory_analysis()``, per-step wall time, loss, NFE, success,
   per-trial-step time, ``peak_bytes_in_use``;
3. parity — the flagship loss and gradient under ``mode="adjoint"``
   against the ``mode="scan"`` oracle at full width (equal NFE required);
4. latent — ``bench.build_latent()``'s latent-ODE train step, 3 steps;
5. on-device checks — the ``chip``-marked tests, in this process;
6. tanh numerics — max abs error against float64 for ``jnp.tanh`` and
   ``ops.math.tanh``.

With ``--four`` it runs only the path users run across cards: the
flagship at global batch 512 (128 per card) with globally synchronized
step control on a 1-D 4-card mesh, compared with the same global batch
on one card.

Any failure raises and exits nonzero. The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Parity tolerances (phase 3). Both modes run the identical discrete
# adjoint, trace the dynamics at HIGHEST (full float32) and run the head
# and loss at the card's default matmul precision (TF32 possible) alike;
# they differ only in how XLA orders float32 rounding in a while loop
# versus a scan. The forward is the same program: equal NFE, equal loss.
# The gradient is checked twice. The task (cross-entropy) gradient has no
# amplifier between rounding and result, so it must agree tightly. The
# EEst*dt regularizer's gradient differentiates a tolerance-normalized
# error (err / (atol + |y| rtol)), which multiplies float32 rounding in
# the stage differences by ~1/rtol = 7e7: on one CPU core in float32 at
# batch 16 the regularized gradient already differs by 2.2e-3 relative
# (task gradient: 1.6e-7), so its bound is set 10x above that.
PARITY_LOSS_RTOL = 1e-5
PARITY_TASK_GRAD_REL_L2 = 1e-4
PARITY_GRAD_REL_L2 = 2e-2

# --four: the 4-card solve psums its error norms in another order than
# the one-card solve reduces them, so an accept/reject on the controller
# boundary may flip: NFE may differ by one Tsit5 trial step (6 fresh
# evaluations under FSAL), and the loss by what one trial step moves it.
FOUR_NFE_TOL = 6
FOUR_LOSS_RTOL = 1e-3

# The test files holding ``chip``-marked tests (phase 5).
CHIP_TEST_FILES = ("test_on_device.py", "test_adjoint.py")


def log(msg: str) -> None:
    print(msg, flush=True)


def _tree_rel_l2(a, b) -> float:
    import jax
    import numpy as np

    la = np.concatenate([np.asarray(x, np.float64).ravel()
                         for x in jax.tree_util.tree_leaves(a)])
    lb = np.concatenate([np.asarray(x, np.float64).ravel()
                         for x in jax.tree_util.tree_leaves(b)])
    if not (np.isfinite(la).all() and np.isfinite(lb).all()):
        raise AssertionError("non-finite gradient")
    return float(np.linalg.norm(la - lb) / max(np.linalg.norm(lb), 1e-30))


def _peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}  # None on the CPU
    return int(stats.get("peak_bytes_in_use", -1))


def _run_steps(name, train_step, state, batches, n_steps):
    """Compile ``train_step`` ahead of time (reported as set-up), then take
    ``n_steps`` steps, printing wall time, loss, NFE, success and the time
    per trial step. Raises if a loss is non-finite or a solve hit its cap."""
    import numpy as np

    t0 = time.perf_counter()
    compiled = train_step.lower(state, *batches[0]).compile()
    compile_s = time.perf_counter() - t0
    log(f"[{name}] compile (set-up): {compile_s:.3f} s")
    log(f"[{name}] memory_analysis: {compiled.memory_analysis()}")
    for i in range(n_steps):
        batch = batches[i % len(batches)]
        t0 = time.perf_counter()
        state, loss, nfe, success = compiled(state, *batch)
        loss = float(np.asarray(loss))  # device-to-host read ends the step
        dt = time.perf_counter() - t0
        nfe = int(np.max(np.asarray(nfe)))
        success = bool(np.all(np.asarray(success)))
        # NFE = 2 (initial derivative + Hairer dt) + 6 per trial step.
        trial_steps = max((nfe - 2) // 6, 1)
        log(f"[{name}] step {i}: wall {dt * 1e3:.3f} ms, loss {loss:.6f}, "
            f"nfe {nfe}, success {success}, "
            f"per trial step {dt / trial_steps * 1e3:.4f} ms (fwd+bwd)")
        if not np.isfinite(loss):
            raise AssertionError(f"{name}: non-finite loss at step {i}")
        if not success:
            raise AssertionError(f"{name}: solve hit max_steps at step {i}")
    log(f"[{name}] peak_bytes_in_use: {_peak_bytes()}")
    return state


def phase_flagship():
    import bench

    train_step, _, state, batches, source = bench.build()
    log(f"[flagship] data source: {source}; batch {bench.BATCH}, "
        f"max_steps {bench.MAX_STEPS}")
    _run_steps("flagship", train_step, state, batches, 3)
    return batches


def phase_parity(batches):
    import jax
    import numpy as np

    import bench

    clf = bench.flagship_model()
    x, y = batches[0]
    params = clf.init(jax.random.PRNGKey(2), x)
    res = {}
    for mode in ("adjoint", "scan"):
        for lam in (100.0, 0.0):
            fn = jax.jit(jax.value_and_grad(
                bench.flagship_loss(clf, mode, lam), has_aux=True))
            t0 = time.perf_counter()
            (loss, (nfe, _)), grads = fn(params, x, y)
            loss = float(np.asarray(loss))
            log(f"[parity] {mode}, lambda {lam:g}: loss {loss:.8f}, nfe "
                f"{int(nfe)}, first call {time.perf_counter() - t0:.3f} s "
                "(incl. compile)")
            res[mode, lam] = (loss, int(nfe), grads)
    (la, na, ga), (ls, ns, gs) = res["adjoint", 100.0], res["scan", 100.0]
    loss_rel = abs(la - ls) / max(abs(ls), 1e-30)
    grad_rel = _tree_rel_l2(ga, gs)
    task_rel = _tree_rel_l2(res["adjoint", 0.0][2], res["scan", 0.0][2])
    log(f"[parity] nfe adjoint {na} scan {ns}; loss rel diff {loss_rel:.3e} "
        f"(tol {PARITY_LOSS_RTOL:g}); task grad rel L2 {task_rel:.3e} "
        f"(tol {PARITY_TASK_GRAD_REL_L2:g}); regularized grad rel L2 "
        f"{grad_rel:.3e} (tol {PARITY_GRAD_REL_L2:g})")
    if na != ns:
        raise AssertionError(f"parity: NFE differs ({na} vs {ns})")
    if (loss_rel > PARITY_LOSS_RTOL or task_rel > PARITY_TASK_GRAD_REL_L2
            or grad_rel > PARITY_GRAD_REL_L2):
        raise AssertionError("parity: adjoint and scan disagree")


def phase_latent():
    import bench
    import jax

    train_step, _, state, batches, source = bench.build_latent()
    log(f"[latent] data source: {source}; batch {bench.LATENT_BATCH}, "
        f"max_steps {bench.LATENT_MAX_STEPS}")
    keys = jax.random.split(jax.random.PRNGKey(9), len(batches))
    args = [(d, m, tp, k) for (d, m, _, _, tp, _), k in zip(batches, keys)]
    _run_steps("latent", train_step, state, args, 3)


class _Tally:
    """pytest plugin: counts test outcomes of the in-process run."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed.append(report.nodeid)
        elif report.failed:
            self.failed.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)


def phase_chip_tests():
    import pytest

    # tests/conftest.py keeps the suite on the CPU unless asked for the
    # card; this process already holds it. The empty addopts drops the
    # project's worker-process options: one process owns the card.
    os.environ["REGNDE_CHIP_TESTS"] = "1"
    tally = _Tally()
    rc = pytest.main(
        ["-q", "-o", "addopts=", "-m", "chip", "-p", "no:cacheprovider"]
        + [str(REPO / "tests" / f) for f in CHIP_TEST_FILES],
        plugins=[tally])
    log(f"[chip tests] passed {len(tally.passed)}: {tally.passed}")
    if rc != 0 or tally.failed or tally.skipped or not tally.passed:
        raise AssertionError(
            f"chip tests: exit {rc}, failed {tally.failed}, "
            f"skipped {tally.skipped}")


def phase_tanh():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from regneuralde_tpu.ops.math import tanh as accurate_tanh

    x = np.linspace(-10.0, 10.0, 1 << 22, dtype=np.float32)
    ref = np.tanh(x.astype(np.float64))
    for name, fn in (("jnp.tanh", jnp.tanh),
                     ("ops.math.tanh", accurate_tanh)):
        y = np.asarray(jax.jit(fn)(jnp.asarray(x)), np.float64)
        log(f"[tanh] {name}: max abs error vs float64 "
            f"{float(np.max(np.abs(y - ref))):.3e}")


def phase_four():
    """Data parallelism with globally synchronized step control on a 1-D
    4-card mesh against the same global batch on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    import bench
    from regneuralde_tpu import parallel as par
    from regneuralde_tpu.training import TrainState, mnist_node_optimizer

    n = len(jax.devices())
    if n < 4:
        raise SystemExit(f"chip_smoke --four: found {n} device(s), need 4")
    _, _, _, batches, source = bench.build()
    x, y = batches[0]
    log(f"[four] data source: {source}; global batch {x.shape[0]}, "
        f"{x.shape[0] // 4} per card")
    optimizer = mnist_node_optimizer()

    # One card.
    clf1 = bench.flagship_model()
    params = clf1.init(jax.random.PRNGKey(2), x)
    (l1, (nfe1, _)), _ = jax.jit(jax.value_and_grad(
        bench.flagship_loss(clf1), has_aux=True))(params, x, y)
    l1, nfe1 = float(l1), int(nfe1)
    log(f"[four] one card: loss {l1:.8f}, nfe {nfe1}")

    # Four cards: the experiment's --data-parallel path.
    mesh = par.make_mesh(4)
    clf4 = bench.flagship_model(axis_name=par.AXIS)
    loss4 = bench.flagship_loss(clf4)
    dp_step = par.make_dp_train_step(
        lambda p, xb, yb: (lambda lo: (lo[0], {"nfe": lo[1][0]}))(
            loss4(p, xb, yb)),
        optimizer, mesh)
    xs, ys = par.shard_batch(mesh, (x, y))
    for s in xs.addressable_shards:
        log(f"[four] input shard {s.index} on {s.device}")
    # NFE on each card, read per shard (a pmean would hide a mismatch);
    # before the train step, which donates the replicated parameters.
    per_card = jax.jit(jax.shard_map(
        lambda p, xb: clf4(p, xb, mode="while").nfe[None],
        mesh=mesh, in_specs=(P(), P(par.AXIS)), out_specs=P(par.AXIS)))
    nfe_cards = [int(v) for v in np.asarray(per_card(params, xs))]
    state = TrainState(par.replicate(mesh, params),
                       par.replicate(mesh, optimizer.init(params)), 0)
    t0 = time.perf_counter()
    compiled = dp_step.lower(state, xs, ys).compile()
    log(f"[four] compile (set-up): {time.perf_counter() - t0:.3f} s")
    for i in range(3):
        t0 = time.perf_counter()
        state, loss, aux = compiled(state, xs, ys)
        loss = float(np.asarray(loss))
        log(f"[four] step {i}: wall {(time.perf_counter() - t0) * 1e3:.3f} "
            f"ms, loss {loss:.8f}, nfe {float(aux['nfe'])}")
        if i == 0:
            l4 = loss

    loss_rel = abs(l4 - l1) / max(abs(l1), 1e-30)
    log(f"[four] nfe per card {nfe_cards} vs one card {nfe1} (tol "
        f"{FOUR_NFE_TOL}); loss rel diff {loss_rel:.3e} (tol "
        f"{FOUR_LOSS_RTOL:g})")
    if len(set(nfe_cards)) != 1:
        raise AssertionError(f"--four: NFE differs across cards {nfe_cards}")
    if abs(nfe_cards[0] - nfe1) > FOUR_NFE_TOL:
        raise AssertionError("--four: NFE drifts from the one-card run")
    if loss_rel > FOUR_LOSS_RTOL:
        raise AssertionError("--four: loss disagrees with the one-card run")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card data-parallel path and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    # Phase 1: the card, before JAX is imported.
    sys.path.insert(0, str(REPO))
    import bench

    log(f"card: {bench.nvidia_smi_line()}")
    from regneuralde_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    import jax

    bench.require_gpu()  # the device gate: no GPU, no result
    devs = jax.devices()
    log(f"devices: {devs}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")

    t_all = time.perf_counter()
    if args.four:
        phase_four()
    else:
        batches = phase_flagship()
        phase_parity(batches)
        phase_latent()
        phase_chip_tests()
        phase_tanh()
    log(f"total {time.perf_counter() - t_all:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

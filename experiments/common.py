"""Shared experiment harness.

Replicates the skeleton every reference script follows (SURVEY §2.2):
YAML config + seed -> timestamped run dir with config snapshot -> model
build -> epoch-0 eval (inference runtime, NFE, metric) -> warm-start
gradient/compile -> epoch loop (train, per-epoch NFE on a fixed dummy
batch, full eval, table log) -> weights + results.yml. Adds what the
reference lacks: CLI overrides for smoke runs, periodic checkpoints with
resume, and optional data-parallel execution over a device mesh.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import jax
import numpy as np

# Allow running as `python experiments/<name>.py` from the repo root.
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from regneuralde_tpu.training import load_config, make_run_dir, save_yaml  # noqa: E402
from regneuralde_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# Persistent compilation cache: adaptive-solver programs at "highest"
# matmul precision are compile-heavy; cache them across runs.
enable_compile_cache()


def parse_args(default_config: str) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--config", default=default_config)
    p.add_argument("--epochs", type=int, default=None,
                   help="override config epochs (smoke runs)")
    p.add_argument("--limit-batches", type=int, default=None,
                   help="cap train/eval batches per epoch (smoke runs)")
    p.add_argument("--eval-batches", type=int, default=None,
                   help="cap the per-epoch full-dataset eval sweeps only "
                        "(training unaffected; long adaptive eval solves "
                        "can dominate epoch wall time)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--results-dir", default="results")
    p.add_argument("--regularize", type=lambda s: s.lower() == "true",
                   default=None)
    p.add_argument("--reg-type", default=None,
                   choices=["error_est", "stiff_est", "error_stiff_est"])
    p.add_argument("--steer", type=lambda s: s.lower() == "true", default=None)
    p.add_argument("--max-steps", type=int, default=None,
                   help="solver trial-step bound")
    p.add_argument("--rtol", type=float, default=None,
                   help="override the solver's relative tolerance (the "
                        "reference hard-codes per-script tolerances; this "
                        "exists for conditioning studies, e.g. a latent-ODE "
                        "regime where the f32 error estimate is above the "
                        "cancellation noise floor)")
    p.add_argument("--atol", type=float, default=None,
                   help="override the solver's absolute tolerance")
    p.add_argument("--lam-r0", type=float, default=None,
                   help="override the solver-regularizer lambda schedule start")
    p.add_argument("--lam-r1", type=float, default=None,
                   help="override the solver-regularizer lambda schedule end")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--data-parallel", type=int, default=None, metavar="N",
                   help="run data-parallel over N mesh devices")
    p.add_argument("--compensated-eest", action="store_true",
                   help="double-f32 embedded-error estimator arithmetic "
                        "(ops.compensated; generic sweep only)")
    p.add_argument("--per-sample", action="store_true",
                   help="per-sample adaptive stepping (each batch element "
                        "gets its own controller and NFE; reported NFE is "
                        "the batch max = the solve's wall-clock cost, with "
                        "the mean printed alongside)")
    p.add_argument("--per-sample-engine", default="batched",
                   choices=["batched", "vmap"],
                   help="per-sample engine: the per-lane-controller dense "
                        "engine (default; 2-D states) or the fully "
                        "general vmap engine")
    p.add_argument("--resume-from", default=None, metavar="RUN_DIR",
                   help="resume from the latest checkpoint of a prior run dir")
    return p.parse_args()


def setup(args, experiment: str):
    """Load config, apply overrides, create the run dir. Returns
    (cfg_dict, hyper_dict, run_dir)."""
    cfg = load_config(args.config)
    h = dict(cfg.get("hyperparameters", {}))
    if args.epochs is not None:
        h["epochs"] = args.epochs
    if args.batch_size is not None:
        h["batch_size"] = args.batch_size
    if args.regularize is not None:
        h["regularize"] = args.regularize
    if args.reg_type is not None:
        h["type"] = args.reg_type
    if args.steer is not None:
        h["steer"] = args.steer
    if args.seed is not None:
        cfg["seed"] = args.seed
    run_dir = make_run_dir(
        args.results_dir, experiment, bool(h.get("regularize", False)),
        h.get("type"), config_path=args.config,
    )
    # The raw config snapshot alone mis-documents CLI-driven runs (e.g.
    # --batch-size/--rtol sweeps); record the post-override view too.
    save_yaml(Path(run_dir) / "config_effective.yml",
              {**cfg, "hyperparameters": h,
               "cli": {k: v for k, v in vars(args).items()
                       if v is not None and v is not False}})
    print(f"[{experiment}] run dir: {run_dir}")
    print(f"[{experiment}] devices: {jax.devices()}")
    return cfg, h, run_dir


def guarded_train_step(loss_fn, optimizer):
    """Jitted train step with the NaN guard enabled: non-finite gradients
    skip the whole update (params AND optimizer state) instead of
    poisoning the run — the enabled version of the reference's
    commented-out NaN abort (src/utils.jl:152). aux gains
    ``grads_finite``."""
    from regneuralde_tpu.training import make_train_step

    return make_train_step(loss_fn, optimizer, has_aux=True, nan_guard=True)


class HealthMonitor:
    """Surfaces the reference's silent failure modes: truncated solves
    (``stats.success`` is never checked anywhere in the reference) and
    non-finite gradients (src/utils.jl:152 is commented out). Feed each
    train-step aux dict; warns on first occurrence and accumulates counts
    for results.yml."""

    def __init__(self, name: str = "train"):
        self.name = name
        self.cap_hits = 0
        self.nan_skips = 0
        self.steps = 0

    def update(self, aux: dict):
        self.steps += 1
        ok = aux.get("success")
        # success may be a bool scalar or (under DP pmean) a float in
        # [0, 1]; anything below 1.0 means some solve was truncated.
        if ok is not None and float(ok) < 1.0:
            self.cap_hits += 1
            if self.cap_hits == 1:
                print(f"WARNING [{self.name}]: solver hit the max_steps cap "
                      f"(truncated integration) at train step {self.steps}")
        gf = aux.get("grads_finite")
        if gf is not None and not bool(gf):
            self.nan_skips += 1
            if self.nan_skips == 1:
                print(f"WARNING [{self.name}]: non-finite gradients — update "
                      f"skipped at train step {self.steps}")

    def results(self) -> dict:
        if self.cap_hits or self.nan_skips:
            print(f"[{self.name}] health: {self.cap_hits} solver-cap hits, "
                  f"{self.nan_skips} NaN-skipped updates "
                  f"over {self.steps} steps")
        return {"solver_cap_hits": self.cap_hits,
                "nan_skipped_steps": self.nan_skips,
                "train_steps": self.steps}


class Timer:
    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.elapsed = time.time() - self.t0


def block(tree):
    """Block until async dispatch finishes (honest timing)."""
    for leaf in jax.tree_util.tree_leaves(tree):
        if hasattr(leaf, "block_until_ready"):
            leaf.block_until_ready()
    return tree


def provenance(loader=None, **kw):
    """Run-provenance block for results.yml: the data source, solver
    configuration, and backend — so a synthetic-data run is
    distinguishable from a real-data run in the artifact (the reference
    only prints this to stdout)."""
    out = {"backend": jax.devices()[0].platform}
    if loader is not None:
        out["data_source"] = str(getattr(loader, "source", "unknown"))
    out.update(kw)
    return {"provenance": out}


def finish(run_dir: Path, results: dict, params=None):
    """Write results.yml (+ final weights) like the reference
    (mnist_node.jl:269-280)."""
    save_yaml(Path(run_dir) / "results.yml",
              jax.tree_util.tree_map(
                  lambda v: v.tolist() if isinstance(v, np.ndarray) else v,
                  results))
    if params is not None:
        flat = jax.tree_util.tree_map(np.asarray, params)
        np.savez(Path(run_dir) / "weights.npz",
                 **{f"p{i}": l for i, l in
                    enumerate(jax.tree_util.tree_leaves(flat))})
    print(f"results written to {run_dir}")

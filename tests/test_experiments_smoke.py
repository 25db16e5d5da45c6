"""Experiment-CLI smoke tests: every script must run end-to-end.

Runs each of the six ``experiments/*.py`` mains as a subprocess on CPU
(the real user surface: argparse, config, data fallback, training loop,
logging, results files). One tiny epoch each; asserts the results bundle
lands on disk and the health counters (solver-cap hits / NaN-skipped
steps) are recorded — the failure-visibility contract the reference lacks
(its stats.success is never checked; src/utils.jl:152 NaN abort is
commented out).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent


def _run_cli(script, tmp_path, extra=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, f"experiments/{script}.py",
         "--epochs", "1", "--limit-batches", "1", "--batch-size", "16",
         "--max-steps", "48", "--results-dir", str(tmp_path), *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, (proc.stdout[-1000:], proc.stderr[-3000:])
    runs = list((tmp_path / script).iterdir())
    assert len(runs) == 1
    results = yaml.safe_load((runs[0] / "results.yml").read_text())
    assert (runs[0] / "config.yml").exists()
    assert (runs[0] / "weights.npz").exists()
    # Health counters must always be present in results.yml.
    assert "solver_cap_hits" in results
    assert "nan_skipped_steps" in results
    return results


def test_mnist_node_cli_smoke(tmp_path):
    results = _run_cli("mnist_node", tmp_path,
                       extra=["--batch-size", "32"])
    assert len(results["nfe_counts"]) == 2  # epoch 0 + epoch 1
    assert all(n > 0 for n in results["nfe_counts"])


def test_mnist_node_per_sample_cli_smoke(tmp_path):
    results = _run_cli("mnist_node", tmp_path,
                       extra=["--batch-size", "32", "--per-sample",
                              "--steer", "true"])
    assert results["per_sample"] is True
    assert len(results["nfe_means_per_sample"]) == 2
    # mean per-sample NFE can never exceed the recorded max
    assert all(m <= n + 1e-6 for m, n in
               zip(results["nfe_means_per_sample"], results["nfe_counts"]))


def test_latent_ode_cli_smoke(tmp_path):
    results = _run_cli("latent_ode", tmp_path)
    assert len(results["nfe_counts"]) == 2
    assert all(n > 0 for n in results["nfe_counts"])


def test_latent_ode_per_sample_cli_smoke(tmp_path):
    results = _run_cli("latent_ode", tmp_path, extra=["--per-sample"])
    assert results["per_sample"] is True
    assert len(results["nfe_means_per_sample"]) == 2
    assert all(m <= n + 1e-6 for m, n in
               zip(results["nfe_means_per_sample"], results["nfe_counts"]))


def test_mnist_nsde_cli_smoke(tmp_path):
    results = _run_cli("mnist_nsde", tmp_path)
    assert len(results["nfe1_counts"]) == 2
    assert all(n > 0 for n in results["nfe1_counts"])


def test_mnist_nsde_per_sample_cli_smoke(tmp_path):
    results = _run_cli("mnist_nsde", tmp_path, extra=["--per-sample"])
    assert results["per_sample"] is True
    assert len(results["nfe1_means_per_sample"]) == 2
    assert all(m <= n + 1e-6 for m, n in
               zip(results["nfe1_means_per_sample"], results["nfe1_counts"]))


def test_sde_toy_cli_smoke(tmp_path):
    # --epochs caps iterations; --batch-size is the trajectory count.
    results = _run_cli("sde_toy", tmp_path, extra=["--epochs", "2"])
    assert results["nfe1"] > 0
    assert results["prediction_time"] > 0


@pytest.mark.parametrize("script", ["ffjord_gaussian", "ffjord_tabular"])
def test_ffjord_cli_smoke(tmp_path, script):
    results = _run_cli(script, tmp_path)
    assert len(results["nfe_counts"]) == 2
    assert results["sampling_time"] > 0


def test_bench_emits_json_line(tmp_path):
    # bench.py contract: ONE JSON line with the four keys, last. On the
    # CPU only as a labelled rehearsal.
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = (
        "import bench, io, contextlib;"
        "bench.BATCH=16; bench.MAX_STEPS=32; bench.MEASURE=2; bench.WARMUP=1;"
        "bench.LATENT_BATCH=16; bench.LATENT_MAX_STEPS=48;"
        "bench.LATENT_MEASURE=1;"
        "buf = io.StringIO();\n"
        "with contextlib.redirect_stdout(buf): bench.main(['--rehearsal'])\n"
        "print(buf.getvalue().strip().splitlines()[-1])"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = proc.stdout.strip().splitlines()[-1]
    obj = json.loads(line)
    assert {"metric", "value", "unit", "vs_baseline"} <= set(obj)
    assert obj["value"] > 0
    assert obj["latent_ode_samples_per_sec"] > 0
    assert obj["device"]["rehearsal"] is True
    assert obj["device"]["platform"] == "cpu"
    assert "REHEARSAL" in proc.stderr

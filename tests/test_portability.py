"""What lets the main path run on a machine with only JAX and its core
numerics stack: the in-repo module layer (``models.nn``) in place of
flax, optional packages imported where they are used, the compile-cache
rule, and the entry points' refusal of a backend that is not the GPU."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
from regneuralde_tpu.models import (
    MLP,
    AlternatingMLP,
    ClassifierNODE,
    ConcatSquashLinear,
    CSLDynamics,
    Dense,
    LatentGRU,
    MLPDynamics,
    NeuralODE,
    RecognitionRNN,
    TDChain,
)
from regneuralde_tpu.models.nn import is_module
from regneuralde_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent
KEY = jax.random.PRNGKey(0)
X = jnp.ones((3, 6))
XS = jnp.ones((2, 4, 7))


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return env


# -- optional packages -------------------------------------------------------

_BLOCK = ("flax", "flax.linen", "orbax", "orbax.checkpoint", "yaml")


@pytest.mark.parametrize("module", [
    "regneuralde_tpu", "regneuralde_tpu.models", "regneuralde_tpu.training",
    "bench", "chip_smoke",
])
def test_imports_without_optional_packages(module):
    # A None entry in sys.modules makes `import name` raise ImportError,
    # as on a machine that lacks the package.
    code = (f"import sys; sys.modules.update(dict.fromkeys({_BLOCK!r}));"
            f"import {module}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_cpu_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_models_build_and_train_without_flax():
    code = (
        f"import sys; sys.modules.update(dict.fromkeys({_BLOCK!r}))\n"
        "import jax, jax.numpy as jnp\n"
        "from regneuralde_tpu.models import (ClassifierNODE, Dense,\n"
        "    MLPDynamics, NeuralODE)\n"
        "clf = ClassifierNODE(None, NeuralODE(MLPDynamics(dim=4, hidden=3),\n"
        "    rtol=1e-3, atol=1e-3, max_steps=32), Dense(2))\n"
        "x = jnp.ones((2, 4))\n"
        "p = clf.init(jax.random.PRNGKey(0), x)\n"
        "g = jax.grad(lambda p: jnp.sum(clf(p, x).logits ** 2))(p)\n"
        "assert all(bool(jnp.isfinite(l).all())\n"
        "           for l in jax.tree_util.tree_leaves(g))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=_cpu_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


# -- the module layer --------------------------------------------------------

# Parameter-tree layouts as flax.linen produced them for these modules
# (name -> kernel/bias shapes); checkpoints and parallel.tp read them.
_LAYOUTS = [
    (MLPDynamics(dim=6, hidden=8), (X, 0.3), {
        "dense_1": {"kernel": (7, 8), "bias": (8,)},
        "dense_2": {"kernel": (9, 6), "bias": (6,)}}),
    (TDChain(features=(10, 2)), (X, 0.3), {
        "dense_0": {"kernel": (7, 10), "bias": (10,)},
        "dense_1": {"kernel": (11, 2), "bias": (2,)}}),
    (MLP(features=(5, 4)), (X,), {
        "dense_0": {"kernel": (6, 5), "bias": (5,)},
        "dense_1": {"kernel": (5, 4), "bias": (4,)}}),
    (AlternatingMLP(dim=6, hidden=5, depth=2), (X,), {
        "up_0": {"kernel": (6, 5), "bias": (5,)},
        "down_0": {"kernel": (5, 6), "bias": (6,)},
        "up_1": {"kernel": (6, 5), "bias": (5,)},
        "down_1": {"kernel": (5, 6), "bias": (6,)}}),
    (ConcatSquashLinear(4), (X, 0.3), {
        "layer": {"kernel": (6, 4), "bias": (4,)},
        "gate": {"kernel": (1, 4)},
        "bias": {"kernel": (1, 4), "bias": (4,)}}),
    (CSLDynamics(dim=6, hidden=7), (X, 0.3), {
        "csl1": {"layer": {"kernel": (6, 7), "bias": (7,)},
                 "gate": {"kernel": (1, 7)},
                 "bias": {"kernel": (1, 7), "bias": (7,)}},
        "csl2": {"layer": {"kernel": (7, 7), "bias": (7,)},
                 "gate": {"kernel": (1, 7)},
                 "bias": {"kernel": (1, 7), "bias": (7,)}},
        "csl3": {"layer": {"kernel": (7, 6), "bias": (6,)},
                 "gate": {"kernel": (1, 6)},
                 "bias": {"kernel": (1, 6), "bias": (6,)}}}),
    (RecognitionRNN(latent_dim=4, hidden=6), (XS,), {
        "cell": {"i2h": {"kernel": (13, 6), "bias": (6,)}},
        "h2o": {"kernel": (6, 8), "bias": (8,)}}),
    (LatentGRU(in_dim=3, hidden=5, latent_dim=4), (XS,), {
        "cell": {
            "update_gate": {"dense_0": {"kernel": (15, 5), "bias": (5,)},
                            "dense_1": {"kernel": (5, 4), "bias": (4,)}},
            "reset_gate": {"dense_0": {"kernel": (15, 5), "bias": (5,)},
                           "dense_1": {"kernel": (5, 4), "bias": (4,)}},
            "new_state": {"dense_0": {"kernel": (15, 5), "bias": (5,)},
                          "dense_1": {"kernel": (5, 8), "bias": (8,)}}}}),
    (Dense(5), (X,), {"kernel": (6, 5), "bias": (5,)}),
]


@pytest.mark.parametrize("module,args,layout", _LAYOUTS,
                         ids=[type(m).__name__ for m, _, _ in _LAYOUTS])
def test_parameter_tree_layout(module, args, layout):
    variables = module.init(KEY, *args)
    assert set(variables) == {"params"}
    shapes = jax.tree_util.tree_map(lambda a: a.shape, variables["params"])
    assert shapes == layout
    assert all(l.dtype == jnp.float32
               for l in jax.tree_util.tree_leaves(variables))
    out = module.apply(variables, *args)
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("fan_in,features", [(784, 100), (101, 784),
                                             (40, 37)])
def test_dense_matches_flax_default_initializers(fan_in, features):
    # flax.linen.Dense: kernel ~ truncated normal (cut at 2 sigma) with
    # variance 1/fan_in (LeCun normal), bias zero.
    p = Dense(features).init(jax.random.PRNGKey(fan_in),
                             jnp.ones((1, fan_in)))["params"]
    w = np.asarray(p["kernel"], np.float64)
    std = 1.0 / np.sqrt(fan_in)
    assert w.shape == (fan_in, features)
    assert abs(w.mean()) < 0.05 * std
    assert abs(w.std() / std - 1.0) < 0.05
    # the underlying normal is scaled by 1/0.8796 so that the truncated
    # distribution has the target variance; nothing lies beyond 2 of its
    # sigmas
    assert np.abs(w).max() <= 2.0 * std / 0.87962566103423978 + 1e-6
    np.testing.assert_array_equal(np.asarray(p["bias"]), 0.0)


def test_dense_promotes_like_flax():
    p = Dense(3).init(KEY, jnp.ones((2, 4)))
    assert Dense(3).apply(p, jnp.ones((2, 4), jnp.float32)).dtype == \
        jnp.float32
    y = Dense(3).apply(p, jnp.ones((5, 2, 4)))
    assert y.shape == (5, 2, 3)


def test_recognition_rnn_scan_matches_unrolled_loop():
    m = RecognitionRNN(latent_dim=2, hidden=3)
    xs = jax.random.normal(KEY, (2, 5, 4))
    v = m.init(KEY, xs)
    p = v["params"]
    h = jnp.zeros((2, 3))
    for t in reversed(range(xs.shape[1])):  # consumed backwards in time
        h = jnp.tanh(jnp.concatenate([xs[:, t], h], -1)
                     @ p["cell"]["i2h"]["kernel"] + p["cell"]["i2h"]["bias"])
    ref = h @ p["h2o"]["kernel"] + p["h2o"]["bias"]
    np.testing.assert_allclose(np.asarray(m.apply(v, xs)), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_csl_forw_n_back_through_apply_method():
    m = CSLDynamics(dim=3, hidden=4)
    v = m.init(KEY, X[:, :3], 0.2)
    e = jnp.ones((3, 3))
    f, _ = m.apply(v, X[:, :3], 0.2, e, method=CSLDynamics.forw_n_back)
    np.testing.assert_allclose(np.asarray(f),
                               np.asarray(m.apply(v, X[:, :3], 0.2)),
                               rtol=1e-6)


class _DuckModule:
    """Any object with flax-style ``init``/``apply`` (a flax module, for
    one) is a module to the model layer; no base class is required."""

    def init(self, key, x, t):
        return {"params": {"w": jnp.full((x.shape[-1],), -1.0)}}

    def apply(self, variables, x, t):
        return x * variables["params"]["w"]


def test_model_layer_duck_types_modules():
    assert is_module(_DuckModule()) and is_module(Dense(2))
    assert not is_module(lambda p, y, t: y)
    node = NeuralODE(_DuckModule(), rtol=1e-6, atol=1e-6, max_steps=64)
    x = jnp.ones((2, 3))
    out = node(node.init(KEY, x), x)
    np.testing.assert_allclose(np.asarray(out.value), np.exp(-1.0),
                               rtol=1e-4)
    clf = ClassifierNODE(None, node, Dense(2))
    assert clf(clf.init(KEY, x), x).logits.shape == (2, 2)


# -- compile cache -----------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == tmp_path
    assert compile_cache.enable_compile_cache() == tmp_path
    assert calls == []  # JAX reads the variable itself; nothing is set


def test_compile_cache_default_is_fixed_path_in_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    expected = REPO / ".jax_cache"
    assert compile_cache.compile_cache_dir() == expected
    assert compile_cache.enable_compile_cache() == expected
    assert compile_cache.enable_compile_cache() == expected
    assert calls == [("jax_compilation_cache_dir", str(expected))] * 2
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# -- device gates ------------------------------------------------------------

def test_device_gate_refuses_cpu_unless_rehearsal():
    # chip_smoke.main and bench.main both pass through this gate.
    with pytest.raises(SystemExit, match="not 'gpu'"):
        bench.require_gpu()
    bench.require_gpu(rehearsal=True)


@pytest.mark.parametrize("script,where", [
    ("chip_smoke.py", "repo"), ("bench.py", "repo"),
    ("chip_smoke.py", "alone"),
])
def test_entry_points_fail_without_gpu(script, where, tmp_path):
    """On a CPU-only backend, and in a directory holding the script and
    nothing else of the repo, the entry point exits nonzero and prints no
    result line."""
    cwd = REPO
    if where == "alone":
        (tmp_path / script).write_text((REPO / script).read_text())
        cwd = tmp_path
    env = _cpu_env()
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout

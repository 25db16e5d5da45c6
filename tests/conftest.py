"""Test configuration: run on CPU with 8 virtual devices.

Multi-device behavior (sharding, synchronized step control) is validated
on a virtual CPU mesh. Tests marked ``chip`` need the GPU; they skip here
(decided in the ``_chip_gate`` fixture below, never at import) and run on
the card with

    REGNDE_CHIP_TESTS=1 python -m pytest tests -m chip -n 0

(``chip_smoke.py`` runs them in its own process). Only that switch lets
this file leave JAX's platform alone; otherwise it pins the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

if not os.environ.get("REGNDE_CHIP_TESTS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

# Inner-loop subset: `pytest -m fast` runs the suite minus the
# compile-heavy modules below (per-sample vmap engines, mesh tests,
# experiment subprocess smokes) and finishes in
# well under 5 minutes. Full-suite coverage is unchanged — marks only
# partition, they never skip by default.
_SLOW_MODULES = {
    "test_per_sample",
    "test_parallel",
    "test_tensor_parallel",
    "test_experiments_smoke",
    "test_rosenbrock",
    "test_nfe_parity",
    "test_adjoint",
    "test_sde",
    "test_gradients",
    "test_tp",
    "test_brownian_stack",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.fast)


@pytest.fixture(autouse=True)
def _chip_gate(request):
    """Skip ``chip``-marked tests unless JAX's device is a GPU. Decided
    here, per test, so every worker collects the same tests."""
    if request.node.get_closest_marker("chip") is None:
        return
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs the GPU (backend is {platform!r}); run "
                    "`python chip_smoke.py` on the card")

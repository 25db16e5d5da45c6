"""Generic tensor parallelism (parallel.tp.make_tp_dynamics).

Contract: the Megatron-split chain evaluated on local shards inside
shard_map reproduces the full module's output, for every supported
dynamics family, and composes with data parallelism + the adaptive solver
(2-D dp x tp mesh) through the NeuralODE model layer.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from regneuralde_tpu.models import MLP, AlternatingMLP, MLPDynamics, NeuralODE
from regneuralde_tpu.parallel.tp import make_tp_dynamics

KEY = jax.random.PRNGKey(0)


def _mesh_2d():
    devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
    return Mesh(devs, ("data", "model"))


def _model_mesh():
    devs = np.asarray(jax.devices()[:2]).reshape(2)
    return Mesh(devs, ("model",))


class TestTPApplyParity:
    @pytest.mark.parametrize(
        "module,time_dep,x_dim",
        [
            (MLPDynamics(dim=8, hidden=6), True, 8),
            (AlternatingMLP(dim=8, hidden=6, depth=2), False, 8),
            (MLP(features=(6, 8)), False, 8),
            (MLP(features=(6, 4, 8)), False, 8),
        ],
        ids=["mlp_dynamics", "alternating", "mlp_even", "mlp_odd"],
    )
    def test_matches_full_module(self, module, time_dep, x_dim):
        x = jax.random.normal(KEY, (4, x_dim))
        t = jnp.float32(0.37)
        fp = (module.init(KEY, x, t) if time_dep else module.init(KEY, x))
        ref = (module.apply(fp, x, t) if time_dep else module.apply(fp, x))

        tp_params, specs, apply_fn = make_tp_dynamics(module, fp)
        mesh = _model_mesh()

        @partial(jax.shard_map, mesh=mesh, in_specs=(specs, P()),
                 out_specs=P())
        def run(params, x):
            return apply_fn(params, x, t)

        out = run(tp_params, x)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=2e-5, atol=1e-6)

    def test_unsupported_module_raises(self):
        from regneuralde_tpu.models import Dense

        m = Dense(4)
        p = m.init(KEY, jnp.ones((2, 4)))
        with pytest.raises(ValueError, match="tensor-parallel"):
            make_tp_dynamics(m, p)


class TestTPNeuralODE:
    def test_2d_mesh_solve_matches_single_device(self):
        dim, hidden = 8, 6
        dyn = MLPDynamics(dim=dim, hidden=hidden)
        x = jax.random.normal(KEY, (8, dim)) * 0.5
        fp = dyn.init(KEY, x, 0.0)

        ref_node = NeuralODE(dyn, rtol=1e-4, atol=1e-4, max_steps=48)
        ref = ref_node(fp, x)

        tp_params, specs, apply_fn = make_tp_dynamics(dyn, fp)
        node = NeuralODE(apply_fn, time_dep=True, rtol=1e-4, atol=1e-4,
                         max_steps=48, axis_name="data")
        mesh = _mesh_2d()

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(specs, P("data", None)), out_specs=P("data", None))
        def run(params, x):
            out = node(params, x)
            return out.value

        value = run(tp_params, x)
        np.testing.assert_allclose(np.asarray(value), np.asarray(ref.value),
                                   rtol=1e-4, atol=1e-6)

    def test_callable_dynamics_init_raises(self):
        node = NeuralODE(lambda p, y, t: y, time_dep=True)
        with pytest.raises(TypeError, match="externally"):
            node.init(KEY, jnp.ones((2, 4)))

"""regneuralde_tpu: a neural differential equation training framework on JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of
``avik-pal/RegNeuralDE.jl`` (ICML 2021, "Opening the Blackbox: Accelerating
Neural Differential Equations by Regularizing Internal Solver Heuristics").

Unlike the reference — which backprops through external Julia solvers with a
tape AD (Tracker.jl) and harvests solver internals via callbacks
(reference: src/models/neural_ode.jl:110-144) — this framework owns the
solver layer: adaptive ODE/SDE integrators are XLA programs (bounded
``lax.scan`` state machines with accept/continue masks and PI step-size
control) whose internal heuristics (local error estimate ``EEst``, step size
``dt``, stiffness estimate ``eigen_est``) are first-class differentiable
outputs.

Layout
------
- ``ops``       solver cores (Tsit5 ODE, SRI/Euler-Maruyama SDE), telemetry
- ``reg``       regularization library (error_est / stiff_est / kinetic / STEER)
- ``models``    NeuralODE / NeuralSDE / FFJORD / classifiers / latent time series
- ``data``      dataset loaders (MNIST, Physionet, MiniBooNE, spirals, mixtures)
- ``training``  optimizers, train harness, config, logging, checkpointing
- ``parallel``  device-mesh data parallelism with globally synchronized step control
- ``utils``     loggers, meters, batched distributions
"""

__version__ = "0.1.0"

from regneuralde_tpu.ops import odeint, sdeint, ODESolution, SDESolution

__all__ = ["odeint", "sdeint", "ODESolution", "SDESolution", "__version__"]

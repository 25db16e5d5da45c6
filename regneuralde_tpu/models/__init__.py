"""Model zoo: neural DE layers and the composite models of the reference."""

from regneuralde_tpu.models.basic import (
    AlternatingMLP,
    ConcatSquashLinear,
    CSLDynamics,
    LatentGRU,
    MLP,
    MLPDynamics,
    RecognitionRNN,
    TDChain,
)
from regneuralde_tpu.models.classifiers import (
    ClassifierNODE,
    ClassifierNODEOutput,
    ClassifierNSDE,
    ClassifierNSDEOutput,
)
from regneuralde_tpu.models.ffjord import FFJORD, FFJORDOutput
from regneuralde_tpu.models.neural_ode import NeuralDEOutput, NeuralODE
from regneuralde_tpu.models.neural_sde import NeuralSDE, NeuralSDEOutput
from regneuralde_tpu.models.nn import Dense, Module
from regneuralde_tpu.models.time_series import (
    LatentTimeSeriesModel,
    LatentTimeSeriesOutput,
)

__all__ = [
    "Dense",
    "Module",
    "MLP",
    "MLPDynamics",
    "TDChain",
    "AlternatingMLP",
    "ConcatSquashLinear",
    "CSLDynamics",
    "LatentGRU",
    "RecognitionRNN",
    "NeuralODE",
    "NeuralDEOutput",
    "NeuralSDE",
    "NeuralSDEOutput",
    "FFJORD",
    "FFJORDOutput",
    "ClassifierNODE",
    "ClassifierNODEOutput",
    "ClassifierNSDE",
    "ClassifierNSDEOutput",
    "LatentTimeSeriesModel",
    "LatentTimeSeriesOutput",
]

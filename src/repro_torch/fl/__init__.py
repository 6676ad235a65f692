"""Federated-learning runtime: Heroes + the FedAvg baseline over a
simulated heterogeneous edge network (paper Sec. III / VI)."""

from repro_torch.fl.engine import (SCHEMES, EngineRunner, ServerState,
                                   build_engine, register_scheme)
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.fl.models import (MODELS, ComposedLayer, FLModelDef,
                                   LayerHint, get_model, make_cnn,
                                   register_model)
from repro_torch.fl.simulation import (build_image_setup, build_runner,
                                       build_setup, run_scheme, summarize)
from repro_torch.fl.types import FLConfig, RoundLog

__all__ = [
    "SCHEMES", "EngineRunner", "ServerState", "build_engine",
    "register_scheme", "HeterogeneityModel",
    "MODELS", "ComposedLayer", "FLModelDef", "LayerHint", "get_model",
    "make_cnn", "register_model",
    "build_image_setup", "build_runner", "build_setup", "run_scheme",
    "summarize",
    "FLConfig", "RoundLog",
]

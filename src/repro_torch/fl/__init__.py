"""Federated-learning runtime: Heroes + baselines over a simulated
heterogeneous edge network (paper Sec. III / VI), on the CNN, the residual
net, the RNN and the composed transformer (training and greedy-decode
serving)."""

from repro_torch.fl.engine import (SCHEMES, EngineRunner, ServerState,
                                   build_engine, register_scheme)
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.fl.models import (MODELS, ComposedLayer, FLModelDef,
                                   LayerHint, get_model, make_cnn,
                                   make_resnet, make_rnn, register_model)
from repro_torch.fl.population import (SCHEDULERS, PopulationRegistry,
                                       VirtualPartition)
from repro_torch.fl.server import RUNNERS  # deprecated shims onto the engine
from repro_torch.fl.simulation import (build_image_setup, build_runner,
                                       build_setup, build_text_setup,
                                       run_scheme, summarize,
                                       time_to_accuracy, traffic_to_accuracy)
from repro_torch.fl.transformer import (greedy_decode, make_transformer,
                                        serving_weights)
from repro_torch.fl.types import FLConfig, RoundLog

__all__ = [
    "SCHEMES", "EngineRunner", "ServerState", "build_engine",
    "register_scheme", "HeterogeneityModel",
    "MODELS", "ComposedLayer", "FLModelDef", "LayerHint", "get_model",
    "make_cnn", "make_resnet", "make_rnn", "register_model", "SCHEDULERS",
    "PopulationRegistry", "VirtualPartition", "RUNNERS",
    "build_image_setup", "build_runner", "build_setup", "build_text_setup",
    "run_scheme", "summarize", "time_to_accuracy", "traffic_to_accuracy",
    "make_transformer", "serving_weights", "greedy_decode",
    "FLConfig", "RoundLog",
]

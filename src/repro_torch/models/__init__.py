"""Decoder-only models, dense and MoE for serving and training, and the
recurrent mixers (Mamba, mLSTM, sLSTM) for serving: the port of
``repro.models``."""
from .config import SHAPES, ModelConfig, ShapeConfig
from .convert import opt_from_numpy, params_from_numpy, params_to_numpy
from .model import Model, build_model, cross_entropy

__all__ = ["Model", "ModelConfig", "SHAPES", "ShapeConfig", "build_model",
           "cross_entropy", "opt_from_numpy", "params_from_numpy",
           "params_to_numpy"]

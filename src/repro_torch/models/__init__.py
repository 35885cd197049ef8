"""Dense decoder-only models for serving: the port of ``repro.models``."""
from .config import ModelConfig
from .convert import params_from_numpy, params_to_numpy
from .model import Model, build_model

__all__ = ["Model", "ModelConfig", "build_model", "params_from_numpy",
           "params_to_numpy"]

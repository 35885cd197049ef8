"""Training: the port of ``repro.train``."""
from .state import (TrainState, protected_leaves, protected_structs,
                    replace_protected)
from .train_loop import Trainer, make_redundancy_step, make_train_step

__all__ = ["TrainState", "Trainer", "make_redundancy_step", "make_train_step",
           "protected_leaves", "protected_structs", "replace_protected"]

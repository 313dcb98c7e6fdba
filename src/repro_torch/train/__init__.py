"""The LM training loop: the train step (autograd, gradient
accumulation, compression, AdamW) and the fault-tolerant Trainer."""
from .loop import InjectedFailure, Trainer, TrainLoopConfig, make_train_step

__all__ = ["InjectedFailure", "Trainer", "TrainLoopConfig",
           "make_train_step"]

"""Serving and training runtime of the port."""

from .serve import ServeConfig, generate, make_serve_fns
from .train import TrainConfig, cross_entropy, make_loss_fn, make_train_step

__all__ = ["ServeConfig", "TrainConfig", "cross_entropy", "generate",
           "make_loss_fn", "make_serve_fns", "make_train_step"]

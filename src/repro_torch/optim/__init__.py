"""Optimizers of the port."""

from .optimizers import (Optimizer, OptimizerConfig, adafactor, adamw,
                         build_optimizer, clip_by_global_norm, cosine_lr)

__all__ = ["Optimizer", "OptimizerConfig", "adafactor", "adamw",
           "build_optimizer", "clip_by_global_norm", "cosine_lr"]

"""Serving, training, distribution and fault-tolerance runtime of the
port (the JAX package's `runtime/__init__.py` exports)."""

from .compression import (CompressionConfig, compress_decompress,
                          compress_with_error_feedback, init_residual)
from .fault_tolerance import (ElasticPlan, Heartbeat, StragglerMitigator,
                              run_with_recovery)
from .serve import ServeConfig, generate, make_serve_fns
from .sharding import (batch_spec, cache_shardings, cache_spec,
                       logical_batch_shardings, param_spec, params_shardings)
from .train import TrainConfig, cross_entropy, make_loss_fn, make_train_step

__all__ = ["CompressionConfig", "ElasticPlan", "Heartbeat", "ServeConfig",
           "StragglerMitigator", "TrainConfig", "batch_spec",
           "cache_shardings", "cache_spec", "compress_decompress",
           "compress_with_error_feedback", "cross_entropy", "generate",
           "init_residual", "logical_batch_shardings", "make_loss_fn",
           "make_serve_fns", "make_train_step", "param_spec",
           "params_shardings", "run_with_recovery"]

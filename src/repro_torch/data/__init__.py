"""Step-indexed synthetic data of the port."""

from .pipeline import DataConfig, batch_for_model, stream, synthetic_batch

__all__ = ["DataConfig", "batch_for_model", "stream", "synthetic_batch"]

"""Checkpointing of the port, in the JAX package's on-disk format."""

from .checkpointer import AsyncCheckpointer, latest_steps, restore, save

__all__ = ["AsyncCheckpointer", "latest_steps", "restore", "save"]

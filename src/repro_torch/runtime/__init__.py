"""Serving runtime of the port."""

from .serve import ServeConfig, generate, make_serve_fns

__all__ = ["ServeConfig", "generate", "make_serve_fns"]

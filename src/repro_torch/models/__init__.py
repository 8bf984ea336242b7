from .model import Model, build_model, param_bytes, param_count

__all__ = ["Model", "build_model", "param_bytes", "param_count"]

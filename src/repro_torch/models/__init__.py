from .common import Model
from .model import build_model

__all__ = ["Model", "build_model"]

"""Model zoo (port): the dense decoder-only GQA family so far."""
from .api import Model, build_model
from .config import ModelConfig, reduced

__all__ = ["Model", "ModelConfig", "build_model", "reduced"]

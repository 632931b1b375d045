"""Config registry: ``get_config(name)`` / ``get_shape(name)`` / ARCHS/SHAPES."""

from .archs import ARCHS
from .base import ModelConfig, SHAPES, ShapeConfig, reduced


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    try:
        cfg = ARCHS[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(sorted(ARCHS))}"
        ) from None
    return reduced(cfg) if smoke else cfg


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(
            f"unknown shape {name!r}; available: {', '.join(sorted(SHAPES))}"
        ) from None


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "get_shape",
    "reduced",
]

"""The trainer (``trainer``), the port of the reference's
``repro.train``."""

from .trainer import TrainConfig, Trainer, TrainResult

__all__ = ["TrainConfig", "TrainResult", "Trainer"]

"""The optimizer: AdamW (``adamw``), the port of the reference's
``repro.optim``."""

from .adamw import OptConfig, adamw_update, init_opt_state, lr_at

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "lr_at"]

from . import api, common, hybrid, mamba2, moe, specs, transformer
from .api import (
    decode_step,
    forward,
    init_params,
    manifest_refs,
    n_active_params,
    n_params,
    param_specs,
    prefill,
)

__all__ = [
    "api",
    "common",
    "hybrid",
    "mamba2",
    "moe",
    "specs",
    "transformer",
    "decode_step",
    "forward",
    "init_params",
    "manifest_refs",
    "n_active_params",
    "n_params",
    "param_specs",
    "prefill",
]

from . import api, common, hybrid, mamba2, moe, runtime, specs, transformer
from .api import (
    decode_step,
    forward,
    init_params,
    loss_fn,
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
    "runtime",
    "specs",
    "transformer",
    "decode_step",
    "forward",
    "init_params",
    "loss_fn",
    "manifest_refs",
    "n_active_params",
    "n_params",
    "param_specs",
    "prefill",
]

from . import api, common, specs, transformer
from .api import (
    decode_step,
    forward,
    init_params,
    manifest_refs,
    n_params,
    param_specs,
    prefill,
)

__all__ = [
    "api",
    "common",
    "specs",
    "transformer",
    "decode_step",
    "forward",
    "init_params",
    "manifest_refs",
    "n_params",
    "param_specs",
    "prefill",
]

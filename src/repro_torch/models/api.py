"""Uniform model API, dispatched on config family (dense only so far).

    param_specs(cfg)                  -> {name: ParamSpec}   (symbol manifest)
    init_params(cfg, seed, device)    -> {name: tensor}
    forward(cfg, params, batch)       -> (logits, aux)
    prefill(cfg, params, batch)       -> (logits, cache)
    decode_step(cfg, params, cache, tokens) -> (logits, cache)
    manifest_refs(cfg)                -> [SymbolRef]  (stable-linking imports)
"""

from __future__ import annotations

from repro_torch.core import SymbolRef

from . import transformer
from .specs import ParamSpec, init_params as _init
from .specs import param_count

_TRANSFORMER_FAMILIES = ("dense", "moe", "audio", "vlm")


def _mod(cfg):
    if cfg.family in _TRANSFORMER_FAMILIES:
        return transformer
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: mamba2 and "
        "the hybrid are ROADMAP Queue A item 10"
    )


def param_specs(cfg) -> dict[str, ParamSpec]:
    return _mod(cfg).param_specs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    return _init(param_specs(cfg), seed, device)


def forward(cfg, params, batch, *, impl="kernel"):
    return _mod(cfg).forward(cfg, params, batch, impl=impl)


def prefill(cfg, params, batch, *, impl="kernel", cache_len=None):
    return _mod(cfg).prefill(cfg, params, batch, impl=impl, cache_len=cache_len)


def decode_step(cfg, params, cache, tokens):
    return _mod(cfg).decode_step(cfg, params, cache, tokens)


# ------------------------------------------------------------ stable linking
def manifest_refs(cfg, *, fragment: bool = False) -> list[SymbolRef]:
    """The model's relocation instructions: one SymbolRef per parameter.

    ``fragment=True`` explodes stacked-layer (and per-expert) tensors into
    per-slice references ("blocks/attn/wq[7]", "...w_gate[3][42]") — the
    relocation-count regime of the paper's Pynamic benchmark, and the mode
    that enables per-layer/per-expert interposition."""
    refs: list[SymbolRef] = []
    for name, s in param_specs(cfg).items():
        if fragment and s.axes and s.axes[0] == "layers" and len(s.shape) > 1:
            L = s.shape[0]
            if len(s.axes) > 1 and s.axes[1] == "experts" and len(s.shape) > 2:
                for l in range(L):
                    for e in range(s.shape[1]):
                        refs.append(
                            SymbolRef(
                                f"{name}[{l}][{e}]", tuple(s.shape[2:]), s.dtype
                            )
                        )
            else:
                for l in range(L):
                    refs.append(
                        SymbolRef(f"{name}[{l}]", tuple(s.shape[1:]), s.dtype)
                    )
        else:
            refs.append(SymbolRef(name, tuple(s.shape), s.dtype))
    return refs


def n_params(cfg) -> int:
    return param_count(param_specs(cfg))

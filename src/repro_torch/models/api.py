"""Uniform model API, dispatched on config family: the transformer families
(dense, MoE, encoder-decoder, VLM), mamba2 (``ssm``) and the hybrid.

    param_specs(cfg)                  -> {name: ParamSpec}   (symbol manifest)
    init_params(cfg, seed, device)    -> {name: tensor}
    loss_fn(cfg, params, batch)       -> scalar tensor
    forward(cfg, params, batch)       -> (logits, aux)
    prefill(cfg, params, batch)       -> (logits, cache)
    decode_step(cfg, params, cache, tokens) -> (logits, cache)
    cache_spec(cfg, B, S)             -> ({name: (shape, dtype)}, {name: axes})
    init_cache(cfg, B, S, device)     -> {name: zero tensor}  (the decode cache)
    manifest_refs(cfg)                -> [SymbolRef]  (stable-linking imports)
    abstract(cfg)                     -> {name: meta tensor}  (dry-run)
    input_specs(cfg, shape)           -> {name: meta tensor}  (dry-run)
    input_axes(cfg, shape)            -> {name: logical axes}

A tensor on the ``meta`` device stands in for the reference's
``ShapeDtypeStruct``: a shape and a dtype, no storage.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import SymbolRef
from repro_torch.device import resolve_device

from . import hybrid, mamba2, transformer
from .specs import ParamSpec, abstract_params, init_params as _init
from .specs import param_bytes, param_count, torch_dtype


def _mod(cfg):
    if cfg.family == "ssm":
        return mamba2
    if cfg.family == "hybrid":
        return hybrid
    return transformer  # dense / moe / audio / vlm


def param_specs(cfg) -> dict[str, ParamSpec]:
    return _mod(cfg).param_specs(cfg)


def init_params(cfg, seed: int = 0, device="cuda"):
    return _init(param_specs(cfg), seed, device)


def forward(cfg, params, batch, *, impl="kernel"):
    return _mod(cfg).forward(cfg, params, batch, impl=impl)


def loss_fn(cfg, params, batch, *, impl="chunked", aux_coef=None):
    """The family's training loss; ``aux_coef`` None takes its default
    (0.01 for the transformer families, 0 for mamba2 and the hybrid)."""
    kw = {} if aux_coef is None else {"aux_coef": aux_coef}
    return _mod(cfg).loss_fn(cfg, params, batch, impl=impl, **kw)


def prefill(cfg, params, batch, *, impl="kernel", cache_len=None):
    return _mod(cfg).prefill(cfg, params, batch, impl=impl, cache_len=cache_len)


def decode_step(cfg, params, cache, tokens):
    return _mod(cfg).decode_step(cfg, params, cache, tokens)


def cache_spec(cfg, batch, seq_len):
    return _mod(cfg).cache_spec(cfg, batch, seq_len)


def init_cache(cfg, batch, seq_len, device="cuda"):
    """The family's zero decode cache for ``batch`` rows of ``seq_len``
    positions on ``device``."""
    return _mod(cfg).init_cache(cfg, batch, seq_len, resolve_device(device))


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


def n_active_params(cfg) -> int:
    """Active parameters per token (MoE discounts inactive experts)."""
    total = 0
    for name, s in param_specs(cfg).items():
        n = int(np.prod(s.shape))
        if "/experts/" in name and cfg.num_experts:
            n = n * cfg.experts_per_token // cfg.num_experts
        total += n
    return total


def n_param_bytes(cfg) -> int:
    return param_bytes(param_specs(cfg))


# ----------------------------------------------------------- abstract values
def _meta(shape, dtype) -> torch.Tensor:
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def abstract(cfg) -> dict[str, torch.Tensor]:
    """Every parameter as a meta tensor of its shape and dtype."""
    return abstract_params(param_specs(cfg))


def input_specs(cfg, shape) -> dict:
    """Meta tensors for every model input of a shape config, as the
    reference's ``input_specs``: int32 tokens (and labels), an
    encoder-decoder's frames, a decode step's cache."""
    B, S = shape.global_batch, shape.seq_len
    tok = lambda b, s: _meta((b, s), torch.int32)
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": tok(B, S)}
        if shape.kind == "train":
            specs["labels"] = tok(B, S)
        if cfg.is_encdec:
            # modality frontend stub: precomputed frame embeddings
            specs["frames"] = _meta((B, S, cfg.d_model), cfg.dtype)
        return specs
    if shape.kind == "decode":
        shapes, _ = cache_spec(cfg, B, S)
        return {"tokens": tok(B, 1),
                "cache": {n: _meta(sh, dt) for n, (sh, dt) in shapes.items()}}
    raise ValueError(shape.kind)


def input_axes(cfg, shape) -> dict:
    """Logical sharding axes matching ``input_specs``' structure."""
    if shape.kind in ("train", "prefill"):
        axes = {"tokens": ("batch", "seq")}
        if shape.kind == "train":
            axes["labels"] = ("batch", "seq")
        if cfg.is_encdec:
            axes["frames"] = ("batch", "seq", "embed_tp")
        return axes
    _, cache_axes = cache_spec(cfg, shape.global_batch, shape.seq_len)
    return {"tokens": ("batch", None), "cache": cache_axes}

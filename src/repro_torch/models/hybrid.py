"""Zamba2-style hybrid: a Mamba2 backbone and ONE weight-shared attention
block applied before every ``attn_every`` layers [arXiv:2411.15242], the
port of the reference's ``models/hybrid.py``.

The shared block takes concat(x, x_embed0) (2*d), the Zamba trick that
re-injects the initial embedding, runs attention and a SwiGLU MLP at 2*d,
and projects back to d. Every invocation uses the SAME parameters: in
stable-linking terms, ``n_invocations`` uses of one set of provider
symbols. Its attention runs at ``_hd(cfg) = 2*d / heads`` (224 at
zamba2-7b's published widths), never at ``cfg.resolved_head_dim``.

Decode keeps one KV cache per *invocation* (same weights, different
activations), ``k``/``v`` of shape (I, B, S, KV, hd), beside the per-layer
mamba ``conv``/``ssm`` states. As in ``transformer.decode_step``, the
cache is written in place, and ``pos`` is an int or a tuple of ints, one
per batch row (RoPE phase, ring slot and mask per row).
"""

from __future__ import annotations

import torch

from . import mamba2
from .common import (
    apply_rope,
    attention,
    cross_entropy,
    decode_attention,
    host_ints,
    merge_heads,
    mlp,
    cache_device,
    placed_like,
    rms_norm,
    rope_angles,
    split_heads,
)
from .specs import ParamSpec, torch_dtype


def _hd(cfg) -> int:
    return 2 * cfg.d_model // cfg.num_heads  # attention runs at 2*d


def n_invocations(cfg) -> int:
    return (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every


def _groups(cfg):
    """(invocation, first layer, end layer) of each mamba group."""
    g = cfg.attn_every
    return [(i, lo, min(lo + g, cfg.num_layers))
            for i, lo in enumerate(range(0, cfg.num_layers, g))]


# --------------------------------------------------------------------------
def param_specs(cfg) -> dict[str, ParamSpec]:
    d, V, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
    d2 = 2 * d
    hd = _hd(cfg)
    H, KV, ff = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    specs = {"embed/tokens": ParamSpec((V, d), dt, ("vocab", "embed"), "normal")}
    specs.update(mamba2.stacked_specs(cfg))
    specs.update({
        "shared_attn/norm/scale": ParamSpec((d2,), dt, ("embed",), "ones"),
        "shared_attn/wq": ParamSpec((d2, H * hd), dt, ("embed", "heads"), "fan_in"),
        "shared_attn/wk": ParamSpec((d2, KV * hd), dt, ("embed", "kv_heads"), "fan_in"),
        "shared_attn/wv": ParamSpec((d2, KV * hd), dt, ("embed", "kv_heads"), "fan_in"),
        "shared_attn/wo": ParamSpec((H * hd, d2), dt, ("heads", "embed"), "fan_in"),
        "shared_attn/mlp_norm/scale": ParamSpec((d2,), dt, ("embed",), "ones"),
        "shared_attn/mlp/w_gate": ParamSpec((d2, ff), dt, ("embed", "mlp"), "fan_in"),
        "shared_attn/mlp/w_up": ParamSpec((d2, ff), dt, ("embed", "mlp"), "fan_in"),
        "shared_attn/mlp/w_down": ParamSpec((ff, d2), dt, ("mlp", "embed"), "fan_in"),
        "shared_attn/out_proj/w": ParamSpec((d2, d), dt, ("embed", "embed_tp"), "fan_in"),
        "final_norm/scale": ParamSpec((d,), dt, ("embed",), "ones"),
        "lm_head/w": ParamSpec((d, V), dt, ("embed", "vocab"), "fan_in"),
    })
    return specs


# --------------------------------------------------------------------------
def _shared_qkv(cfg, params, x, x0):
    """The shared block's norm over concat(x, x0) and its q/k/v, before
    RoPE: (B,S,H,hd), (B,S,KV,hd), (B,S,KV,hd)."""
    hd = _hd(cfg)
    h = torch.cat([x, x0], -1)                                 # (B,S,2d)
    h = rms_norm(h, params["shared_attn/norm/scale"], cfg.norm_eps)
    q = split_heads(h @ params["shared_attn/wq"], cfg.num_heads, hd)
    k = split_heads(h @ params["shared_attn/wk"], cfg.num_kv_heads, hd)
    v = split_heads(h @ params["shared_attn/wv"], cfg.num_kv_heads, hd)
    return q, k, v


def _shared_out(cfg, params, x, o):
    """The shared block after attention: wo, the MLP at 2*d with its norm,
    and the projection back to d, added to x."""
    a = merge_heads(o) @ params["shared_attn/wo"]
    hm = rms_norm(a, params["shared_attn/mlp_norm/scale"], cfg.norm_eps)
    a = a + mlp(hm, params["shared_attn/mlp/w_gate"], params["shared_attn/mlp/w_up"],
                params["shared_attn/mlp/w_down"])
    return x + a @ params["shared_attn/out_proj/w"]


def _shared_block(cfg, params, x, x0, sin, cos, *, impl, collect_kv=False):
    q, k, v = _shared_qkv(cfg, params, x, x0)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = attention(q, k, v, causal=True, impl=impl)
    out = _shared_out(cfg, params, x, o)
    return (out, (k, v)) if collect_kv else (out, None)


def _mamba_group(cfg, params, x, lo, hi, *, collect_state=False):
    """Mamba layers [lo, hi) of the stacked params, each under the remat
    policy while autograd records; with ``collect_state`` also their
    stacked (conv states, final SSM states)."""
    stacked = mamba2._stacked(params)
    block = mamba2.remat_block(cfg)
    convs, ssms = [], []
    for i in range(lo, hi):
        p = mamba2.layer(stacked, i)
        if collect_state:
            x, final, conv = block(cfg, p, x, return_state=True)
            convs.append(conv)
            ssms.append(final)
        else:
            x = block(cfg, p, x)
    if collect_state:
        return x, (torch.stack(convs), torch.stack(ssms))
    return x, None


def forward(cfg, params, batch, *, impl: str = "kernel"):
    x = mamba2.embed(params, batch["tokens"])
    x0 = x
    S = x.shape[1]
    sin, cos = rope_angles(torch.arange(S, device=x.device), _hd(cfg), cfg.rope_theta)
    for _, lo, hi in _groups(cfg):
        x, _ = _shared_block(cfg, params, x, x0, sin, cos, impl=impl)
        x, _ = _mamba_group(cfg, params, x, lo, hi)
    return mamba2.logits_fn(cfg, params, x), torch.zeros((), dtype=torch.float32,
                                                         device=x.device)


def loss_fn(cfg, params, batch, *, impl: str = "chunked", aux_coef=0.0):
    """Mean next-token cross entropy (no aux loss, as in the reference)."""
    logits, _ = forward(cfg, params, batch, impl=impl)
    return cross_entropy(logits, batch["labels"])


# ------------------------------------------------------------------ decode
def cache_spec(cfg, batch: int, seq_len: int):
    """mamba2's cache spec plus ``k``/``v`` (I, B, seq_len, KV, hd)."""
    shapes, axes = mamba2.cache_spec(cfg, batch, seq_len)
    kv = ((n_invocations(cfg), batch, seq_len, cfg.num_kv_heads, _hd(cfg)), cfg.dtype)
    kv_axes = ("stack", "batch", "cache_seq", "kv_heads", "head_dim")
    return {**shapes, "k": kv, "v": kv}, {**axes, "k": kv_axes, "v": kv_axes}


def init_cache(cfg, batch: int, seq_len: int, device) -> dict:
    shapes, _ = cache_spec(cfg, batch, seq_len)
    cache = {n: torch.zeros(shape, dtype=torch_dtype(dt), device=device)
             for n, (shape, dt) in shapes.items() if n != "pos"}
    cache["pos"] = 0
    return cache


def prefill(cfg, params, batch, *, impl: str = "kernel", cache_len=None):
    """Process a prompt; returns (last-position logits (B,1,V), cache): one
    KV cache per invocation, zero past the prompt up to ``cache_len`` rows
    (the prompt's length when that is larger), and every layer's states."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = mamba2.embed(params, tokens)
    x0 = x
    sin, cos = rope_angles(torch.arange(S, device=x.device), _hd(cfg), cfg.rope_theta)
    cache = placed_like(init_cache(cfg, B, max(cache_len or S, S), cache_device(x)), x,
                        cache_spec(cfg, B, S)[1])
    for i, lo, hi in _groups(cfg):
        x, (k, v) = _shared_block(cfg, params, x, x0, sin, cos, impl=impl,
                                  collect_kv=True)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        x, (conv, ssm) = _mamba_group(cfg, params, x, lo, hi, collect_state=True)
        cache["conv"][lo:hi] = conv
        cache["ssm"][lo:hi] = ssm
    cache["pos"] = S - 1
    return mamba2.logits_fn(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) + cache -> (logits (B,1,V), cache').

    Each invocation writes its new key and value at ``pos % S`` (a ring once
    the cache is full) and attends to every row up to ``pos``; ``x0`` is
    the current token's embedding. ``cache["pos"]`` may hold one position
    per row, as in ``transformer.decode_step``."""
    B = tokens.shape[0]
    hd = _hd(cfg)
    S = cache["k"].shape[2]
    x = mamba2.embed(params, tokens)
    x0 = x
    pos = mamba2.next_pos(cache["pos"])          # the position being written
    if isinstance(pos, tuple):
        if len(pos) != B:
            raise ValueError(f"{len(pos)} positions for {B} rows")
        at = host_ints(pos, x.device)
        slot = (torch.arange(B, device=x.device), host_ints([p % S for p in pos], x.device))
        sin, cos = rope_angles(at[:, None], hd, cfg.rope_theta)
    else:
        at = pos
        slot = (slice(None), pos % S)
        sin, cos = rope_angles(host_ints([pos], x.device), hd, cfg.rope_theta)
    stacked = mamba2._stacked(params)
    for i, lo, hi in _groups(cfg):
        q, k_new, v_new = _shared_qkv(cfg, params, x, x0)
        q = apply_rope(q, sin, cos)
        k_new = apply_rope(k_new, sin, cos)
        k_c, v_c = cache["k"][i], cache["v"][i]
        k_c[slot] = k_new[:, 0]
        v_c[slot] = v_new[:, 0]
        x = _shared_out(cfg, params, x, decode_attention(q, k_c, v_c, at))
        x = mamba2.decode_layers(cfg, stacked, cache, x, lo, hi)
    new_cache = dict(cache)
    new_cache["pos"] = pos
    return mamba2.logits_fn(cfg, params, x), new_cache

"""Dense transformer — the port of the reference's ``models/transformer.py``
for the dense family (GQA / MQA, QKV bias, qk-norm, sliding window with a
local:global pattern, tied embeddings, LayerNorm + bias + gelu).

Params are a flat ``{symbol_name: tensor}`` dict (the stable-linking symbol
space); stacked-layer params carry a leading L axis and the stack runs as a
plain Python loop over layers. ``param_specs`` covers every family the
reference declares (it is pure data and equals the reference's exactly);
the MoE and encoder-decoder forward paths raise ``NotImplementedError``.

Departures from the reference that do not change results:

* the reference's sharding hints (``constrain``) are no-ops on one device
  and are dropped;
* ``decode_step`` updates the KV cache IN PLACE (the reference returns a
  new cache); the returned dict holds the same, updated tensors;
* the cache's ``pos`` is a Python int, so decode never waits on the device
  to read it.
"""

from __future__ import annotations

import torch

from .common import (
    apply_rope,
    attention,
    decode_attention,
    layer_norm,
    mlp,
    rms_norm,
    rope_angles,
)
from .specs import ParamSpec, torch_dtype

_MOE_TODO = "MoE layers are not ported yet (ROADMAP Queue A item 8)"
_ENCDEC_TODO = "encoder-decoder models are not ported yet (ROADMAP Queue A item 9)"

# --------------------------------------------------------------------------
# Parameter specs (symbol manifest)
# --------------------------------------------------------------------------


def _norm_specs(name: str, dim: int, cfg, axes=("embed",)) -> dict[str, ParamSpec]:
    d = {f"{name}/scale": ParamSpec((dim,), cfg.dtype, axes, "ones")}
    if cfg.use_bias:
        d[f"{name}/bias"] = ParamSpec((dim,), cfg.dtype, axes, "zeros")
    return d


def _attn_specs(cfg, d_in: int, d_out: int) -> dict[str, ParamSpec]:
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.dtype
    s = {
        "attn/wq": ParamSpec((d_in, H * hd), dt, ("embed", "heads"), "fan_in"),
        "attn/wk": ParamSpec((d_in, KV * hd), dt, ("embed", "kv_heads"), "fan_in"),
        "attn/wv": ParamSpec((d_in, KV * hd), dt, ("embed", "kv_heads"), "fan_in"),
        "attn/wo": ParamSpec((H * hd, d_out), dt, ("heads", "embed"), "fan_in"),
    }
    if cfg.qkv_bias:
        s["attn/bq"] = ParamSpec((H * hd,), dt, ("heads",), "zeros")
        s["attn/bk"] = ParamSpec((KV * hd,), dt, ("kv_heads",), "zeros")
        s["attn/bv"] = ParamSpec((KV * hd,), dt, ("kv_heads",), "zeros")
    if cfg.use_bias:
        s["attn/bo"] = ParamSpec((d_out,), dt, ("embed",), "zeros")
    if cfg.qk_norm:
        s["attn/q_norm"] = ParamSpec((hd,), dt, ("head_dim",), "ones")
        s["attn/k_norm"] = ParamSpec((hd,), dt, ("head_dim",), "ones")
    return s


def _mlp_specs(cfg, d: int) -> dict[str, ParamSpec]:
    dt, ff = cfg.dtype, cfg.d_ff
    if cfg.is_moe:
        E = cfg.num_experts
        s = {
            "router/w": ParamSpec((d, E), dt, ("embed", "experts"), "fan_in"),
            "experts/w_gate": ParamSpec(
                (E, d, ff), dt, ("experts", "embed", "mlp"), "fan_in"
            ),
            "experts/w_up": ParamSpec(
                (E, d, ff), dt, ("experts", "embed", "mlp"), "fan_in"
            ),
            "experts/w_down": ParamSpec(
                (E, ff, d), dt, ("experts", "mlp", "embed"), "fan_in"
            ),
        }
        if cfg.num_shared_experts:
            sf = cfg.num_shared_experts * ff
            s["shared/w_gate"] = ParamSpec((d, sf), dt, ("embed", "mlp"), "fan_in")
            s["shared/w_up"] = ParamSpec((d, sf), dt, ("embed", "mlp"), "fan_in")
            s["shared/w_down"] = ParamSpec((sf, d), dt, ("mlp", "embed"), "fan_in")
            s["shared/gate"] = ParamSpec((d, 1), dt, ("embed", None), "fan_in")
        return s
    s = {
        "mlp/w_up": ParamSpec((d, ff), dt, ("embed", "mlp"), "fan_in"),
        "mlp/w_down": ParamSpec((ff, d), dt, ("mlp", "embed"), "fan_in"),
    }
    if cfg.act == "silu":
        s["mlp/w_gate"] = ParamSpec((d, ff), dt, ("embed", "mlp"), "fan_in")
    if cfg.use_bias:
        s["mlp/b_up"] = ParamSpec((ff,), dt, ("mlp",), "zeros")
        s["mlp/b_down"] = ParamSpec((d,), dt, ("embed",), "zeros")
    return s


def _block_specs(cfg, *, cross: bool = False) -> dict[str, ParamSpec]:
    d = cfg.d_model
    s: dict[str, ParamSpec] = {}
    s.update(_norm_specs("attn_norm", d, cfg))
    s.update(_attn_specs(cfg, d, d))
    if cross:
        s.update(_norm_specs("xattn_norm", d, cfg))
        s.update({f"x{k}": v for k, v in _attn_specs(cfg, d, d).items()})
    s.update(_norm_specs("mlp_norm", d, cfg))
    s.update(_mlp_specs(cfg, d))
    return s


def _stack(prefix: str, L: int, template: dict[str, ParamSpec]):
    return {
        f"{prefix}/{n}": ParamSpec(
            (L,) + t.shape, t.dtype, ("layers",) + t.axes, t.init
        )
        for n, t in template.items()
    }


def param_specs(cfg) -> dict[str, ParamSpec]:
    d, V, dt = cfg.d_model, cfg.vocab_size, cfg.dtype
    specs: dict[str, ParamSpec] = {
        "embed/tokens": ParamSpec((V, d), dt, ("vocab", "embed"), "normal"),
    }
    if cfg.frontend == "audio_frames":
        specs["frontend/proj"] = ParamSpec(
            (d, d), dt, ("embed", "embed_tp"), "fan_in"
        )
    if cfg.is_encdec:
        specs.update(_stack("enc", cfg.encoder_layers, _block_specs(cfg)))
        specs.update(_norm_specs("enc_final_norm", d, cfg))
        specs.update(_stack("dec", cfg.num_layers, _block_specs(cfg, cross=True)))
    else:
        specs.update(_stack("blocks", cfg.num_layers, _block_specs(cfg)))
    specs.update(_norm_specs("final_norm", d, cfg))
    if not cfg.tie_embeddings:
        specs["lm_head/w"] = ParamSpec((d, V), dt, ("embed", "vocab"), "fan_in")
    return specs


# --------------------------------------------------------------------------
# Block application
# --------------------------------------------------------------------------


def _check_dense(cfg):
    if cfg.is_moe:
        raise NotImplementedError(_MOE_TODO)
    if cfg.is_encdec:
        raise NotImplementedError(_ENCDEC_TODO)


def _norm(p, name, x, cfg):
    if cfg.use_bias:
        return layer_norm(x, p[f"{name}/scale"], p[f"{name}/bias"], cfg.norm_eps)
    return rms_norm(x, p[f"{name}/scale"], cfg.norm_eps)


def _project_qkv(cfg, p, x):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = x @ p["attn/wq"]
    k = x @ p["attn/wk"]
    v = x @ p["attn/wv"]
    if cfg.qkv_bias:
        q = q + p["attn/bq"]
        k = k + p["attn/bk"]
        v = v + p["attn/bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["attn/q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["attn/k_norm"], cfg.norm_eps)
    return q, k, v


def _self_attention(cfg, p, x, sin, cos, *, window, impl):
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = attention(q, k, v, causal=True, window=window, impl=impl)
    o = o.reshape(B, S, -1) @ p["attn/wo"]
    if cfg.use_bias:
        o = o + p["attn/bo"]
    return o, k, v


def _mlp(cfg, p, x):
    return mlp(
        x,
        p.get("mlp/w_gate"),
        p["mlp/w_up"],
        p["mlp/w_down"],
        act=cfg.act,
        b_up=p.get("mlp/b_up"),
        b_down=p.get("mlp/b_down"),
    )


def _block(cfg, p, x, sin, cos, *, window, impl):
    h = _norm(p, "attn_norm", x, cfg)
    o, k, v = _self_attention(cfg, p, h, sin, cos, window=window, impl=impl)
    x = x + o
    h = _norm(p, "mlp_norm", x, cfg)
    return x + _mlp(cfg, p, h), k, v


def _stacked_params(params: dict, prefix: str) -> dict:
    plen = len(prefix) + 1
    return {n[plen:]: a for n, a in params.items() if n.startswith(prefix + "/")}


def _layer_windows(cfg) -> list[int]:
    """Per-layer attention windows; 0 = full/global."""
    L = cfg.num_layers
    if cfg.sliding_window <= 0:
        return [0] * L
    g = cfg.global_every
    return [0 if (g and (i + 1) % g == 0) else cfg.sliding_window
            for i in range(L)]


def run_stack(cfg, params, prefix, x, sin, cos, *, impl, on_kv=None):
    """Run the layer stack as a plain loop, layer i with its own window.

    ``on_kv(i, k, v)``, when given, receives each layer's keys and values
    (prefill writes them into the cache)."""
    stacked = _stacked_params(params, prefix)
    for i, window in enumerate(_layer_windows(cfg)):
        p_i = {n: a[i] for n, a in stacked.items()}
        x, k, v = _block(cfg, p_i, x, sin, cos, window=window, impl=impl)
        if on_kv is not None:
            on_kv(i, k, v)
    return x


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def logits_fn(cfg, params, x):
    x = _norm(params, "final_norm", x, cfg)
    if cfg.tie_embeddings:
        return x @ params["embed/tokens"].T
    return x @ params["lm_head/w"]


def _embed(params, tokens):
    return params["embed/tokens"][tokens.long()]


def forward(cfg, params, batch, *, impl: str = "kernel"):
    """Full-sequence forward -> (logits (B, S, V), aux). Batch keys: tokens."""
    _check_dense(cfg)
    x = _embed(params, batch["tokens"])
    S = x.shape[1]
    sin, cos = rope_angles(torch.arange(S, device=x.device), cfg.resolved_head_dim,
                           cfg.rope_theta)
    x = run_stack(cfg, params, "blocks", x, sin, cos, impl=impl)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits_fn(cfg, params, x), aux


def init_cache(cfg, batch: int, seq_len: int, device):
    """Zero cache: ``k``/``v`` of shape (L, B, seq_len, KV, hd), ``pos`` 0."""
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dt = torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": 0,
    }


def prefill(cfg, params, batch, *, impl: str = "kernel", cache_len=None):
    """Process a prompt; returns (last-position logits (B,1,V), cache).

    The cache holds ``k``/``v`` of shape (L, B, cache_len, KV, hd), zero
    past the prompt, and ``pos = S - 1``."""
    _check_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = init_cache(cfg, B, cache_len or S, tokens.device)
    x = _embed(params, tokens)
    sin, cos = rope_angles(torch.arange(S, device=x.device), cfg.resolved_head_dim,
                           cfg.rope_theta)

    def on_kv(i, k, v):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v

    x = run_stack(cfg, params, "blocks", x, sin, cos, impl=impl, on_kv=on_kv)
    cache["pos"] = S - 1
    return logits_fn(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) + cache -> (logits (B,1,V), cache').

    Writes the new keys and values into ``cache`` in place, at
    ``pos % S`` (a ring once the cache is full); a windowed layer attends
    to the ``window`` entries ending at ``pos`` when ``window < S``."""
    _check_dense(cfg)
    B = tokens.shape[0]
    hd = cfg.resolved_head_dim
    pos = cache["pos"] + 1  # position being written
    x = _embed(params, tokens)
    sin, cos = rope_angles(torch.tensor([pos], device=x.device), hd, cfg.rope_theta)
    stacked = _stacked_params(params, "blocks")
    S = cache["k"].shape[2]
    slot = pos % S

    for i, window in enumerate(_layer_windows(cfg)):
        p = {n: a[i] for n, a in stacked.items()}
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = _norm(p, "attn_norm", x, cfg)
        q, k_new, v_new = _project_qkv(cfg, p, h)
        q = apply_rope(q, sin, cos)
        k_new = apply_rope(k_new, sin, cos)
        k_c[:, slot] = k_new[:, 0]
        v_c[:, slot] = v_new[:, 0]
        if window and window < S:
            start = min(max(pos - window + 1, 0), S - window)
            o = decode_attention(q, k_c[:, start:start + window],
                                 v_c[:, start:start + window], pos - start)
        else:
            o = decode_attention(q, k_c, v_c, pos)
        o = o.reshape(B, 1, -1) @ p["attn/wo"]
        if cfg.use_bias:
            o = o + p["attn/bo"]
        x = x + o
        h = _norm(p, "mlp_norm", x, cfg)
        x = x + _mlp(cfg, p, h)

    logits = logits_fn(cfg, params, x)
    new_cache = dict(cache)
    new_cache["pos"] = pos
    return logits, new_cache

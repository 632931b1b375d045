"""Transformer zoo — the port of the reference's ``models/transformer.py``:
dense (GQA / MQA, QKV bias, qk-norm, sliding window with a local:global
pattern, tied embeddings, LayerNorm + bias + gelu), MoE (``models/moe.py``)
and encoder-decoder (an encoder over stubbed frame embeddings, then a
decoder with cross-attention), one implementation, flag-driven.

Params are a flat ``{symbol_name: tensor}`` dict (the stable-linking symbol
space); stacked-layer params carry a leading L axis and each stack runs as
a plain Python loop over layers. ``param_specs`` equals the reference's
exactly.

Departures from the reference that do not change results:

* the reference's sharding hints (``constrain``) stand at its points:
  identity outside a ``dist.context.mesh_rules`` context, a DTensor
  redistribution inside one (``launch/steps.py::build_step``);
* ``decode_step`` updates the KV cache IN PLACE (the reference returns a
  new cache); the returned dict holds the same, updated tensors;
* the cache's ``pos`` is a Python int, so decode never waits on the device
  to read it — or a tuple of ints, one per batch row: the batched form of
  the reference's slot scheduler, which vmaps a B=1 ``decode_step`` over
  slots that each carry their own scalar ``pos``;
* an encoder-decoder cache may carry ``xpos``, the last valid row of each
  batch row's cross K/V (an int or a tuple of ints): the scheduler pads
  every slot's ``xk``/``xv`` to one length and masks past ``xpos``, where
  the reference sizes them to the prompt (ROADMAP Queue C). Without it,
  every row of ``xk`` is valid, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.dist.context import constrain

from . import moe
from .common import (
    apply_rope,
    attention,
    cross_entropy,
    decode_attention,
    host_ints,
    layer_norm,
    merge_heads,
    mlp,
    cache_device,
    placed_like,
    rms_norm,
    rope_angles,
    split_heads,
)
from .runtime import remat_wrap
from .specs import ParamSpec, torch_dtype

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


def _norm(p, name, x, cfg):
    if cfg.use_bias:
        return layer_norm(x, p[f"{name}/scale"], p[f"{name}/bias"], cfg.norm_eps)
    return rms_norm(x, p[f"{name}/scale"], cfg.norm_eps)


def _project_qkv(cfg, p, x):
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    q = x @ p["attn/wq"]
    k = x @ p["attn/wk"]
    v = x @ p["attn/wv"]
    if cfg.qkv_bias:
        q = q + p["attn/bq"]
        k = k + p["attn/bk"]
        v = v + p["attn/bv"]
    q = split_heads(q, H, hd)
    k = split_heads(k, KV, hd)
    v = split_heads(v, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["attn/q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["attn/k_norm"], cfg.norm_eps)
    return q, k, v


def _self_attention(cfg, p, x, sin, cos, *, window, impl):
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    o = attention(q, k, v, causal=True, window=window, impl=impl)
    o = merge_heads(o) @ p["attn/wo"]
    if cfg.use_bias:
        o = o + p["attn/bo"]
    return o, k, v


def _mlp_or_moe(cfg, p, x):
    """Returns (out, aux loss); the aux loss is None for a dense MLP."""
    if cfg.is_moe:
        out, aux = moe.moe_block(
            x, p["router/w"], p["experts/w_gate"], p["experts/w_up"],
            p["experts/w_down"], k=cfg.experts_per_token,
            capacity_factor=cfg.capacity_factor,
        )
        if cfg.num_shared_experts:
            out = out + moe.shared_expert(
                x, p["shared/w_gate"], p["shared/w_up"], p["shared/w_down"],
                p["shared/gate"],
            )
        return out, aux
    return mlp(
        x,
        p.get("mlp/w_gate"),
        p["mlp/w_up"],
        p["mlp/w_down"],
        act=cfg.act,
        b_up=p.get("mlp/b_up"),
        b_down=p.get("mlp/b_down"),
    ), None


def _cross_kv(cfg, p, enc_out):
    """The decoder layer's cross-attention keys and values over the
    encoder's output: (B, S_enc, KV, hd) each; no RoPE, norm or bias."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return (split_heads(enc_out @ p["xattn/wk"], KV, hd),
            split_heads(enc_out @ p["xattn/wv"], KV, hd))


def _cross_query(cfg, p, x):
    h = _norm(p, "xattn_norm", x, cfg)
    return split_heads(h @ p["xattn/wq"], cfg.num_heads, cfg.resolved_head_dim)


def _gather_weights(cfg, p, *, cross=False):
    """FSDP weight unsharding at use-site: drop the `embed`(->data) axis
    from each block weight's placement, one all-gather per weight per use
    instead of a reduction of every activation product over the sharded
    contraction dim (the reference's choice)."""
    tmpl = _block_specs(cfg, cross=cross)
    out = {}
    for n, a in p.items():
        spec = tmpl.get(n)
        if spec is None:
            out[n] = a
            continue
        axes = tuple(None if ax in ("embed",) else ax for ax in spec.axes)
        out[n] = constrain(a, axes)
    return out


def _block(cfg, p, x, sin, cos, *, window, impl, enc_out=None):
    """One layer -> (x, aux or None, kv): kv is (k, v), and for a decoder
    layer of an encoder-decoder (``enc_out`` given) (k, v, xk, xv)."""
    x = constrain(x, ("batch", "seq", None))  # keep activations DP-sharded
    p = _gather_weights(cfg, p, cross=enc_out is not None)
    h = _norm(p, "attn_norm", x, cfg)
    o, k, v = _self_attention(cfg, p, h, sin, cos, window=window, impl=impl)
    x = x + o
    kv = (k, v)
    if enc_out is not None:           # cross attention, never causal
        xk, xv = _cross_kv(cfg, p, enc_out)
        o = attention(_cross_query(cfg, p, x), xk, xv, causal=False, impl=impl)
        x = x + merge_heads(o) @ p["xattn/wo"]
        kv += (xk, xv)
    h = _norm(p, "mlp_norm", x, cfg)
    m, aux = _mlp_or_moe(cfg, p, h)
    return x + m, aux, kv


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


def run_stack(cfg, params, prefix, x, sin, cos, *, impl, enc_out=None,
              on_kv=None):
    """Run a layer stack as a plain loop, layer i with its own window (the
    encoder's ``enc`` stack: full causal attention in every layer).
    Returns (x, summed aux loss, a float32 scalar tensor). While autograd
    records, each layer runs under the config's remat policy
    (``runtime.remat_wrap``), as the reference's stack does.

    ``on_kv(i, *kv)``, when given, receives each layer's keys and values
    (and a decoder layer's cross keys and values); prefill writes them into
    the cache."""
    stacked = _stacked_params(params, prefix)
    windows = [0] * cfg.encoder_layers if prefix == "enc" else _layer_windows(cfg)
    block = remat_wrap(_block, cfg) if torch.is_grad_enabled() else _block
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, window in enumerate(windows):
        p_i = {n: a[i] for n, a in stacked.items()}
        x, aux_i, kv = block(cfg, p_i, x, sin, cos, window=window, impl=impl,
                             enc_out=enc_out)
        if aux_i is not None:
            aux = aux + aux_i
        if on_kv is not None:
            on_kv(i, *kv)
    return x, aux


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def logits_fn(cfg, params, x):
    x = _norm(params, "final_norm", x, cfg)
    logits = (
        x @ params["embed/tokens"].T
        if cfg.tie_embeddings
        else x @ params["lm_head/w"]
    )
    return constrain(logits, ("batch", "seq", "vocab"))


def _embed(params, tokens):
    return params["embed/tokens"][tokens.long()]


def _encode(cfg, params, frames, impl):
    """Encoder over precomputed frame embeddings (the modality stub):
    ``frontend/proj``, the ``enc`` stack, ``enc_final_norm``. Its
    self-attention is causal, as the reference's."""
    x = frames.to(torch_dtype(cfg.dtype))
    if "frontend/proj" in params:
        x = x @ params["frontend/proj"]
    sin, cos = rope_angles(torch.arange(x.shape[1], device=x.device),
                           cfg.resolved_head_dim, cfg.rope_theta)
    x, _ = run_stack(cfg, params, "enc", x, sin, cos, impl=impl)
    return _norm(params, "enc_final_norm", x, cfg)


def _stack_prefix(cfg) -> str:
    return "dec" if cfg.is_encdec else "blocks"


def forward(cfg, params, batch, *, impl: str = "kernel"):
    """Full-sequence forward -> (logits (B, S, V), aux loss). Batch keys:
    tokens (B, S), and frames (B, S_enc, d) for an encoder-decoder."""
    x = _embed(params, batch["tokens"])
    S = x.shape[1]
    sin, cos = rope_angles(torch.arange(S, device=x.device), cfg.resolved_head_dim,
                           cfg.rope_theta)
    enc_out = _encode(cfg, params, batch["frames"], impl) if cfg.is_encdec else None
    x, aux = run_stack(cfg, params, _stack_prefix(cfg), x, sin, cos, impl=impl,
                       enc_out=enc_out)
    return logits_fn(cfg, params, x), aux


def loss_fn(cfg, params, batch, *, impl: str = "chunked", aux_coef=0.01):
    """Mean next-token cross entropy plus ``aux_coef`` x the MoE aux loss
    (0 for a dense model). Batch keys: tokens, labels (B, S), and frames
    for an encoder-decoder. Trains with ``impl="chunked"``: the flash
    kernel is forward-only."""
    logits, aux = forward(cfg, params, batch, impl=impl)
    return cross_entropy(logits, batch["labels"]) + aux_coef * aux


def cache_spec(cfg, batch: int, seq_len: int):
    """({name: (shape, dtype name)}, {name: logical axes}) of the decode
    cache, as the reference's ``cache_spec``: ``k``/``v`` (L, B, seq_len,
    KV, hd), a 0-d int32 ``pos``, and an encoder-decoder's ``xk``/``xv``."""
    kv = ((cfg.num_layers, batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim),
          cfg.dtype)
    kv_axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    shapes = {"k": kv, "v": kv, "pos": ((), "int32")}
    axes = {"k": kv_axes, "v": kv_axes, "pos": ()}
    if cfg.is_encdec:
        shapes.update({"xk": kv, "xv": kv})
        axes.update({"xk": kv_axes, "xv": kv_axes})
    return shapes, axes


def init_cache(cfg, batch: int, seq_len: int, device, *, cross_len=None):
    """Zero cache: ``k``/``v`` of shape (L, B, seq_len, KV, hd), ``pos`` 0;
    an encoder-decoder's also holds cross ``xk``/``xv`` of
    ``cross_len or seq_len`` rows."""
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(cfg.dtype)
    cache = {n: torch.zeros((L, batch, seq_len, KV, hd), dtype=dt, device=device)
             for n in ("k", "v")}
    if cfg.is_encdec:
        for n in ("xk", "xv"):
            cache[n] = torch.zeros((L, batch, cross_len or seq_len, KV, hd),
                                   dtype=dt, device=device)
    cache["pos"] = 0
    return cache


def prefill(cfg, params, batch, *, impl: str = "kernel", cache_len=None):
    """Process a prompt; returns (last-position logits (B,1,V), cache).

    The cache holds ``k``/``v`` of shape (L, B, cache_len, KV, hd), zero
    past the prompt, and ``pos = S - 1``; an encoder-decoder's also holds
    the cross keys and values ``xk``/``xv`` (L, B, S_enc, KV, hd), computed
    once here and read by every decode step."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, tokens)
    sin, cos = rope_angles(torch.arange(S, device=x.device), cfg.resolved_head_dim,
                           cfg.rope_theta)
    enc_out = _encode(cfg, params, batch["frames"], impl) if cfg.is_encdec else None
    cache = placed_like(init_cache(cfg, B, cache_len or S, cache_device(x),
                                   cross_len=enc_out.shape[1] if cfg.is_encdec else None),
                        x, cache_spec(cfg, B, S)[1])

    def on_kv(i, k, v, *xkv):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
        if xkv:
            cache["xk"][i], cache["xv"][i] = xkv

    x, _ = run_stack(cfg, params, _stack_prefix(cfg), x, sin, cos, impl=impl,
                     enc_out=enc_out, on_kv=on_kv)
    cache["pos"] = S - 1
    return logits_fn(cfg, params, x[:, -1:, :]), cache


def _row_windows(cfg, pos, S, device):
    """Per-row decode geometry for a tuple of positions being written:
    {"pos": (B,), "slot": (B,) ring index, window: ((B, w) cache rows of the
    window, (B,) position inside it)} — the reference's clipped window
    ``start_b = clip(pos_b - w + 1, 0, S - w)`` per row."""
    geo = {"pos": host_ints(pos, device),
           "slot": host_ints([p % S for p in pos], device)}
    for w in set(_layer_windows(cfg)):
        if w and w < S:
            start = [min(max(p - w + 1, 0), S - w) for p in pos]
            rows = host_ints(start, device)[:, None] + torch.arange(w, device=device)
            geo[w] = (rows, host_ints([p - s for p, s in zip(pos, start)], device))
    return geo


def decode_step(cfg, params, cache, tokens):
    """One decode step: tokens (B,1) + cache -> (logits (B,1,V), cache').

    Writes the new keys and values into ``cache`` in place, at
    ``pos % S`` (a ring once the cache is full); a windowed layer attends
    to the ``window`` entries ending at ``pos`` when ``window < S``.
    ``cache["pos"]`` is an int, or a tuple of B ints: then every row uses
    its own position (RoPE phase, ring slot, window, mask), exactly as a
    B=1 call on that row would. An encoder-decoder's layers then attend
    to the cross ``xk``/``xv`` up to ``cache["xpos"]`` (an int, or B ints),
    or to all of it when the cache has no ``xpos``."""
    B = tokens.shape[0]
    hd = cfg.resolved_head_dim
    x = _embed(params, tokens)
    stacked = _stacked_params(params, _stack_prefix(cfg))
    S = cache["k"].shape[2]
    per_row = isinstance(cache["pos"], (tuple, list))
    if per_row:
        if len(cache["pos"]) != B:
            raise ValueError(f"{len(cache['pos'])} positions for {B} rows")
        pos = tuple(int(p) + 1 for p in cache["pos"])  # positions being written
        geo = _row_windows(cfg, pos, S, x.device)
        sin, cos = rope_angles(geo["pos"][:, None], hd, cfg.rope_theta)
        rows = torch.arange(B, device=x.device)
    else:
        pos = cache["pos"] + 1  # position being written
        sin, cos = rope_angles(host_ints([pos], x.device), hd, cfg.rope_theta)
        slot = pos % S
    if cfg.is_encdec:
        xpos = cache.get("xpos", cache["xk"].shape[2] - 1)
        if isinstance(xpos, (tuple, list)):
            xpos = host_ints(xpos, x.device)

    for i, window in enumerate(_layer_windows(cfg)):
        p = {n: a[i] for n, a in stacked.items()}
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = _norm(p, "attn_norm", x, cfg)
        q, k_new, v_new = _project_qkv(cfg, p, h)
        q = apply_rope(q, sin, cos)
        k_new = apply_rope(k_new, sin, cos)
        if per_row:
            k_c[rows, geo["slot"]] = k_new[:, 0]
            v_c[rows, geo["slot"]] = v_new[:, 0]
            if window and window < S:
                win, at = geo[window]
                o = decode_attention(q, k_c[rows[:, None], win],
                                     v_c[rows[:, None], win], at)
            else:
                o = decode_attention(q, k_c, v_c, geo["pos"])
        else:
            k_c[:, slot] = k_new[:, 0]
            v_c[:, slot] = v_new[:, 0]
            if window and window < S:
                start = min(max(pos - window + 1, 0), S - window)
                o = decode_attention(q, k_c[:, start:start + window],
                                     v_c[:, start:start + window], pos - start)
            else:
                o = decode_attention(q, k_c, v_c, pos)
        o = merge_heads(o) @ p["attn/wo"]
        if cfg.use_bias:
            o = o + p["attn/bo"]
        x = x + o
        if cfg.is_encdec:
            o = decode_attention(_cross_query(cfg, p, x), cache["xk"][i],
                                 cache["xv"][i], xpos)
            x = x + merge_heads(o) @ p["xattn/wo"]
        h = _norm(p, "mlp_norm", x, cfg)
        x = x + _mlp_or_moe(cfg, p, h)[0]

    logits = logits_fn(cfg, params, x)
    new_cache = dict(cache)
    new_cache["pos"] = pos
    return logits, new_cache

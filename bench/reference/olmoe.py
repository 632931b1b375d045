"""OLMoE (arXiv:2409.02060) as the benchmark's configuration states it, in
plain PyTorch and float32.

Per layer: RMSNorm, Q/K/V projections, RMSNorm of each head of Q and K,
rotary phases (halves, not interleaved), causal softmax attention, the
output projection and the residual; RMSNorm, a softmax router over the
experts, the top-k experts per token (highest probability first, the lower
index first among equals), their probabilities renormalised to sum to 1
(``norm_topk_prob``), SwiGLU experts, the residual. A final RMSNorm and the
output projection.

Expert capacity (``capacity_factor``, GShard): the prompt is one routing
group, as the served prefill routes it; each expert takes at most
``ceil(k * P / E * capacity_factor)`` of the group's routed slots, counted
token by token and, within a token, best pick first; a slot past that adds
nothing. Each later token is a group of its own (one decode step routes one
token per sequence), so none of its slots is dropped.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import roofline
from .precision import mm, no_tf32, rms_norm


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) rotated by position; halves, float32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs                  # (S, half)
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v):
    """(S, H, hd) x (S, KV, hd) -> (S, H, hd), float32 softmax."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * hd**-0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)


def kept_slots(top_e: torch.Tensor, prompt_len: int, E: int, cf: float) -> torch.Tensor:
    """(S, k) bool: which routed slots an expert takes under its capacity."""
    S, k = top_e.shape
    keep = torch.ones_like(top_e, dtype=torch.bool)
    if prompt_len and cf:
        cap = min(max(1, math.ceil(k * prompt_len / E * cf)), prompt_len * k)
        flat = top_e[:prompt_len].reshape(-1)
        onehot = F.one_hot(flat, E)
        place = (onehot.cumsum(0) * onehot).sum(-1) - 1        # earlier slots, same expert
        keep[:prompt_len] = (place < cap).view(prompt_len, k)
    return keep


def moe(h, p, conf, prompt_len, prec):
    E, k = conf["num_experts"], conf["num_experts_per_tok"]
    probs = torch.softmax(mm(h, p("router/w"), prec), -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    if conf["norm_topk_prob"]:
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    keep = kept_slots(top_e, prompt_len, E, conf["capacity_factor"])
    wg, wu, wd = p("experts/w_gate"), p("experts/w_up"), p("experts/w_down")
    out = torch.zeros_like(h)
    for e in range(E):
        tok, rank = torch.nonzero((top_e == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        ye = mm(F.silu(mm(xe, wg[e], prec)) * mm(xe, wu[e], prec), wd[e], prec)
        out.index_add_(0, tok, ye * top_p[tok, rank, None])
    return out


def logits(w, conf, tokens, prompt_len, prec="f32"):
    no_tf32()
    L, H, KV = conf["num_hidden_layers"], conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, eps, theta = conf["head_dim"], conf["rms_norm_eps"], conf["rope_theta"]
    S = tokens.shape[0]
    positions = torch.arange(S, device=tokens.device)
    x = w["embed/tokens"][tokens.long()].float()
    for i in range(L):
        def p(name, i=i):
            return w[f"blocks/{name}"][i].float()
        h = rms_norm(x, p("attn_norm/scale"), eps)
        q = mm(h, p("attn/wq"), prec).view(S, H, hd)
        k = mm(h, p("attn/wk"), prec).view(S, KV, hd)
        v = mm(h, p("attn/wv"), prec).view(S, KV, hd)
        q = rope(rms_norm(q, p("attn/q_norm"), eps), positions, theta)
        k = rope(rms_norm(k, p("attn/k_norm"), eps), positions, theta)
        o = causal_attention(q, k, v).reshape(S, H * hd)
        x = x + mm(o, p("attn/wo"), prec)
        h = rms_norm(x, p("mlp_norm/scale"), eps)
        x = x + moe(h, p, conf, prompt_len, prec)
    x = rms_norm(x, w["final_norm/scale"], eps)
    return mm(x, w["lm_head/w"], prec)


# ------------------------------------------------- operations and bytes
# Counted by the rules of ``bench/roofline.py``, which finds these by the
# configuration's ``reference``.
def _attn_params(c) -> int:
    d, H, KV, hd = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    return d * (H + 2 * KV) * hd + H * hd * d


def _ffn(c, tokens: int) -> tuple[float, float]:
    """(operations, weight bytes) of one layer's MoE over ``tokens`` tokens."""
    d, E, k, ff = c["hidden_size"], c["num_experts"], c["num_experts_per_tok"], c["intermediate_size"]
    flops = 2 * tokens * d * E + 2 * tokens * k * 3 * d * ff
    return flops, (d * E + roofline.experts_hit(E, k, tokens) * 3 * d * ff) * roofline.itemsize(c)


def _kv_row_bytes(c) -> int:
    return 2 * c["num_key_value_heads"] * c["head_dim"] * roofline.itemsize(c)


def prefill_work(c, S: int) -> tuple[float, float]:
    ffn_f, ffn_b = _ffn(c, S)
    att_f, _ = roofline.flash_call(c, S)
    layer_f = 2 * S * _attn_params(c) + att_f + ffn_f
    layer_b = _attn_params(c) * roofline.itemsize(c) + ffn_b + S * _kv_row_bytes(c)
    head_f, head_b = roofline.head(c, 1, S)
    L = c["num_hidden_layers"]
    return L * layer_f + head_f, L * layer_b + head_b


def decode_work(c, positions) -> tuple[float, float]:
    T = len(positions)
    H, hd = c["num_attention_heads"], c["head_dim"]
    ctx = sum(p + 1 for p in positions)           # keys each row attends to
    ffn_f, ffn_b = _ffn(c, T)
    layer_f = 2 * T * _attn_params(c) + 4 * hd * H * ctx + ffn_f
    layer_b = _attn_params(c) * roofline.itemsize(c) + ffn_b + ctx * _kv_row_bytes(c)
    head_f, head_b = roofline.head(c, T, T)
    L = c["num_hidden_layers"]
    return L * layer_f + head_f, L * layer_b + head_b

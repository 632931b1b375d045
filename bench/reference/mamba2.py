"""Mamba-2 (arXiv:2405.21060) as the benchmark's configuration states it, in
plain PyTorch and float32.

Per layer: RMSNorm; one input projection split into the gate z, the conv
channels (x, B, C) and the step sizes dt; a causal depthwise convolution of
width ``d_conv`` with bias over the conv channels, then SiLU; dt =
softplus(dt + dt_bias), A = -exp(A_log); the state-space recurrence

    h_t = exp(dt_t * A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t

per head, computed in its quadratic (attention-like) form over the whole
sequence from a zero state, with the decays' cumulative sums in float64;
then RMSNorm of y * silu(z), the output projection and the residual. A
final RMSNorm and the tied output projection (the embedding's transpose).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import roofline
from .precision import mm, no_tf32, rms_norm


def dims(conf):
    d_inner = conf["expand"] * conf["hidden_size"]
    heads = d_inner // conf["head_dim"]
    gn = conf["n_groups"] * conf["state_size"]
    return d_inner, heads, gn, d_inner + 2 * gn


def ssm(xs, dt, A, B, C, D):
    """xs (S, H, P), dt (S, H), A (H,), B and C (S, H, N) -> y (S, H, P)."""
    S = xs.shape[0]
    cs = torch.cumsum((dt * A).double(), 0)                   # (S, H)
    seg = cs[:, None, :] - cs[None, :, :]                     # (t, s, H)
    causal = torch.ones(S, S, dtype=torch.bool, device=xs.device).tril()[..., None]
    decay = torch.exp(seg.masked_fill(~causal, float("-inf"))).float()
    scores = torch.einsum("thn,shn->tsh", C, B) * decay
    y = torch.einsum("tsh,shp->thp", scores, xs * dt[..., None])
    return y + xs * D[None, :, None]


def block(x, p, conf, prec):
    d_inner, H, gn, conv_ch = dims(conf)
    P, G, N, K = conf["head_dim"], conf["n_groups"], conf["state_size"], conf["conv_kernel"]
    S = x.shape[0]
    eps = conf["rms_norm_eps"]
    proj = mm(rms_norm(x, p("norm/scale"), eps), p("in_proj/w"), prec)
    z, xbc, dt = proj[:, :d_inner], proj[:, d_inner:d_inner + conv_ch], proj[:, d_inner + conv_ch:]
    w, b = p("conv/w"), p("conv/b")                           # (K, conv_ch), (conv_ch,)
    padded = torch.cat([torch.zeros(K - 1, conv_ch, device=x.device), xbc], 0)
    xbc = F.silu(sum(padded[i:i + S] * w[i] for i in range(K)) + b)
    xs = xbc[:, :d_inner].view(S, H, P)
    Bm = xbc[:, d_inner:d_inner + gn].view(S, G, N).repeat_interleave(H // G, dim=1)
    Cm = xbc[:, d_inner + gn:].view(S, G, N).repeat_interleave(H // G, dim=1)
    dt = F.softplus(dt + p("dt_bias"))
    y = ssm(xs, dt, -torch.exp(p("A_log")), Bm, Cm, p("D")).reshape(S, d_inner)
    y = rms_norm(y * F.silu(z), p("gate_norm/scale"), eps)
    return x + mm(y, p("out_proj/w"), prec)


def logits(w, conf, tokens, prompt_len, prec="f32"):
    no_tf32()
    x = w["embed/tokens"][tokens.long()].float()
    for i in range(conf["num_hidden_layers"]):
        def p(name, i=i):
            return w[f"blocks/{name}"][i].float()
        x = block(x, p, conf, prec)
    x = rms_norm(x, w["final_norm/scale"], conf["rms_norm_eps"])
    return mm(x, w["embed/tokens"].T, prec)


# ------------------------------------------------- operations and bytes
# Counted by the rules of ``bench/roofline.py``, which finds these by the
# configuration's ``reference``.
def _layer_work(c) -> tuple[float, float, float]:
    """(operations per token, weight bytes, state bytes per sequence) of a layer."""
    d, P, N, K = c["hidden_size"], c["head_dim"], c["state_size"], c["conv_kernel"]
    di = c["expand"] * d
    H, gn = di // P, c["n_groups"] * N
    conv = di + 2 * gn
    d_proj = 2 * di + 2 * gn + H
    isz = roofline.itemsize(c)
    flops = 2 * d * d_proj + 2 * di * d + 2 * K * conv + 4 * H * P * N
    weights = (d * d_proj + di * d + K * conv + conv + di + d) * isz + 3 * H * 4
    state = H * P * N * 4 + (K - 1) * conv * isz
    return flops, weights, state


def prefill_work(c, S: int) -> tuple[float, float]:
    f, w, state = _layer_work(c)
    head_f, head_b = roofline.head(c, 1, S)
    L = c["num_hidden_layers"]
    return L * S * f + head_f, L * (w + state) + head_b


def decode_work(c, positions) -> tuple[float, float]:
    T = len(positions)
    f, w, state = _layer_work(c)
    head_f, head_b = roofline.head(c, T, T)
    L = c["num_hidden_layers"]
    return L * T * f + head_f, L * (w + 2 * T * state) + head_b

"""Shared layers: norms, RoPE, attention (naive / chunked online softmax /
kernel), MLPs, and the cross-entropy loss — the port of the reference's
``models/common.py`` on torch tensors, in the same layouts.

Attention implementations (the ``impl`` switch):

* ``naive``   — the O(S^2)-materializing oracle, as the reference's;
* ``chunked`` — online softmax over KV chunks in plain torch;
* ``kernel``  — the engine's default: ``kernels.flash_attention``, which
  launches the CUDA C++ kernel for CUDA tensors and runs its plain version
  for CPU tensors.

``rms_norm`` always goes through ``kernels.rmsnorm`` (the CUDA C++ kernel
on CUDA, its plain version on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.context import is_dtensor
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm

NEG_INF = -(2.0**30)  # large-but-finite: keeps masked softmax NaN-free


# ------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm(x, scale, eps=eps)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# -------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions[..., None].float() * freqs  # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., seq, heads, head_dim); sin/cos: (..., seq, half). Split
    halves (not interleaved), as the reference."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(dt)


# --------------------------------------------------------------- attention
def repeat_kv(k, groups: int):
    """(B,S,KV,hd) -> (B,S,KV*groups,hd) for GQA."""
    if groups == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, hd).reshape(
        b, s, kv * groups, hd
    )


def _window_mask(q_pos, k_pos, causal: bool, window: int):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Oracle: (B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd), f32 softmax."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    k = repeat_kv(k, h // kv)
    v = repeat_kv(v, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * hd**-0.5
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = _window_mask(q_pos, k_pos, causal, window)
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0, chunk=512):
    """Flash-style online softmax over KV chunks (plain torch).

    Memory: O(Sq * chunk) scores instead of O(Sq * Sk)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    q_pos = torch.arange(sq, device=q.device) + q_offset
    scale = hd**-0.5
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for c0 in range(0, sk, chunk):
        # the reference pads the last chunk with zero keys and masks them
        # (k_pos < sk); slicing it short drops the same columns
        kk = repeat_kv(k[:, c0:c0 + chunk], groups)
        vv = repeat_kv(v[:, c0:c0 + chunk], groups)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
        k_pos = c0 + torch.arange(kk.shape[1], device=q.device)
        mask = _window_mask(q_pos, k_pos, causal, window)
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vv.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-37)
    return out.transpose(1, 2).to(q.dtype)


def attention(q, k, v, *, causal=True, window=0, q_offset=0, impl="kernel",
              chunk=512):
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "chunked":
        ch = min(chunk, max(k.shape[1], 128))
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, chunk=ch)
    if impl == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    raise ValueError(f"unknown attention impl {impl!r}")


def _whole(x, dims: tuple, divides: int = 0):
    """DTensor ``x`` with every mesh axis that shards one of ``dims``
    gathered, but for an axis whose size divides ``divides``."""
    from torch.distributed.tensor import Replicate

    pl = [Replicate() if p.is_shard() and p.dim % x.dim() in dims
          and (not divides or divides % x.device_mesh.size(i)) else p
          for i, p in enumerate(x.placements)]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return x


def _local_reshape(x, fn):
    """``fn`` (a reshape that keeps every sharded axis's index and splits
    or merges only unsharded or evenly sharded trailing axes) applied to
    each device's shard of the DTensor ``x``; the gradient comes back
    through the same placements."""
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(x.placements)
    return local_map(fn, out_placements=list(pl), in_placements=(pl,),
                     device_mesh=x.device_mesh)(x)


def split_heads(x, heads: int, hd: int):
    """(..., heads * hd) -> (..., heads, hd). On a DTensor whose last axis a
    mesh axis shards into pieces that do not hold whole heads (gemma3-1b's
    4 heads over a 16-way axis), that mesh axis is gathered first: DTensor
    cannot split a shard across the new axes (XLA reshards there too); the
    split itself runs on each shard, so the gradient keeps the placements."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-1], heads, hd)
    x = _whole(x, (x.dim() - 1,), heads)
    return _local_reshape(x, lambda t: t.reshape(*t.shape[:-1], t.shape[-1] // hd, hd))


def merge_heads(x):
    """(..., heads, hd) -> (..., heads * hd), the inverse of
    ``split_heads``: on a DTensor, a sharded head_dim is gathered first and
    the merge runs on each shard (heads stay sharded where they were)."""
    if not is_dtensor(x):
        return x.reshape(*x.shape[:-2], -1)
    x = _whole(x, (x.dim() - 1,))
    return _local_reshape(x, lambda t: t.reshape(*t.shape[:-2], -1))


def cache_device(like):
    """Where a prefill makes its cache: ``like``'s device, or the meta
    device when ``like`` is a DTensor (``placed_like`` then makes each
    device's shard)."""
    return torch.device("meta") if is_dtensor(like) else like.device


def placed_like(cache: dict, like, axes: dict) -> dict:
    """A freshly made cache as DTensors on ``like``'s mesh when ``like`` is
    a DTensor: each tensor (made on ``cache_device``) becomes zeros of this
    device's shard, placed as its logical ``axes`` resolve under the
    current ``mesh_rules`` (the cache shardings of ``launch/steps.py``), so
    a step on a mesh writes into it in place; unchanged otherwise."""
    if not is_dtensor(like):
        return cache
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.context import current_mesh_rules
    from repro_torch.dist.sharding import local_shape, placements_for, spec_for

    mesh = like.device_mesh
    ctx = current_mesh_rules()
    rules = ctx[1] if ctx is not None and ctx[0] is mesh else None
    device = like.to_local().device
    out = {}
    for n, t in cache.items():
        if not isinstance(t, torch.Tensor):
            out[n] = t
            continue
        entries = spec_for(axes[n], t.shape, mesh, rules)
        local = torch.zeros(local_shape(t.shape, entries, mesh), dtype=t.dtype,
                            device=device)
        out[n] = DTensor.from_local(local, mesh, placements_for(entries, mesh),
                                    run_check=False, shape=t.shape, stride=t.stride())
    return out


def host_ints(values, device) -> torch.Tensor:
    """A host sequence of ints as an int64 tensor on ``device``. On CUDA it
    goes up from pinned memory without waiting for the stream, so a decode
    loop that feeds per-row positions never stalls the host on the card."""
    t = torch.tensor(values, dtype=torch.int64)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token attention against a cache; entries beyond ``pos`` masked.

    q (B,1,H,hd), caches (B,S,KV,hd). ``pos`` is an int shared by every row
    or a (B,) integer tensor, one position per row. GQA as a grouped einsum
    against the UNEXPANDED cache, scores in f32 (the reference's
    ``preferred_element_type=f32``)."""
    b, s, kvh, hd = k_cache.shape
    h = q.shape[2]
    g = h // kvh
    if is_dtensor(q):        # whole KV groups on each device (see split_heads)
        q = _whole(q, (2, 3), kvh)
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * hd**-0.5
    if isinstance(pos, torch.Tensor):
        valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
        valid = valid[:, None, None, None, :]           # (B,1,1,1,S)
    else:
        valid = torch.arange(s, device=q.device) <= pos
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


# --------------------------------------------------------------------- MLP
def mlp(x, w_gate, w_up, w_down, *, act="silu", b_up=None, b_down=None):
    if act == "silu":
        h = F.silu(x @ w_gate) * (x @ w_up)
    else:
        h = x @ w_up
        if b_up is not None:
            h = h + b_up
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    y = h @ w_down
    if b_down is not None:
        y = y + b_down
    return y


# -------------------------------------------------------------------- loss
def cross_entropy(logits, labels, mask: Optional[torch.Tensor] = None):
    """Mean next-token CE; logits (B,S,V) any float dtype, f32 internally."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # the difference is taken before the gathered axis is dropped: on a
    # DTensor sharded over the vocab, the gather's masked partial sum is
    # reduced in the shape it was gathered in
    ll = torch.gather(logits, -1, labels[..., None].long())
    nll = (logz[..., None] - ll)[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()

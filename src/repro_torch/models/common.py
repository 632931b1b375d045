"""Shared layers: norms, RoPE, attention (naive / chunked online softmax /
kernel), MLPs, and the cross-entropy loss — the port of the reference's
``models/common.py`` on torch tensors, in the same layouts.

Attention implementations (the ``impl`` switch):

* ``naive``   — the O(S^2)-materializing oracle, as the reference's;
* ``chunked`` — online softmax over KV chunks in plain torch;
* ``kernel``  — the engine's default: ``kernels.flash_attention``, which
  launches the CUDA C++ kernel for CUDA tensors and runs its plain version
  for CPU tensors.

``decode_attention`` (one new token against a cache) goes through
``kernels.decode_attention`` off the CPU and its plain version on it.

``rms_norm`` always goes through ``kernels.rmsnorm`` (the CUDA C++ kernel
on CUDA, its plain version on the CPU).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.context import is_dtensor
from repro_torch.dist.heads import on_local_heads
from repro_torch.kernels.decode_attention import decode_attention as kernel_decode_attention
from repro_torch.kernels.decode_attention import decode_attention_plain
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
    # the base made on the device (a fill, no upload): a CUDA graph capture
    # refuses the synchronised copy a host scalar would take
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(base, exps)
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

    Memory: O(Sq * chunk) scores instead of O(Sq * Sk). On DTensors the
    loop runs on each device's batch rows and heads (``on_local_heads``),
    so its float32 accumulators are the device's shard, never the whole
    batch's."""
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return on_local_heads(functools.partial(
            chunked_attention, causal=causal, window=window, q_offset=q_offset,
            chunk=chunk), q, k, v)
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
    or a (B,) integer tensor, one position per row. Off the CPU this is
    the ``decode_attention`` kernel (``kernels/decode_attention``), which
    reads the cache in place; on the CPU its plain version: GQA as a
    grouped einsum against the UNEXPANDED cache, scores in f32 (the
    reference's ``preferred_element_type=f32``)."""
    if not q.is_cpu:
        return kernel_decode_attention(q, k_cache, v_cache, pos)
    if is_dtensor(q):        # whole KV groups on each device (see split_heads)
        q = _whole(q, (2, 3), k_cache.shape[2])
    return decode_attention_plain(q, k_cache, v_cache, pos)


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
    """Mean next-token CE; logits (B,S,V) any float dtype, f32 internally.

    On a DTensor that a mesh axis shards (the vocabulary, the batch or
    both), the per-token loss is ``vocab_parallel_nll``: local math on each
    device's shard and explicit reductions over the axes that shard the
    vocabulary, so no device ever holds more than its own shard (DTensor's
    own propagation would gather the logits whole, and the gather's
    backward would build a gradient of the whole tensor). Plain tensors
    and replicated DTensors (every leaf of a 1x1 mesh) take the plain path."""
    if is_sharded(logits):
        nll = vocab_parallel_nll(logits, labels)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())
        nll = (logz[..., None] - ll)[..., 0]
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


# The vocabulary-parallel loss in two layers: plain functions of one shard
# of the logits (columns [v0, v0 + V_r) of the vocabulary), and a combine
# step that reduces their results over the shards with the reductions it is
# given (collectives over the mesh axes that shard the vocabulary, or a max
# and a sum over a stacked list of shards in one process).
def shard_lse(x: torch.Tensor) -> torch.Tensor:
    """The shard's log-sum-exp over its columns, in float32."""
    return torch.logsumexp(x.float(), dim=-1)


def _local_labels(labels, v0: int, width: int):
    """(labels - v0 clamped into the shard, whether each label is in it)."""
    local = labels.long() - v0
    inside = (local >= 0) & (local < width)
    return local.clamp(0, width - 1), inside


def shard_label_logit(x: torch.Tensor, labels: torch.Tensor, v0: int) -> torch.Tensor:
    """The label's logit in float32 where the label lies in the shard, else 0."""
    local, inside = _local_labels(labels, v0, x.shape[-1])
    ll = torch.gather(x, -1, local[..., None])[..., 0].float()
    return torch.where(inside, ll, torch.zeros_like(ll))


def combine_shards(lse_r, ll_r, reduce_max, reduce_sum):
    """The whole vocabulary's log-sum-exp and label logit from the shards':
    ``M = max_r lse_r``, ``lse = M + log(sum_r exp(lse_r - M))`` and
    ``ll = sum_r ll_r``, the two sums stacked into one reduction. With one
    shard ``lse`` is its own log-sum-exp bit for bit (``exp(0) = 1``,
    ``log 1 = 0``)."""
    m = reduce_max(lse_r)
    sums = reduce_sum(torch.stack([torch.exp(lse_r - m), ll_r], dim=-1))
    return m + torch.log(sums[..., 0]), sums[..., 1]


def shard_grad(x, labels, v0: int, lse, g) -> torch.Tensor:
    """d loss / d shard in float32: ``(softmax_r - onehot_r) * g`` with
    ``softmax_r = exp(x - lse)``, ``g`` the per-token gradient of the loss."""
    local, inside = _local_labels(labels, v0, x.shape[-1])
    # in place on one float32 copy of the shard: its only full-size buffer
    p = x.to(torch.float32, copy=True).sub_(lse[..., None]).exp_()
    # one index a row: the scatter has no colliding adds and is deterministic
    p.scatter_add_(-1, local[..., None], -inside[..., None].float())
    return p.mul_(g[..., None])


def nll_over_shards(shards, labels, mask: Optional[torch.Tensor] = None):
    """The loss of logits given as a list of vocabulary slices in one
    process, and its gradient: the shard functions on each slice, combined
    by ``combine_shards`` with a max and a sum over the stacked slices (the
    single-process form of the mesh's all-reduces), the mean and ``mask``
    as ``cross_entropy``'s. Returns (loss, [d loss / d slice], lse)."""
    v0 = [0]
    for s in shards[:-1]:
        v0.append(v0[-1] + s.shape[-1])
    lse_r = torch.stack([shard_lse(s) for s in shards])
    ll_r = torch.stack([shard_label_logit(s, labels, v) for s, v in zip(shards, v0)])
    lse, ll = combine_shards(lse_r, ll_r, lambda t: t.amax(0), lambda t: t.sum(0))
    nll = lse - ll
    if mask is None:
        loss, g = nll.mean(), torch.full_like(nll, 1.0 / nll.numel())
    else:
        count = torch.clamp(mask.sum(), min=1)
        loss, g = (nll * mask).sum() / count, mask / count
    return loss, [shard_grad(s, labels, v, lse, g).to(s.dtype)
                  for s, v in zip(shards, v0)], lse


class _VocabParallelNLL(torch.autograd.Function):
    """The per-token loss of one device's shard; the backward's gradient is
    the shard's own, computed from the saved shard and the combined lse."""

    @staticmethod
    def forward(ctx, x, labels, v0, reduce_max, reduce_sum):
        lse, ll = combine_shards(shard_lse(x), shard_label_logit(x, labels, v0),
                                 reduce_max, reduce_sum)
        ctx.save_for_backward(x, labels, lse)
        ctx.v0 = v0
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        return shard_grad(x, labels, ctx.v0, lse, g).to(x.dtype), None, None, None, None


def is_sharded(logits) -> bool:
    """Whether ``logits`` is a DTensor that some mesh dim shards."""
    return is_dtensor(logits) and any(p.is_shard() for p in logits.placements)


def _shard_start(mesh, dims, vocab: int) -> int:
    """This device's first vocabulary index: the shards nest in mesh-dim
    order, as DTensor lays them out (``spec_for`` shards only evenly)."""
    coord = mesh.get_coordinate()
    lo, width = 0, vocab
    for d in dims:
        width //= mesh.size(d)
        lo += coord[d] * width
    return lo


def _mesh_reduce(mesh, dims, op: str):
    import torch.distributed._functional_collectives as funcol

    if not dims:                      # one shard of the vocabulary: nothing to reduce
        return lambda t: t

    def reduce(t):
        for d in dims:
            t = funcol.all_reduce(t, op, (mesh, d))
        return funcol.wait_tensor(t)

    return reduce


def vocab_parallel_nll(logits, labels):
    """Per-token loss (B,S) of logits that a mesh shards: each device's
    shard through ``_VocabParallelNLL`` (``local_map``), the max and the
    sums all-reduced over the mesh dims that shard the vocabulary (none
    when only batch axes are sharded). The result keeps the batch axes'
    placements and is replicated over the vocabulary's."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, last = logits.device_mesh, logits.dim() - 1
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                            for p in logits.placements])
    x_pl = tuple(logits.placements)
    dims = tuple(i for i, p in enumerate(x_pl) if p.is_shard(last))
    row_pl = tuple(Replicate() if p.is_shard(last) else p for p in x_pl)
    if tuple(labels.placements) != row_pl:
        labels = labels.redistribute(mesh, row_pl)
    v0 = _shard_start(mesh, dims, logits.shape[-1])

    def local(x, lab):
        return _VocabParallelNLL.apply(x, lab, v0, _mesh_reduce(mesh, dims, "max"),
                                       _mesh_reduce(mesh, dims, "sum"))

    fn = local_map(local, out_placements=list(row_pl), in_placements=(x_pl, row_pl),
                   device_mesh=mesh)
    return fn(logits, labels)

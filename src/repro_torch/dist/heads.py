"""Attention on a device mesh: a function of ``(q, k, v)`` run on each
device's own heads through ``local_map``, so that neither a kernel nor the
chunked loop ever sees a DTensor, and no device makes a tensor of the whole
batch's or all heads' attention.

q is ``(B, S, H, hd)``, K and V ``(B, Sk, KV, hd)``. Attention needs each
query's sequence and head_dim whole, and the K and V heads that its query
heads read (query head ``j`` reads KV head ``j // (H // KV)``). Batch and
heads may stay sharded:

* a mesh dim that shards q's batch shards K's and V's batch too;
* a mesh dim that shards q's heads evenly keeps them sharded, and shards K's
  and V's heads too while it divides them (shards nest in mesh-dim order,
  as DTensor lays them out). Where it does not divide them (MQA's one KV
  head; deepseek-67b's 8 KV heads over 16 devices), K and V stay whole on
  that dim and each device slices out the KV heads that its query heads
  read. That needs a device's query heads to lie inside one GQA group or to
  cover whole groups; otherwise q's heads are gathered too;
* every other placement (a sharded sequence or head_dim, a pending partial
  sum) is redistributed to a replica first.

Where K and V stay whole but q's heads are sharded, each device's gradient
of K and V is its own heads' part: ``in_grad_placements`` declares it a
partial sum over that dim.
"""

from __future__ import annotations

from .context import is_dtensor


def _plan(q_placements, sizes, heads: int, kv_heads: int):
    """(q's placements, K's and V's, and K's and V's gradients') on a mesh
    of ``sizes`` for q placed as ``q_placements``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    qp, h = [], heads
    for p, n in zip(q_placements, sizes):
        if p.is_shard(0):
            qp.append(Shard(0))
        elif p.is_shard(2) and h % n == 0:
            qp.append(Shard(2))
            h //= n
        else:
            qp.append(Replicate())
    group = heads // kv_heads
    if group % h and h % group:          # a device's heads straddle two groups
        qp = [Replicate() if p.is_shard(2) else p for p in qp]
    kp, kg, kv, whole = [], [], kv_heads, False
    for p, n in zip(qp, sizes):
        if p.is_shard(0):
            kp.append(Shard(0))
            kg.append(Shard(0))
        elif p.is_shard(2) and not whole and kv % n == 0:
            kp.append(Shard(2))
            kg.append(Shard(2))
            kv //= n
        elif p.is_shard(2):
            whole = True
            kp.append(Replicate())
            kg.append(Partial())
        else:
            kp.append(Replicate())
            kg.append(Replicate())
    return tuple(qp), tuple(kp), tuple(kg)


def _first_head(mesh, placements, heads: int) -> tuple[int, int]:
    """(this device's first head, its number of heads) under placements
    that shard axis 2 evenly."""
    coord = mesh.get_coordinate()
    lo = 0
    for i, p in enumerate(placements):
        if p.is_shard(2):
            heads //= mesh.size(i)
            lo += coord[i] * heads
    return lo, heads


def on_local_heads(fn, q, k, v, *rows):
    """``fn(q, k, v, *rows)`` on each device's shards of the DTensors among
    q, k and v (a plain tensor is taken as replicated); the result is
    placed as q is. Each of ``rows`` (a decode's per-row positions) has the
    batch as its first axis and is cut as q's batch is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    repl = (Replicate(),) * mesh.ndim
    q, k, v = (t if is_dtensor(t) else DTensor.from_local(t, mesh, repl, run_check=False)
               for t in (q, k, v))
    heads, kv_heads = q.shape[2], k.shape[2]
    qp, kp, kg = _plan(q.placements, tuple(mesh.shape), heads, kv_heads)
    q, k, v = (t if tuple(t.placements) == want else t.redistribute(mesh, want)
               for t, want in ((q, qp), (k, kp), (v, kp)))
    a, h = _first_head(mesh, qp, heads)
    kv_a, kv = _first_head(mesh, kp, kv_heads)
    group = heads // kv_heads
    lo, hi = a // group - kv_a, (a + h - 1) // group + 1 - kv_a
    local = fn if (lo, hi) == (0, kv) else (
        lambda q_, k_, v_, *r: fn(q_, k_[:, :, lo:hi], v_[:, :, lo:hi], *r))
    rp = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in qp)
    rows = tuple((t if is_dtensor(t) else DTensor.from_local(t, mesh, repl, run_check=False)
                  ).redistribute(mesh, rp) for t in rows)
    return local_map(local, out_placements=list(qp),
                     in_placements=(qp, kp, kp, *(rp,) * len(rows)),
                     in_grad_placements=(qp, kg, kg, *(rp,) * len(rows)),
                     device_mesh=mesh)(q, k, v, *rows)

"""Mixture-of-Experts block — the port of the reference's ``models/moe.py``:
capacity-based dispatch (GShard-style) by scatter and gather.

Slot positions come from a cumsum of expert one-hots over each batch row's
``S*k`` routed slots; tokens are scattered into a ``(B, E, C, d)`` buffer,
the experts run as one batched product over the E axis, and the outputs
gather back with combine weights. Returns the Switch load-balance aux loss.

What the port keeps exactly as the reference computes it:

* the top-k picks come from a STABLE descending sort (``top_k``):
  ``jax.lax.top_k`` takes the lower expert index first among equal
  probabilities, and the order of the k picks sets each slot's place in the
  capacity cumsum. ``torch.topk`` does not keep that order, and with bf16
  router logits equal probabilities are frequent;
* ``capacity`` is per batch row, from ``S`` (never from ``B*S``): a row's
  kept tokens never depend on its neighbours, so a batched decode row
  equals its B=1 call;
* a dropped slot adds ``x * 0`` at ``C - 1``, as the reference's masked
  scatter-add does.

No step reads a value back to the host (no ``.item()``, ``nonzero`` or
boolean-mask indexing), so a decode step never waits on the card.

On a device mesh (DTensors) the block is ``dispatch``, ``experts`` and
``combine`` placed as the reference's GSPMD places its vmapped per-row
scatter: see ``_moe_block_on_mesh``. Plain tensors, and a 1x1 mesh, run
the same local code and give the same bits.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.dist.context import is_dtensor


@dataclass
class Routing:
    """One MoE layer's routing of ``x`` (B, S, d) over E experts.

    ``top_e``/``top_p`` (B, S, k): the picked experts, best first, and their
    renormalised probabilities; ``pos`` (B, S*k): each routed slot's place in
    its expert's buffer, token-major then rank order; ``keep`` (B, S*k):
    ``pos < capacity``."""

    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    capacity: int


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, largest
    first and, among equal values, the lower index first (the order of
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(S: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots per expert in one batch row of ``S`` tokens."""
    return min(max(1, int(math.ceil(k * S / E * capacity_factor))), S * k)


def slot_positions(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """(B, S*k) expert ids -> each slot's place in its expert's buffer: the
    count of earlier slots of the same row routed to the same expert."""
    oh = (e_flat[..., None] == torch.arange(E, device=e_flat.device)).to(torch.int32)
    return (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1


def route(x, router_w, *, k: int, capacity_factor: float = 1.25) -> Routing:
    B, S, _ = x.shape
    E = router_w.shape[-1]
    logits = (x @ router_w.to(x.dtype)).float()                    # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(S, k, E, capacity_factor)
    pos = slot_positions(top_e.reshape(B, S * k), E)
    return Routing(probs, top_p, top_e, pos, pos < cap, cap)


def dispatch(x, router_w, *, k: int, capacity_factor: float = 1.25):
    """Route each row of x (B, S, d) and scatter its tokens into a
    (B, E, C, d) buffer: row b, expert e, slot p is flat index
    (b*E + e)*C + p; a dropped slot adds x*0 at C-1. Returns (buf, flat
    (B*S*k,) each routed slot's index into buf's rows, the combine weights
    (B, S*k), the Routing)."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    r = route(x, router_w, k=k, capacity_factor=capacity_factor)
    C = r.capacity
    e_flat = r.top_e.reshape(B, S * k)
    pos_c = torch.clamp(r.pos, 0, C - 1)
    rows = torch.arange(B, device=x.device)[:, None]
    flat = ((rows * E + e_flat) * C + pos_c).reshape(-1)
    x_slots = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    x_slots = x_slots * r.keep.to(x.dtype)[..., None]
    buf = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, flat, x_slots.reshape(-1, d))
    w_slots = (r.top_p.reshape(B, S * k) * r.keep).to(x.dtype)
    return buf.view(B, E, C, d), flat, w_slots, r


def experts(buf, w_gate, w_up, w_down):
    """The expert FFN on a (B, E, C, d) buffer, batched over E."""
    wg, wu, wd = (w.to(buf.dtype) for w in (w_gate, w_up, w_down))
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) * torch.einsum(
        "becd,edf->becf", buf, wu)
    return torch.einsum("becf,efd->becd", h, wd)


def combine(y, flat, w_slots, *, k: int):
    """The experts' outputs y (B, E, C, d) gathered back to each routed
    slot and summed over a token's k slots with the combine weights."""
    B, _, _, d = y.shape
    S = w_slots.shape[1] // k
    out_slots = y.reshape(-1, d)[flat].view(B, S * k, d)
    return (out_slots * w_slots[..., None]).reshape(B, S, k, d).sum(2)


def balance(r: Routing):
    """The Switch load-balance statistics of one routing, each (E,): the
    mean router probability of each expert, and the share of tokens whose
    first pick it is."""
    E = r.probs.shape[-1]
    first = r.top_e[..., 0, None] == torch.arange(E, device=r.probs.device)
    return r.probs.mean(dim=(0, 1)), first.float().mean(dim=(0, 1))


def moe_block(x, router_w, w_gate, w_up, w_down, *, k: int,
              capacity_factor: float = 1.25):
    """x (B, S, d) -> (out (B, S, d), aux loss f32 scalar): the load-balance
    loss (Switch), E * sum_e f_e * P_e."""
    if is_dtensor(x):
        return _moe_block_on_mesh(x, router_w, w_gate, w_up, w_down, k=k,
                                  capacity_factor=capacity_factor)
    buf, flat, w_slots, r = dispatch(x, router_w, k=k, capacity_factor=capacity_factor)
    out = combine(experts(buf, w_gate, w_up, w_down), flat, w_slots, k=k)
    me, ce = balance(r)
    return out, router_w.shape[-1] * torch.sum(me * ce)


def _moe_block_on_mesh(x, router_w, w_gate, w_up, w_down, *, k, capacity_factor):
    """``moe_block`` on DTensors, as the reference's GSPMD places its
    per-row (vmapped) scatter: the route, the scatter and the gather back
    run on each device's batch rows (``local_map``) with the router whole;
    the buffer takes its expert axis to the expert weights' shard (a local
    slice, no wire) so the expert products run on each device's experts,
    and the outputs come back whole over the experts (one all-gather, or
    an all-reduce where the weights shard the hidden axis instead). The
    balance statistics of each device's rows leave as partial sums over
    the mesh dims that shard the batch: the global mean, with no gather of
    the router's probabilities."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in x.placements)
    whole = (Replicate(),) * mesh.ndim
    stat = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    n = math.prod(mesh.size(i) for i, p in enumerate(rows) if p.is_shard())
    if tuple(x.placements) != rows:
        x = x.redistribute(mesh, rows)
    if tuple(router_w.placements) != whole:
        router_w = router_w.redistribute(mesh, whole)

    def local_dispatch(x_, w_):
        buf, flat, w_slots, r = dispatch(x_, w_, k=k, capacity_factor=capacity_factor)
        me, ce = balance(r)
        # each device's share of the mean over the global batch (/ 1 is exact)
        return buf, flat, w_slots, me / n, ce / n

    buf, flat, w_slots, me, ce = local_map(
        local_dispatch, out_placements=(rows, rows, rows, stat, stat),
        in_placements=(rows, whole), in_grad_placements=(rows, stat),
        device_mesh=mesh)(x, router_w)
    on_experts = tuple(Shard(1) if p.is_replicate() and w.is_shard(0) else p
                       for p, w in zip(rows, w_gate.placements))
    if on_experts != rows:
        buf = buf.redistribute(mesh, on_experts)
    y = experts(buf, w_gate, w_up, w_down)
    if tuple(y.placements) != rows:
        y = y.redistribute(mesh, rows)
    out = local_map(functools.partial(combine, k=k), out_placements=list(rows),
                    in_placements=(rows, rows, rows), device_mesh=mesh)(y, flat, w_slots)
    return out, router_w.shape[-1] * torch.sum(me * ce)


def shared_expert(x, w_gate, w_up, w_down, gate_w):
    """The always-on expert of qwen2-moe, scaled by a per-token sigmoid gate
    computed in float32."""
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    y = h @ w_down.to(x.dtype)
    g = torch.sigmoid((x @ gate_w.to(x.dtype)).float())
    return y * g.to(x.dtype)

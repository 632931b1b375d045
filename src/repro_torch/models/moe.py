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
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F


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


def moe_block(x, router_w, w_gate, w_up, w_down, *, k: int,
              capacity_factor: float = 1.25):
    """x (B, S, d) -> (out (B, S, d), aux loss f32 scalar)."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    r = route(x, router_w, k=k, capacity_factor=capacity_factor)
    C = r.capacity
    e_flat = r.top_e.reshape(B, S * k)
    pos_c = torch.clamp(r.pos, 0, C - 1)

    # scatter tokens into (B, E, C, d): row b, expert e, slot p is flat
    # index (b*E + e)*C + p; dropped slots add x*0 at C-1
    rows = torch.arange(B, device=x.device)[:, None]
    flat = ((rows * E + e_flat) * C + pos_c).reshape(-1)
    x_slots = x[:, :, None, :].expand(B, S, k, d).reshape(B, S * k, d)
    x_slots = x_slots * r.keep.to(x.dtype)[..., None]
    buf = torch.zeros((B * E * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, flat, x_slots.reshape(-1, d))
    buf = buf.view(B, E, C, d)

    # expert FFN, batched over E
    wg, wu, wd = (w.to(x.dtype) for w in (w_gate, w_up, w_down))
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) * torch.einsum(
        "becd,edf->becf", buf, wu)
    y = torch.einsum("becf,efd->becd", h, wd)                      # (B,E,C,d)

    # gather back with combine weights
    out_slots = y.reshape(B * E * C, d)[flat].view(B, S * k, d)
    w_slots = (r.top_p.reshape(B, S * k) * r.keep).to(x.dtype)
    out = (out_slots * w_slots[..., None]).reshape(B, S, k, d).sum(2)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = r.probs.mean(dim=(0, 1))
    first = r.top_e[..., 0, None] == torch.arange(E, device=x.device)
    ce = first.float().mean(dim=(0, 1))
    return out, E * torch.sum(me * ce)


def shared_expert(x, w_gate, w_up, w_down, gate_w):
    """The always-on expert of qwen2-moe, scaled by a per-token sigmoid gate
    computed in float32."""
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    y = h @ w_down.to(x.dtype)
    g = torch.sigmoid((x @ gate_w.to(x.dtype)).float())
    return y * g.to(x.dtype)

"""AdamW with warmup + cosine schedule and global-norm clipping, the port
of the reference's ``optim/adamw.py`` with the same arithmetic: float32
moments whatever the parameters' dtype, clipping by the global norm of
the gradients, decoupled weight decay, the update in float32 cast back to
the parameter's dtype. The learning rate, the bias corrections and the
schedule are computed in float32 from the step tensor on its device, as
the reference computes them on its device, so they never drift from it by
a Python double's rounding.

Departure that does not change results: ``adamw_update`` updates the
parameters, the moments and the step IN PLACE (the reference returns new
arrays and donates the old ones) and returns the same tensors, so a
trainer whose state lives in a device arena never copies it. Call it
under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict) -> dict:
    """Zero float32 moments beside each parameter and a 0-d int32 step."""
    first = next(iter(params.values()))
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {
        "m": {n: zeros32(p) for n, p in params.items()},
        "v": {n: zeros32(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """One AdamW step in place; returns (params, state, metrics) with
    metrics ``{"grad_norm": the norm before clipping, "lr": this step's
    learning rate}`` (0-d float32 tensors)."""
    state["step"].add_(1)
    step = state["step"]
    lr = lr_at(cfg, step)
    # the reference sums the leaves in its pytree order: sorted names
    gnorm = torch.sqrt(sum(torch.sum(grads[n].float() ** 2) for n in sorted(grads)))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    return params, state, {"grad_norm": gnorm, "lr": lr}

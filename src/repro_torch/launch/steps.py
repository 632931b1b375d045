"""The training step, the port of ``make_train_fn`` in the reference's
``launch/steps.py``: the loss and its gradients (autograd's backward where
the reference takes ``jax.value_and_grad``), microbatches accumulated in
float32 and divided by their count, then ``adamw_update``.

The reference's shardings, ``build_step`` and its prefill and decode steps
belong to the multi-device slice and are not ported yet.
"""

from __future__ import annotations

import torch

from repro_torch import models
from repro_torch.optim import OptConfig, adamw_update


def _grads(loss, params: dict) -> dict:
    """d loss / d each param; a param the loss never reads gets zeros, as
    under ``jax.grad``."""
    g = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                            materialize_grads=True)
    return dict(zip(params, g))


def make_train_fn(cfg, opt_cfg: OptConfig, *, num_microbatches: int = 1,
                  impl: str = "chunked"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"})``. ``params`` are tensors that require
    grad; they, the moments and the step are updated in place
    (``adamw_update``). Microbatch i is rows [i*mb, (i+1)*mb) of the batch,
    as the reference's reshape gives it. The metrics are 0-d tensors on the
    params' device."""

    def loss_on(params, batch):
        return models.loss_fn(cfg, params, batch, impl=impl)

    def train_step(params, opt_state, batch):
        if num_microbatches > 1:
            mb = batch["tokens"].shape[0] // num_microbatches
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.items()}
            losses = []
            for i in range(num_microbatches):
                b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss = loss_on(params, b)
                for n, g in _grads(loss, params).items():
                    grads[n].add_(g.float())
                losses.append(loss.detach())
            grads = {n: g / num_microbatches for n, g in grads.items()}
            loss = torch.stack(losses).mean()
        else:
            loss = loss_on(params, batch)
            grads = _grads(loss, params)
            loss = loss.detach()
        with torch.no_grad():
            params, opt_state, metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics}

    return train_step

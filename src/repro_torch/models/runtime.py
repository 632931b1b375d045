"""Activation rematerialization of a layer body, the port of the
reference's ``models/runtime.py::remat_wrap`` (``jax.checkpoint`` with the
config's policy) on ``torch.utils.checkpoint``:

* ``"nothing"`` — save only the body's inputs and recompute everything in
  the backward (``jax.checkpoint_policies.nothing_saveable``);
* ``"dots"``    — also keep the outputs of matrix products and recompute
  the rest (``dots_saveable``), through a selective-checkpoint context;
* ``"none"``    — no remat: the body itself.

The models apply it only while autograd records (``torch.is_grad_enabled``),
so prefill and decode run the body as it is. No layer body draws a random
number, so the recompute keeps no RNG state (``preserve_rng_state=False``):
stashing the card's RNG state is what a CUDA graph capture of the training
step (``train/program.py``) would refuse.

``unroll_scans()`` / ``scans_unrolled()`` keep the reference's switch for
the dry-run's API (``launch/dryrun.py`` enters it around its cost probes,
as the reference does). In the reference it makes each layer stack trace
as straight-line code instead of ``lax.scan``, because XLA's cost analysis
counts a loop body once. In the port every layer stack is already a
Python loop, so the flag changes no arithmetic and no count.
"""

from __future__ import annotations

import contextlib
import functools
from contextvars import ContextVar

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
# the matrix products of the models: x @ w (mm / addmm when 2-D, bmm and
# matmul's batched forms) and the einsums, which lower to bmm
_DOTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
         _aten.baddbmm.default}


_UNROLL: ContextVar[bool] = ContextVar("repro_torch_unroll_scans", default=False)


def scans_unrolled() -> bool:
    return _UNROLL.get()


@contextlib.contextmanager
def unroll_scans(on: bool = True):
    token = _UNROLL.set(on)
    try:
        yield
    finally:
        _UNROLL.reset(token)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(fn, cfg):
    """``fn`` under the config's remat policy (``cfg.remat_policy``)."""
    pol = getattr(cfg, "remat_policy", "nothing")
    if pol == "none":
        return fn
    kw = {"use_reentrant": False, "preserve_rng_state": False}
    if pol == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return lambda *a, **k: checkpoint(fn, *a, **kw, **k)

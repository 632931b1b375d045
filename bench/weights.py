"""Weights made from the seed, on the device, in the dtype they are served in.

Names, shapes, dtypes and initialisers come from the program's parameter
specifications (``repro_torch.models.param_specs``: the symbol manifest
that a served app imports). The values are the benchmark's own: one
``torch.Generator`` on the device, seeded with ``--seed``, fills one flat
buffer per dtype with a single ``randn`` call; each parameter is a view of
its buffer, scaled in place by its initialiser's standard deviation (0.02,
or fan-in ** -0.5), or filled with ones or zeros. The same tensors go to the
program and to the reference.
"""

from __future__ import annotations

import math

import torch

_RANDOM = ("normal", "fan_in")


def _std(spec) -> float:
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        return fan_in ** -0.5
    return 0.02


def make_weights(specs: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for every spec, made on ``device`` from ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    by_dtype: dict[torch.dtype, list] = {}
    for name, spec in specs.items():
        if spec.init in _RANDOM:
            by_dtype.setdefault(getattr(torch, spec.dtype), []).append(name)
    out: dict[str, torch.Tensor] = {}
    for dtype, names in by_dtype.items():
        sizes = [math.prod(specs[n].shape) for n in names]
        flat = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
        for name, part in zip(names, torch.split(flat, sizes)):
            out[name] = part.view(specs[name].shape).mul_(_std(specs[name]))
    for name, spec in specs.items():
        if spec.init not in _RANDOM:
            fill = torch.ones if spec.init == "ones" else torch.zeros
            out[name] = fill(spec.shape, dtype=getattr(torch, spec.dtype), device=device)
    return {name: out[name] for name in specs}

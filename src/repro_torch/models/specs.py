"""Parameter specifications: the models' *symbol manifests*.

Every model declares its parameters as ``{name: ParamSpec}`` — shape, dtype,
logical sharding axes, and initializer — WITHOUT allocating anything. The
spec dict converts 1:1 into ``SymbolRef``s (the application's relocation
instructions) and into bundle symbol tables, so its names, shapes and
dtypes equal the reference package's exactly.

``init_params`` draws each parameter from its own ``torch.Generator``,
seeded from the blake2b of its name (and the run seed): adding or removing
symbols never perturbs their neighbours. The numbers differ from the
reference's ``jax.random`` draws; parity tests share weights instead.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: str
    axes: tuple[Optional[str], ...]      # logical axis names, len == ndim
    init: str = "normal"                 # normal | zeros | ones | fan_in

    def __post_init__(self):
        assert len(self.axes) == len(self.shape), (self.axes, self.shape)


def torch_dtype(name: str) -> torch.dtype:
    """Spec dtype name ("bfloat16", "float32", ...) -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return dt


def _name_seed(seed: int, name: str) -> int:
    # hash the run seed together with the name: the CPU generator keeps only
    # the low 32 bits of a seed, so seed bits may not sit above the hash
    h = hashlib.blake2b(f"{seed}/{name}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") >> 1


def _init_one(gen: torch.Generator, spec: ParamSpec, device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    if spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = fan_in ** -0.5
    else:
        std = 0.02
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dt)


def init_params(
    specs: Mapping[str, ParamSpec], seed: int = 0, device="cuda"
) -> dict[str, torch.Tensor]:
    """Order-independent initialization on ``device``: each parameter's
    generator is seeded from its name, so adding/removing symbols never
    perturbs its neighbours."""
    dev = resolve_device(device)
    out = {}
    for n, s in specs.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(_name_seed(seed, n))
        out[n] = _init_one(gen, s, dev)
    return out


def param_bytes(specs: Mapping[str, ParamSpec]) -> int:
    return sum(
        int(np.prod(s.shape)) * torch_dtype(s.dtype).itemsize
        for s in specs.values()
    )


def param_count(specs: Mapping[str, ParamSpec]) -> int:
    return sum(int(np.prod(s.shape)) for s in specs.values())

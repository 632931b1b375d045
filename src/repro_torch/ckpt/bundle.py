"""Weight bundles — the "shared libraries" of the ML world.

A bundle is a registry object whose payload concatenates tensors at
PAGE_BYTES alignment and whose manifest carries the exported symbol table
(name -> shape/dtype/offset). Construction modes:

* monolithic            — one symbol per model parameter.
* ``fragment_experts``  — per-expert tensors exported as individual symbols
  ("...experts/w_gate[e]" slices).
* ``fragment_layers``   — per-layer slices of stacked (L, ...) tensors.

The bytes and the symbol table equal the reference package's for the same
values. Each symbol's dtype NAME comes from the parameter's ``ParamSpec``
when ``specs`` is given, else from the tensor itself — never from a numpy
stand-in, so a bfloat16 tensor is published as ``bfloat16`` and not as the
2-byte integer type that carries its bits.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core import (
    ObjectKind,
    PAGE_BYTES,
    StoreObject,
    SymbolDef,
    align_up,
    make_object,
)


def fragment_name(base: str, idx: int) -> str:
    return f"{base}[{idx}]"


def _host_array(value) -> tuple[np.ndarray, str]:
    """A tensor or numpy array -> (host numpy array holding its bytes, dtype
    name). bfloat16 comes back as its 2-byte bit pattern (``int16``) with the
    name ``"bfloat16"``; numpy arrays report ``arr.dtype.name``."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    arr = np.asarray(value)
    return arr, arr.dtype.name


def bundle_from_params(
    name: str,
    version: str,
    params: Mapping[str, object],
    *,
    specs: Optional[Mapping] = None,
    fragment_experts: bool = False,
    fragment_layers: bool = False,
    meta: dict | None = None,
) -> tuple[StoreObject, bytes]:
    """Build a bundle exporting every (optionally fragmented) tensor."""
    payload = bytearray()
    syms: list[SymbolDef] = []

    def emit(sym_name: str, arr: np.ndarray, dtype: str):
        arr = np.ascontiguousarray(arr)
        off = len(payload)
        payload.extend(arr.tobytes())
        pad = align_up(len(payload), PAGE_BYTES) - len(payload)
        payload.extend(b"\x00" * pad)
        syms.append(SymbolDef(sym_name, tuple(arr.shape), dtype, off, arr.nbytes))

    _stacked_prefixes = ("blocks/", "enc/", "dec/")

    for pname in sorted(params):
        arr, dtype = _host_array(params[pname])
        if specs is not None and pname in specs:
            dtype = specs[pname].dtype
        stacked = pname.startswith(_stacked_prefixes)
        if fragment_experts and "/experts/" in pname and arr.ndim >= 3:
            # (L, E, ...) -> one symbol per (layer, expert) slice
            L, E = arr.shape[0], arr.shape[1]
            for l in range(L):
                for e in range(E):
                    emit(fragment_name(fragment_name(pname, l), e), arr[l, e], dtype)
        elif fragment_layers and stacked and arr.ndim >= 2:
            for l in range(arr.shape[0]):
                emit(fragment_name(pname, l), arr[l], dtype)
        else:
            emit(pname, arr, dtype)

    obj, pl = make_object(
        name=name,
        version=version,
        kind=ObjectKind.BUNDLE,
        symbols=syms,
        payload=bytes(payload),
        meta=meta or {},
    )
    return obj, pl


def make_kernel_lib(
    name: str, version: str, entries: Mapping[str, int]
) -> tuple[StoreObject, bytes]:
    """Kernel library exporting op symbols; offset = entry-point index."""
    syms = [
        SymbolDef(f"kernel:{k}", (), "kernel", idx, 0)
        for k, idx in entries.items()
    ]
    return make_object(
        name=name, version=version, kind=ObjectKind.KERNEL_LIB, symbols=syms
    )


# ---------------------------------------------------------------- conversion
def image_to_params(image) -> dict[str, np.ndarray]:
    """LoadedImage -> params dict (zero-copy views into the arena; bfloat16
    symbols are 2-byte stand-in views, see ``repro_torch.convert``)."""
    return dict(image.tensors)


def params_from_image(image, specs) -> dict[str, np.ndarray]:
    """Views matching a spec dict's order/shapes (raises on a mismatch)."""
    out = {}
    for name, spec in specs.items():
        arr = image[name]
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{name}: image shape {arr.shape} != spec {spec.shape}")
        out[name] = arr
    return out

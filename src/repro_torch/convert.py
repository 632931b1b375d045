"""Weight carry-over into torch tensors on a device.

* ``params_from_numpy`` takes parameters as numpy arrays — the reference
  package's (float32, or ``ml_dtypes.bfloat16`` recognised by
  ``arr.dtype.name`` without importing ``ml_dtypes``), or any host arrays.
* ``params_from_image`` takes a loaded image from ``repro_torch.link``,
  whose bfloat16 symbols are 2-byte stand-ins: the dtype comes from the
  spec, never from the stand-in array.

Both COPY: to the device, or into fresh memory on the CPU. They never wrap
an image's arrays (which may be the read-only ``stable-mmap-cached``
mapping) as tensors, so the model can never write into a shared arena.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.specs import ParamSpec, torch_dtype


def _tensor(arr: np.ndarray, dtype: str, shape, device: torch.device) -> torch.Tensor:
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"array shape {arr.shape} != spec shape {tuple(shape)}")
    dt = torch_dtype(dtype)
    if arr.dtype.itemsize != dt.itemsize:
        raise TypeError(f"{arr.dtype} array cannot hold {dtype} values")
    host = np.array(arr, copy=True)                 # writable, owns its memory
    if dt == torch.bfloat16:
        t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(host.view(np.dtype(dtype)))
    return t.to(device)


def params_from_numpy(
    params: Mapping[str, np.ndarray], specs: Mapping[str, ParamSpec], device="cuda"
) -> dict[str, torch.Tensor]:
    """Numpy parameters (e.g. the reference's ``init_params``) -> tensors."""
    dev = resolve_device(device)
    out = {}
    for name, spec in specs.items():
        arr = np.asarray(params[name])
        if arr.dtype.name != spec.dtype:
            raise TypeError(f"{name}: array dtype {arr.dtype.name} != spec {spec.dtype}")
        out[name] = _tensor(arr, spec.dtype, spec.shape, dev)
    return out


def params_from_image(image, specs: Mapping[str, ParamSpec], device="cuda"):
    """A loaded image -> tensors, one per spec name, dtype from the spec."""
    dev = resolve_device(device)
    return {
        name: _tensor(np.asarray(image[name]), spec.dtype, spec.shape, dev)
        for name, spec in specs.items()
    }

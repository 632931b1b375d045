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

* ``params_from_device_image`` takes an image whose arena was built on the
  device (``core/device_arena.py``): its tensors already are torch views of
  an arena that load owns alone, so it checks them and copies nothing.
* ``opt_state_from_numpy`` carries the reference's AdamW state
  (``{"m", "v", "step"}`` of numpy arrays) into the port's, so both
  packages can train on from one state.
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


def params_from_device_image(image, specs: Mapping[str, ParamSpec], device):
    """A device-built image -> its own tensors, checked against ``specs``
    (every name present, shape, dtype and device equal); no copy."""
    dev = torch.device(device)
    out = {}
    for name, spec in specs.items():
        t = image.tensors.get(name)
        if t is None:
            raise KeyError(f"image has no tensor {name!r}")
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != torch_dtype(spec.dtype):
            raise TypeError(f"{name}: image tensor {tuple(t.shape)} {t.dtype} != "
                            f"spec {tuple(spec.shape)} {spec.dtype}")
        if t.device.type != dev.type or (dev.index is not None and t.device != dev):
            raise ValueError(f"{name}: image tensor on {t.device}, engine on {dev}")
        out[name] = t
    return out


def opt_state_from_numpy(state: Mapping, specs: Mapping[str, ParamSpec], device="cuda"):
    """The reference's optimizer state -> the port's: ``{"m": {name: float32
    tensor}, "v": {...}, "step": 0-d int32 tensor}`` on ``device``, one
    moment per spec name, shaped as the spec."""
    dev = resolve_device(device)
    out = {}
    for mv in ("m", "v"):
        out[mv] = {}
        for name, spec in specs.items():
            arr = np.asarray(state[mv][name])
            if arr.dtype != np.float32:
                raise TypeError(f"{mv}/{name}: moments are float32, got {arr.dtype}")
            out[mv][name] = _tensor(arr, "float32", spec.shape, dev)
    step = np.asarray(state["step"])
    if step.size != 1:
        raise ValueError(f"step has {step.size} values")
    out["step"] = torch.tensor(int(step.reshape(())), dtype=torch.int32, device=dev)
    return out

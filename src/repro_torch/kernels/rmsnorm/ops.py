"""RMSNorm: the CUDA C++ kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm/rmsnorm.py``
(``rmsnorm_2d``, body ``_rmsnorm_kernel``; wrapper ``ops.py::rmsnorm``):
per row, ``x * rsqrt(sum(x**2) / d + eps) * scale`` in float32, cast back to
x's dtype. The kernel itself is ``repro_torch/csrc/rmsnorm.cu``; its header
says what bounds it on the H100 and what the design does about that.

The host path is kept lean, because at the decode shapes the call, not the
card, sets the time: the ctypes function's ``argtypes`` are set once, the
rows are a view of ``x`` (read through their stride, no copy), and a call
makes one ``torch.empty`` and one ctypes call, whose ``cudaError_t`` it
checks.

``rmsnorm`` sends tensors on the CPU to ``rmsnorm_plain`` and launches the
kernel for CUDA tensors, or raises; ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

SOURCE = "rmsnorm.cu"
_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib = None          # the ctypes library, bound at the first launch
_fn = None           # its rms_forward, argtypes set once
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def rmsnorm_plain(x, scale, *, eps: float = 1e-6):
    """The kernel's function in plain PyTorch (the reference's formula)."""
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def _bind():
    global _lib, _fn
    from repro_torch.kernels.build import load_library

    lib = load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rms_forward.argtypes = [i32, i32, ptr, ptr, ptr, i64, i32, i64,
                                ctypes.c_float, ptr]
    lib.rms_forward.restype = i32
    lib.rms_error_string.argtypes = [i32]
    lib.rms_error_string.restype = ctypes.c_char_p
    _lib, _fn = lib, lib.rms_forward


def _launch(x, scale, eps):
    global launches
    xc, wc = _CODES.get(x.dtype), _CODES.get(scale.dtype)
    if xc is None or wc is None:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got {x.dtype}/{scale.dtype}")
    d = x.shape[-1]
    dev = x.get_device()
    if scale.shape != (d,) or scale.get_device() != dev or scale.stride(0) != 1:
        raise ValueError(f"scale {tuple(scale.shape)} on {scale.device} does not fit "
                         f"x {tuple(x.shape)} on {x.device}, or is not contiguous")
    if x.is_contiguous():
        rows, out = x, torch.empty_like(x)
        n, stride = (x.numel() // d if d else 0), d
    else:
        rows = x.reshape(-1, d)      # a view wherever the rows allow one
        if rows.stride(1) != 1:
            raise ValueError("rmsnorm kernel takes rows whose elements are contiguous")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        n, stride = rows.shape[0], rows.stride(0)
    if n == 0 or d == 0:
        return out
    if _fn is None:
        _bind()
    err = _fn(xc, wc, rows.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
              stride, eps, _raw_stream(dev))
    if err:
        raise RuntimeError(f"rmsnorm launch failed for x {tuple(x.shape)} {x.dtype}: "
                           f"{_lib.rms_error_string(err).decode()}")
    launches += 1
    return out


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading shape)."""
    if x.is_cuda:
        return _launch(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")

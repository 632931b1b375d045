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

Training: on CUDA, when ``x`` or ``scale`` requires a gradient (and grad
mode is on), ``rmsnorm`` goes through ``_RMSNorm``, whose backward is the
hand-written ``rms_backward`` of the same source: the gradient JAX takes
of the reference's jnp ``rms_norm`` (``repro/models/common.py:25``; the
reference has no Pallas backward). It saves ``x`` and ``scale`` and
recomputes the row's ``rsqrt`` from ``x``; ``dscale`` is summed without
atomics, so it is the same bits on every call. ``backward_launches``
counts its calls (each is two kernels: the rows, then the column sums).
Under ``no_grad`` and ``inference_mode`` the forward call is the lean one
above.

DTensors (a step on a device mesh, ``launch/steps.py``) are unwrapped with
``local_map``, so the kernel only ever sees each device's local rows. The
kernel needs a row whole: rows may stay sharded, but a sharded feature
dimension (or a pending partial sum) is redistributed to whole rows first.
``scale`` is replicated; its gradient is a partial sum over the mesh axes
that shard the rows. ``rmsnorm_backward_plain`` is the closed-form gradient in float32
plain torch, for the tests and ``chip_smoke.py``; on the CPU under grad,
``rmsnorm`` runs the plain forward and this backward as one autograd node
(``_RMSNormPlain``), the same graph as the card's.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.dist.context import is_dtensor

SOURCE = "rmsnorm.cu"
_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
backward_launches = 0
_lib = None          # the ctypes library, bound at the first launch
_fn = None           # its rms_forward, argtypes set once
_bwd = None          # its rms_backward
# rows of the backward's float32 column partials: a sixteenth of the rows
# (the partials stay small beside x, dy and dx), a multiple of 4, 4..4096
_ROWS_PER_PART, _MAX_PARTS = 16, 4096
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def rmsnorm_plain(x, scale, *, eps: float = 1e-6):
    """The kernel's function in plain PyTorch (the reference's formula)."""
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def rmsnorm_backward_plain(x, scale, dy, *, eps: float = 1e-6):
    """(dx, dscale) of ``rmsnorm_plain`` for the output gradient ``dy``, in
    closed form, float32 throughout: with r = rsqrt(mean(x**2) + eps),
    xh = x * r and g = dy * scale, dx = r * (g - xh * mean(g * xh)) and
    dscale = the sum of dy * xh over every row; cast to x's and scale's
    dtypes."""
    xf, g = x.float(), dy.float() * scale.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    dx = r * (g - xh * torch.mean(g * xh, dim=-1, keepdim=True))
    dscale = (dy.float() * xh).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def _bind():
    global _lib, _fn, _bwd
    from repro_torch.kernels.build import load_library

    lib = load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rms_forward.argtypes = [i32, i32, ptr, ptr, ptr, i64, i32, i64,
                                ctypes.c_float, ptr]
    lib.rms_forward.restype = i32
    lib.rms_backward.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64,
                                 i32, i64, ctypes.c_float, ptr]
    lib.rms_backward.restype = i32
    lib.rms_error_string.argtypes = [i32]
    lib.rms_error_string.restype = ctypes.c_char_p
    _lib, _fn, _bwd = lib, lib.rms_forward, lib.rms_backward


def _rows(x, scale):
    """(x dtype code, scale dtype code, rows of x, n, row stride), checked
    for the kernel: the rows are a view of x, read through their stride."""
    xc, wc = _CODES.get(x.dtype), _CODES.get(scale.dtype)
    if xc is None or wc is None:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got {x.dtype}/{scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.get_device() != x.get_device() or scale.stride(0) != 1:
        raise ValueError(f"scale {tuple(scale.shape)} on {scale.device} does not fit "
                         f"x {tuple(x.shape)} on {x.device}, or is not contiguous")
    if x.is_contiguous():
        return xc, wc, x, (x.numel() // d if d else 0), d
    rows = x.reshape(-1, d)          # a view wherever the rows allow one
    if rows.stride(1) != 1:
        raise ValueError("rmsnorm kernel takes rows whose elements are contiguous")
    return xc, wc, rows, rows.shape[0], rows.stride(0)


def _launch(x, scale, eps):
    global launches
    xc, wc, rows, n, stride = _rows(x, scale)
    d = x.shape[-1]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if n == 0 or d == 0:
        return out
    if _fn is None:
        _bind()
    dev = x.get_device()
    err = _fn(xc, wc, rows.data_ptr(), scale.data_ptr(), out.data_ptr(), n, d,
              stride, eps, _raw_stream(dev))
    if err:
        raise RuntimeError(f"rmsnorm launch failed for x {tuple(x.shape)} {x.dtype}: "
                           f"{_lib.rms_error_string(err).decode()}")
    launches += 1
    return out


def _launch_backward(x, scale, dy, eps):
    """(dx, dscale) from the ``rms_backward`` kernel: dx contiguous in x's
    shape and dtype, dscale in scale's dtype."""
    global backward_launches
    xc, wc, rows, n, stride = _rows(x, scale)
    d = x.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not fit x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    dy = dy.contiguous()
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    if n == 0 or d == 0:
        return dx, torch.zeros_like(scale)
    dscale = torch.empty_like(scale)
    parts = min(_MAX_PARTS, max(4, -(-n // _ROWS_PER_PART)))
    parts += -parts % 4
    part = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    if _bwd is None:
        _bind()
    dev = x.get_device()
    err = _bwd(xc, wc, rows.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(),
               dscale.data_ptr(), part.data_ptr(), parts, n, d, stride, eps,
               _raw_stream(dev))
    if err:
        raise RuntimeError(f"rmsnorm backward launch failed for x {tuple(x.shape)} "
                           f"{x.dtype}: {_lib.rms_error_string(err).decode()}")
    backward_launches += 1
    return dx, dscale


class _RMSNorm(torch.autograd.Function):
    """The kernel's forward and its hand-written backward; saves x and
    scale (the backward recomputes the row's rsqrt from x)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _launch_backward(x, scale, dy, ctx.eps)
        return dx, dscale, None


class _RMSNormPlain(torch.autograd.Function):
    """The plain forward and the closed-form plain backward as one autograd
    node, the CPU's counterpart of ``_RMSNorm``: a norm's gradient reaches
    ``x`` as one term, as the kernel's does, so the gradient sums of a
    step are the same whether the norm runs under ``local_map`` (on a
    mesh) or not."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_plain(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        return (*rmsnorm_backward_plain(x, scale, dy, eps=ctx.eps), None)


def _rmsnorm_dtensor(x, scale, eps):
    """``rmsnorm`` on DTensors through ``local_map`` (module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = (x if is_dtensor(x) else scale).device_mesh
    repl = (Replicate(),) * mesh.ndim
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, repl, run_check=False)
    last = x.dim() - 1
    rows = tuple(p if p.is_shard() and p.dim % x.dim() != last else Replicate()
                 for p in x.placements)
    if rows != tuple(x.placements):
        x = x.redistribute(mesh, rows)
    if not is_dtensor(scale):
        scale = DTensor.from_local(scale, mesh, repl, run_check=False)
    elif tuple(scale.placements) != repl:
        scale = scale.redistribute(mesh, repl)
    scale_grad = tuple(Partial() if p.is_shard() else Replicate() for p in rows)
    fn = local_map(functools.partial(rmsnorm, eps=eps), out_placements=list(rows),
                   in_placements=(rows, repl), in_grad_placements=(rows, scale_grad),
                   device_mesh=mesh)
    return fn(x, scale)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading shape)."""
    if is_dtensor(x) or is_dtensor(scale):
        return _rmsnorm_dtensor(x, scale, eps)
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return _RMSNorm.apply(x, scale, eps)
        return _launch(x, scale, eps)
    if x.device.type == "cpu":
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
            return _RMSNormPlain.apply(x, scale, eps)
        return rmsnorm_plain(x, scale, eps=eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")

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
mode is on), ``rmsnorm`` goes through ``_RMSNorm``, whose backward is
hand-written in the same source: the gradient JAX takes of the
reference's jnp ``rms_norm`` (``repro/models/common.py:25``; the reference
has no Pallas backward). It saves ``x`` and ``scale`` and recomputes the
row's ``rsqrt`` from ``x``; ``dscale`` is summed in a fixed order without
float atomics, so it is the same bits on every call. A backward is one
ctypes call on one of two routes, chosen by ``bwd_route`` from the dtype,
d, the row stride and the addresses, never on failure:

* ``"tma"`` (``rms_backward_tma``): rows that TMA can copy (16-byte
  aligned bases, row stride and row bytes; up to 160 16-byte vectors a
  row), every training shape of gemma3-1b. One launch, whose grid
  ``_bwd_plan(n, d, itemsize)`` sets from those three alone, and a ticket
  (one int32 kept per device and stream, ``_bwd_scratch``) that elects
  the last cluster of CTAs to add the column partials.
* ``"two_pass"`` (``rms_backward``): every other row (e.g. d = 7 or 300
  in bf16). Two launches: the rows, then the column sums.

``backward_launches`` counts backward calls, ``backward_launches_by_route``
each route's. Under ``no_grad`` and ``inference_mode`` the forward call is
the lean one above.

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
from typing import NamedTuple

import torch

from repro_torch.dist.context import is_dtensor

SOURCE = "rmsnorm.cu"
_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
backward_launches = 0
backward_launches_by_route = {"tma": 0, "two_pass": 0}
_lib = None          # the ctypes library, bound at the first launch
_fn = None           # its rms_forward, argtypes set once
_bwd = None          # its rms_backward (the two_pass route)
_bwd_tma = None      # its rms_backward_tma (the tma route)
# rows of the two_pass route's float32 column partials: a sixteenth of the
# rows (the partials stay small beside x, dy and dx), a multiple of 4, 4..4096
_ROWS_PER_PART, _MAX_PARTS = 16, 4096
# the tma route's plan (rmsnorm.cu's note); constants, never read from a card
_BWD_CTAS = 264          # two CTAs for each of the H100's 132 SMs
_BWD_CLUSTER = 8         # CTAs a thread block cluster, one partial row each
_BWD_WARPS = 4           # consumer warps a CTA
_BWD_STAGES = 3          # tiles in the ring
_BWD_MAX_VECTORS = 160   # 16-byte vectors a row (a lane holds 5 of x and of dy)
_bwd_scratch_by = {}     # (device index, stream) -> (ticket, partials)
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


class BwdPlan(NamedTuple):
    """The tma route's launch: ``ctas`` CTAs in clusters of ``cluster``,
    ``warps`` consumer warps a CTA (and the producer's), a ring of
    ``stages`` tiles of ``rows_per_stage`` rows of x and of dy,
    ``smem_bytes`` of shared memory a CTA."""
    ctas: int
    cluster: int
    warps: int
    rows_per_stage: int
    stages: int
    smem_bytes: int


def _bwd_plan(n: int, d: int, itemsize: int) -> BwdPlan:
    """The tma route's grid and ring, from (n, d, itemsize) alone: the
    partition is what makes dscale's sums the same on every call. 264 CTAs
    once n allows (every SM of an H100 two), else one a row, rounded up to
    whole clusters. A lane holds up to 5 vectors of a row; a tile holds 4,
    2 or 1 rows for each consumer warp (rmsnorm.cu's tma_rows_per_warp),
    and rows of 3 or more vectors a lane take 2 consumer warps a CTA, not 4
    (their registers leave room for fewer warps on an SM)."""
    lanes = -(-d * itemsize // 16 // 32)            # vectors a lane holds
    warps = _BWD_WARPS if lanes <= 2 else _BWD_WARPS // 2
    rows = warps * (4 if lanes <= 1 else 2 if lanes == 2 else 1)
    ctas = _BWD_CTAS if n >= _BWD_CTAS else -(-n // _BWD_CLUSTER) * _BWD_CLUSTER
    smem = _BWD_STAGES * 2 * rows * d * itemsize + 16 * _BWD_STAGES + 16
    return BwdPlan(ctas, _BWD_CLUSTER, warps, rows, _BWD_STAGES, smem)


def bwd_route(rows, dy, scale, stride: int) -> str:
    """``"tma"`` where the backward's rows can go through TMA: ``rows``
    (whose ``data_ptr`` is x's first row, of d = ``rows.shape[-1]``
    elements, ``stride`` elements apart) and ``dy`` on 16-byte aligned
    bases, the row stride and row bytes multiples of 16, at most
    ``_BWD_MAX_VECTORS`` vectors a row (whose ring always fits a CTA's
    shared memory), and scale aligned wherever the forward needs that for
    its 16-byte path (so r is the forward's, bit for bit); else
    ``"two_pass"``."""
    size, d = rows.element_size(), rows.shape[-1]
    vec = 16 // size
    ok = (d % vec == 0 and d // vec <= _BWD_MAX_VECTORS and stride % vec == 0
          and stride >= d and rows.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
          and (scale.element_size() != size or scale.data_ptr() % 16 == 0))
    return "tma" if ok else "two_pass"


def _bwd_scratch(device, stream: int, numel: int):
    """(ticket, float32 partials of at least ``numel``) kept for this
    device and stream: the ticket is zeroed once and every launch leaves it
    at 0; two streams never share one."""
    key = (device.index, stream)
    got = _bwd_scratch_by.get(key)
    if got is None or got[1].numel() < numel:
        ticket = got[0] if got else torch.zeros(1, dtype=torch.int32, device=device)
        got = _bwd_scratch_by[key] = (
            ticket, torch.empty(numel, dtype=torch.float32, device=device))
    return got


def _bind():
    global _lib, _fn, _bwd, _bwd_tma
    from repro_torch.kernels.build import load_library

    lib = load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rms_forward.argtypes = [i32, i32, ptr, ptr, ptr, i64, i32, i64,
                                ctypes.c_float, ptr]
    lib.rms_forward.restype = i32
    lib.rms_backward.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i64,
                                 i32, i64, ctypes.c_float, ptr]
    lib.rms_backward.restype = i32
    lib.rms_backward_tma.argtypes = [i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64,
                                     i32, i64, i32, i32, i32, i32, i32, ctypes.c_float,
                                     ptr]
    lib.rms_backward_tma.restype = i32
    lib.rms_error_string.argtypes = [i32]
    lib.rms_error_string.restype = ctypes.c_char_p
    _lib, _fn, _bwd, _bwd_tma = lib, lib.rms_forward, lib.rms_backward, lib.rms_backward_tma


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


def _two_pass(xc, wc, rows, dy, scale, dx, dscale, n, d, stride, eps, stream) -> int:
    """The two_pass route's launches (the rows, then the column sums) into
    ``dx`` and ``dscale``; its cudaError_t (0 = launched). The arguments
    are ``_launch_backward``'s, checked there."""
    parts = min(_MAX_PARTS, max(4, -(-n // _ROWS_PER_PART)))
    parts += -parts % 4
    part = torch.empty((parts, d), dtype=torch.float32, device=dx.device)
    return _bwd(xc, wc, rows.data_ptr(), dy.data_ptr(), scale.data_ptr(), dx.data_ptr(),
                dscale.data_ptr(), part.data_ptr(), parts, n, d, stride, eps, stream)


def _launch_backward(x, scale, dy, eps):
    """(dx, dscale) from the backward kernel on ``bwd_route``'s route: dx
    contiguous in x's shape and dtype, dscale in scale's dtype."""
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
    if _bwd is None:
        _bind()
    stream = _raw_stream(x.get_device())
    route = bwd_route(rows, dy, scale, stride)
    if route == "tma":
        plan = _bwd_plan(n, d, x.element_size())
        ticket, part = _bwd_scratch(x.device, stream, plan.ctas // plan.cluster * d)
        err = _bwd_tma(xc, wc, rows.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                       dx.data_ptr(), dscale.data_ptr(), part.data_ptr(),
                       ticket.data_ptr(), n, d, stride, plan.ctas, plan.cluster,
                       plan.warps, plan.rows_per_stage, plan.stages, eps, stream)
    else:
        err = _two_pass(xc, wc, rows, dy, scale, dx, dscale, n, d, stride, eps, stream)
    if err:
        raise RuntimeError(f"rmsnorm backward launch ({route}) failed for x "
                           f"{tuple(x.shape)} {x.dtype}: "
                           f"{_lib.rms_error_string(err).decode()}")
    backward_launches += 1
    backward_launches_by_route[route] += 1
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

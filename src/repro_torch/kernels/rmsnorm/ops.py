"""RMSNorm: the Triton kernel, its wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm/rmsnorm.py``
(``rmsnorm_2d``, body ``_rmsnorm_kernel``; wrapper ``ops.py::rmsnorm``):
per row, ``x * rsqrt(sum(x**2) / d + eps) * scale`` in float32, cast back to
x's dtype. Padded columns never count: the sum is divided by the true d.

What bounds it on the H100: memory. It reads each element once and writes
it once (a few flops per element, far below the card's ~295 flop/byte
ridge), so the bound is ``2 * N * d * itemsize`` bytes at 3.35 TB/s. The
design keeps the row in registers between the reduction and the scale, so x
crosses device memory once each way: a program takes ``BLOCK_R`` whole rows
as one ``(BLOCK_R, BLOCK_D)`` tile, ``BLOCK_D = next_pow2(d)`` with masked
loads, rows read through their stride (the last position of a sequence
needs no copy), ``BLOCK_R`` sized so a tile holds about 4096 elements. At the
serving shapes the calls are small (decode: 4 rows of 1152), so launch
overhead, not bandwidth, decides their time.

``rmsnorm`` sends tensors on the CPU to ``rmsnorm_plain`` and launches the
kernel for CUDA tensors, or raises; ``launches`` counts kernel launches.
``triton`` is imported at the first launch, never at import.

Status: this kernel has run on an H100, held against ``rmsnorm_plain`` by
``chip_smoke.py`` at the reference's sweep shapes and the serving shapes;
PERF.md has its times.
"""

import torch

_DTYPES = (torch.float32, torch.bfloat16)
TILE_ELEMS = 4096

launches = 0
_kernel = None       # the @triton.jit function, defined at first launch


def rmsnorm_plain(x, scale, *, eps: float = 1e-6):
    """The kernel's function in plain PyTorch (the reference's formula)."""
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(dt)


def _define_kernel():
    # triton resolves the kernel's globals (``tl``) in this module's dict,
    # so they are bound here, at the first launch, and never at import
    import triton
    import triton.language

    globals()["tl"] = triton.language

    @triton.jit
    def _rmsnorm_fwd(x_ptr, s_ptr, o_ptr, n_rows, d, x_row_stride, eps,
                     BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = (tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        x = tl.load(x_ptr + rows[:, None] * x_row_stride + cols[None, :],
                    mask=mask, other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=1) / d          # masked columns load as 0
        y = x * tl.rsqrt(ms + eps)[:, None]
        s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = y * s[None, :]
        tl.store(o_ptr + rows[:, None] * d + cols[None, :],
                 y.to(o_ptr.dtype.element_ty), mask=mask)

    return _rmsnorm_fwd


def _launch(x, scale, eps):
    global launches, _kernel
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes float32/bfloat16, got {x.dtype}/{scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.device != x.device:
        raise ValueError(f"scale {tuple(scale.shape)} on {scale.device} does not fit x {tuple(x.shape)} on {x.device}")
    x2 = x.reshape(-1, d)            # a view wherever the rows allow one
    if x2.stride(1) != 1:
        raise ValueError("rmsnorm kernel takes rows whose elements are contiguous")
    scale = scale.contiguous()
    out = torch.empty(x2.shape, dtype=x.dtype, device=x.device)
    n = x2.shape[0]
    if n == 0:
        return out.reshape(x.shape)
    if _kernel is None:
        _kernel = _define_kernel()
    block_d = 1 << max(0, (d - 1).bit_length())
    block_r = max(1, min(64, TILE_ELEMS // block_d))
    grid = ((n + block_r - 1) // block_r,)
    _kernel[grid](x2, scale, out, n, d, x2.stride(0), eps,
                  BLOCK_R=block_r, BLOCK_D=block_d, num_warps=4)
    launches += 1
    return out.reshape(x.shape)


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` (any leading shape)."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    return _launch(x, scale, eps)

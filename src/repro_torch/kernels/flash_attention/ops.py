"""Flash attention: the CUDA C++ kernels' wrapper and their plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py`` (``flash_attention_bhsd``, body ``_flash_kernel``;
wrapper ``ops.py::flash_attention``). The kernels themselves are in
``repro_torch/csrc/flash_attention.cu``; its header says what bounds them
on the H100 and what each design does about that.

``flash_attention`` takes the model layout ``(B, S, H, hd)`` for q and
``(B, Sk, KV, hd)`` for k and v, as the reference wrapper does:

* tensors on the CPU go to ``flash_attention_plain`` (the tests' path);
* tensors on a CUDA device launch a kernel, or raise — there is no
  fallback to the plain version or from one kernel to the other.

The kernel is chosen by argument, never on failure: ``route(dtype, hd)``
gives ``"wgmma"`` (the tensor-core kernel: bf16 at hd 64, 128, 224 or
256; hd 224 runs on the hd-256 tile with TMA's zero fill past column 224)
or ``"simt"`` (the CUDA-core kernel: float32 at hd 16, 32, 64, 128 or 256,
bf16 at hd 16 or 32), and raises on anything else (float32 at hd 224
too: no served path needs it). The wgmma route reads its inputs
with TMA, so ``tma_strides`` also checks that each base pointer is 16-byte
aligned and each stride a multiple of 16 bytes, and raises otherwise.

DTensors (a step on a device mesh, ``launch/steps.py``) are unwrapped by
``dist.heads.on_local_heads``, so a kernel only ever sees each device's
local shard: batch and heads may stay sharded, the sequence and head_dim
are whole, and each device's K and V hold the KV heads its query heads read.

``launches`` counts kernel launches (plain-version calls do not count);
``launches_by_route`` counts them per route, and ``launches_non_causal``
those with ``causal=False`` (an encoder-decoder's cross-attention).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.dist.context import is_dtensor
from repro_torch.dist.heads import on_local_heads

NEG_INF = -(2.0**30)       # finite on purpose: masked softmax stays NaN-free
SOURCE = "flash_attention.cu"
WGMMA_HEAD_DIMS = (64, 128, 224, 256)
HEAD_DIMS = (16, 32, 64, 128, 256)       # the simt route's, in both dtypes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
launches_by_route = {"wgmma": 0, "simt": 0}
launches_non_causal = 0
_lib = None          # the ctypes library, loaded at first launch


def route(dtype, hd: int) -> str:
    """Which kernel serves q/k/v of ``dtype`` at head_dim ``hd``:
    ``"wgmma"`` for bf16 at hd 64/128/224/256, ``"simt"`` for float32 at any
    hd of ``HEAD_DIMS`` and bf16 at hd 16/32. Raises on anything else."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention kernels take float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and hd in WGMMA_HEAD_DIMS:
        return "wgmma"
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} has no {str(dtype).removeprefix('torch.')} "
                         f"kernel: wgmma takes bf16 at {WGMMA_HEAD_DIMS}, simt "
                         f"{HEAD_DIMS}")
    return "simt"


def tma_strides(t: torch.Tensor, name: str = "tensor") -> tuple[int, int, int]:
    """The (batch, seq, head) strides, in elements, under which the wgmma
    route's TMA maps read a bf16 ``(B, S, heads, hd)`` tensor. TMA needs a
    16-byte aligned base, a contiguous head_dim and every other stride a
    positive multiple of 16 bytes; a size-1 axis gets the stride it would
    have if the tensor were contiguous (its coordinate is always 0). Raises
    ValueError on anything TMA cannot take."""
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (B, S, heads, hd), got {tuple(t.shape)}")
    size = t.element_size()
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base pointer {t.data_ptr():#x} is not 16-byte "
                         "aligned, which TMA needs")
    if t.shape[3] > 1 and t.stride(3) != 1:
        raise ValueError(f"{name}: head_dim axis must be contiguous")
    out, inner = [], t.shape[3]
    for axis in (2, 1, 0):
        stride = t.stride(axis) if t.shape[axis] > 1 else inner
        if stride <= 0 or (stride * size) % 16:
            raise ValueError(f"{name}: stride {t.stride(axis)} of axis {axis} is not a "
                             "positive multiple of 16 bytes, which TMA needs")
        out.append(stride)
        inner *= t.shape[axis]
    return out[2], out[1], out[0]


def flash_attention_plain(q, k, v, *, causal=True, window=0, q_offset=0):
    """The kernel's function in plain PyTorch: materialized scores and
    softmax, all in float32, output in q's dtype (as the kernel: f32
    accumulate, one cast at the end)."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kf = k.float().repeat_interleave(g, dim=2) if g > 1 else k.float()
    vf = v.float().repeat_interleave(g, dim=2) if g > 1 else v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * hd**-0.5
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= q_pos - k_pos < window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load_library

        lib = load_library(SOURCE)
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        shape = [i32] * 5 + [i64] * 12 + [i32, i32, i32, ctypes.c_float, ptr]
        lib.fa_forward_simt.argtypes = [i32, i32, ptr, ptr, ptr, ptr] + shape
        lib.fa_forward_simt.restype = i32
        lib.fa_forward_wgmma.argtypes = [i32, ptr, ptr, ptr, ptr] + shape
        lib.fa_forward_wgmma.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    kind = route(q.dtype, hd)
    if kind == "wgmma":
        if k.shape[1] == 0:
            raise ValueError("the wgmma route takes at least one key")
        return kind, [s for name, t in (("q", q), ("k", k), ("v", v))
                      for s in tma_strides(t, name)]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous")
    return kind, [t.stride(i) for t in (q, k, v) for i in (0, 1, 2)]


def _launch(q, k, v, causal, window, q_offset):
    global launches, launches_non_causal
    kind, strides = _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o
    lib = _library()
    strides += [o.stride(i) for i in (0, 1, 2)]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, sk, h, kvh, *strides,
            int(causal), int(window), int(q_offset), float(hd**-0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if kind == "wgmma":
        err = lib.fa_forward_wgmma(hd, *args)
    else:
        err = lib.fa_forward_simt(_DTYPE_CODES[q.dtype], hd, *args)
    if err != 0:
        raise RuntimeError(
            f"flash_attention ({kind}) launch failed: {lib.fa_error_string(err).decode()}"
        )
    launches += 1
    launches_by_route[kind] += 1
    if not causal:
        launches_non_causal += 1
    return o


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd) attention, GQA by index.

    The kernel is forward-only, as the reference's is: off the CPU, a call
    that autograd would have to differentiate raises rather than return a
    tensor detached from the graph."""
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return on_local_heads(functools.partial(flash_attention, causal=causal,
                                                window=window, q_offset=q_offset), q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, q_offset=q_offset
        )
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention's kernel is forward-only and cannot be "
            "differentiated: train with impl='chunked', as the reference's "
            "TrainConfig does")
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal, window, q_offset)

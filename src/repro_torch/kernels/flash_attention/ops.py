"""Flash attention: the CUDA C++ kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/
flash_attention.py`` (``flash_attention_bhsd``, body ``_flash_kernel``;
wrapper ``ops.py::flash_attention``). The kernel itself is
``repro_torch/csrc/flash_attention.cu``; its header says what bounds it on
the H100 and what the design does about that.

``flash_attention`` takes the model layout ``(B, S, H, hd)`` for q and
``(B, Sk, KV, hd)`` for k and v, as the reference wrapper does:

* tensors on the CPU go to ``flash_attention_plain`` (the tests' path);
* tensors on a CUDA device launch the kernel, or raise — there is no
  fallback to the plain version.

``launches`` counts kernel launches (plain-version calls do not count).
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -(2.0**30)       # finite on purpose: masked softmax stays NaN-free
SOURCE = "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
_lib = None          # the ctypes library, loaded at first launch


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
        lib.fa_forward.argtypes = (
            [i32, i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32]
            + [i64] * 12
            + [i32, i32, i32, ctypes.c_float, ptr]
        )
        lib.fa_forward.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k, v):
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} v{tuple(v.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"q{tuple(q.shape)} does not match k{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s head_dim axis must be contiguous")


def _launch(q, k, v, causal, window, q_offset):
    global launches
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if o.numel() == 0:
        return o
    lib = _library()
    strides = [
        t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2)
    ]
    err = lib.fa_forward(
        _DTYPE_CODES[q.dtype], hd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, sq, sk, h, kvh, *strides,
        int(causal), int(window), int(q_offset), float(hd**-0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.fa_error_string(err).decode()}"
        )
    launches += 1
    return o


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """(B,Sq,H,hd) x (B,Sk,KV,hd) -> (B,Sq,H,hd) attention, GQA by index."""
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, q_offset=q_offset
        )
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _launch(q, k, v, causal, window, q_offset)

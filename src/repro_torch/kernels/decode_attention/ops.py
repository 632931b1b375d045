"""Decode attention: the CUDA C++ kernel's wrapper and its plain version.

Single-token attention against a KV cache, the function of the
reference's ``decode_attention`` (``repro/models/common.py``), which is an
XLA einsum and no Pallas kernel. The kernel is
``repro_torch/csrc/decode_attention.cu``; its header says what bounds it
on the H100 (bytes) and what its split-KV design does about that.

q is ``(B, 1, H, hd)``, the caches ``(B, S, KV, hd)``, and ``pos`` an int
shared by every row or a ``(B,)`` integer tensor (int64 for the kernel)
on q's device, one position per row. A row attends to its cache rows ``j <= pos`` (all S once
``pos >= S - 1``), GQA against the unexpanded cache, scores and softmax in
float32, the output in q's dtype.

* tensors on the CPU go to ``decode_attention_plain`` (the tests' path);
* tensors on a CUDA device launch the kernel, or raise: there is no
  fallback. It takes float32 and bfloat16 at any head_dim up to 256 that
  is a multiple of a 16-byte vector, caches whose head_dim is contiguous
  and whose base and other strides are 16-byte multiples (a per-layer view
  of the stacked cache is read in place), and rows ``pos >= 0``;
* DTensors (a step on a device mesh) are unwrapped by
  ``dist.heads.on_local_heads``, so the kernel sees each device's own heads,
  and a per-row ``pos`` is cut as q's batch is.

The host path is kept lean, because the decode step it serves is paced by
the host's issue: the ctypes function's ``argtypes`` are set once, the
launch plan is cached by shape, and a call makes one ``torch.empty`` (the
output, and the splits' float32 scratch behind it) and one ctypes call,
whose ``cudaError_t`` it checks. ``launches`` counts kernel calls (one a
call, whether or not the splits' combine runs).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.dist.context import is_dtensor
from repro_torch.dist.heads import on_local_heads

NEG_INF = -(2.0**30)       # the plain version's finite mask, as the reference's
SOURCE = "decode_attention.cu"
MAX_HEAD_DIM = 256
_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOG2E = 1.0 / math.log(2.0)
# the launch plan (decode_attention.cu's note); constants, never read from a card
_THREADS = 128           # a CTA's threads
_TARGET_CTAS = 264       # splits enough for two CTAs on each of the H100's 132 SMs
_MAX_CHUNK = 256         # cache rows a CTA once the grid is that full
_SMEM_BYTES = 48 * 1024  # a CTA's shared memory without an opt-in

launches = 0
_lib = None          # the ctypes library, bound at the first launch
_fn = None           # its da_forward, argtypes set once
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def decode_attention_plain(q, k_cache, v_cache, pos):
    """The kernel's function in plain PyTorch: GQA as a grouped einsum
    against the unexpanded cache, scores in float32 (the reference's
    ``preferred_element_type=f32``), rows past ``pos`` masked."""
    b, s, kvh, hd = k_cache.shape
    h = q.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * hd**-0.5
    if isinstance(pos, torch.Tensor):
        valid = torch.arange(s, device=q.device)[None, :] <= pos[:, None]
        valid = valid[:, None, None, None, :]           # (B,1,1,1,S)
    else:
        valid = torch.arange(s, device=q.device) <= pos
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)


class Plan(NamedTuple):
    """A launch: ``lpr`` lanes a cache row, each holding ``nv`` 16-byte
    vectors of it; ``group`` query heads a CTA (of the g that share a KV
    head); ``rows`` cache rows a CTA loads in one pass; ``chunk`` rows a
    CTA; ``nsplit`` CTAs along the cache; ``smem_bytes`` a CTA's shared
    memory."""
    lpr: int
    nv: int
    group: int
    rows: int
    chunk: int
    nsplit: int
    smem_bytes: int


@functools.lru_cache(maxsize=1024)
def plan(itemsize: int, hd: int, g: int, b: int, kvh: int, s: int) -> Plan:
    """The launch for caches of ``s`` rows of ``kvh`` heads of ``hd``
    elements of ``itemsize`` bytes, ``g`` query heads a KV head, ``b``
    rows: from the shape alone, so a shape always runs the same sums. A
    chunk is a multiple of ``rows``, sized so that the grid holds about
    ``_TARGET_CTAS`` CTAs, up to ``_MAX_CHUNK`` rows (or one pass, if
    that is more)."""
    vectors = hd * itemsize // 16
    nv = 1 if vectors <= 32 else 2
    lpr = 32 if nv == 2 else 1 << (vectors - 1).bit_length()
    group = next(x for x in (8, 4, 2, 1) if g % x == 0)
    rows = _THREADS // lpr * (2 if nv == 2 or group == 8 else 4)
    ctas = b * kvh * (g // group)
    chunk = min(max(-(-s * ctas // _TARGET_CTAS), rows), max(_MAX_CHUNK, rows))
    chunk = -(-chunk // rows) * rows
    smem = 4 * (_THREADS // lpr) * group * (hd + 2)
    return Plan(lpr, nv, group, rows, chunk, -(-s // chunk), smem)


def _bind():
    global _lib, _fn
    from repro_torch.kernels.build import load_library

    lib = load_library(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.da_forward.argtypes = ([i32, i32, i32] + [ptr] * 6 + [i64] + [i32] * 8
                               + [i64] * 8 + [ctypes.c_float, ptr])
    lib.da_forward.restype = i32
    lib.da_error_string.argtypes = [i32]
    lib.da_error_string.restype = ctypes.c_char_p
    _lib, _fn = lib, lib.da_forward


def _check(q, k, v, pos):
    """(dtype code, per-row positions or None, shared position, and the
    strides of q, k and v), checked for the kernel; raises on anything it
    cannot take. Every check reads shapes, strides and addresses the call
    already has: it runs on each call of the decode step's host path."""
    code = _CODES.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16 q, k and v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or qs[1] != 1 or len(ks) != 4 or v.shape != ks:
        raise ValueError(f"bad shapes q{tuple(qs)} k{tuple(ks)} v{tuple(v.shape)}")
    b, _, h, hd = qs
    s, kvh = ks[1], ks[2]
    if ks[0] != b or ks[3] != hd or kvh == 0 or h % kvh or s == 0:
        raise ValueError(f"q{tuple(qs)} does not match k{tuple(ks)}")
    dev = q.get_device()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError("q, k and v must be on one device")
    vec = 16 // q.element_size()
    if hd > MAX_HEAD_DIM or hd % vec:
        raise ValueError(f"head_dim {hd} has no decode_attention kernel: it takes "
                         f"multiples of {vec} up to {MAX_HEAD_DIM} in {q.dtype}")
    qst, kst, vst = q.stride(), k.stride(), v.stride()
    if qst[3] != 1 or kst[3] != 1 or vst[3] != 1:
        raise ValueError("q's, k's and v's head_dim axes must be contiguous")
    for name, t, st in (("k", k, kst), ("v", v, vst)):
        if t.data_ptr() % 16 or (b > 1 and st[0] % vec) or (s > 1 and st[1] % vec) or (
                kvh > 1 and st[2] % vec):
            raise ValueError(f"{name}: base or strides {st} are not 16-byte multiples, "
                             "which the kernel's vector loads need")
    if not isinstance(pos, torch.Tensor):
        return code, None, int(pos), qst, kst, vst
    if pos.shape != (b,) or pos.get_device() != dev:
        raise ValueError(f"pos {tuple(pos.shape)} on {pos.device} does not fit q "
                         f"{tuple(qs)} on {q.device}")
    if pos.dtype != torch.int64:
        raise TypeError(f"per-row positions must be int64, got {pos.dtype}")
    return code, pos, 0, qst, kst, vst


def _launch(q, k, v, code, rows, pos_all, qst, kst, vst):
    global launches
    b, _, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    size = q.element_size()
    p = plan(size, hd, h // kvh, b, kvh, s)
    n_out = b * h * hd
    off = -(-n_out * size // 256) * 256
    scratch = 4 * b * h * p.nsplit * (hd + 2) if p.nsplit > 1 else 0
    buf = torch.empty((off + scratch) // size, dtype=q.dtype, device=q.device)
    out = buf.as_strided((b, 1, h, hd), (h * hd, h * hd, hd, 1))
    if n_out == 0:
        return out
    if _fn is None:
        _bind()
    base = buf.data_ptr()
    err = _fn(code, p.nv, p.group, q.data_ptr(), k.data_ptr(), v.data_ptr(), base,
              base + off if scratch else None, None if rows is None else rows.data_ptr(),
              pos_all, b, s, kvh, h // kvh, hd, p.lpr, p.chunk, p.nsplit, qst[0], qst[2],
              kst[0], kst[1], kst[2], vst[0], vst[1], vst[2], hd**-0.5 * _LOG2E,
              _raw_stream(q.get_device()))
    if err:
        raise RuntimeError(f"decode_attention launch failed for q {tuple(q.shape)} k "
                           f"{tuple(k.shape)} {q.dtype}: "
                           f"{_lib.da_error_string(err).decode()}")
    launches += 1
    return out


def decode_attention(q, k_cache, v_cache, pos):
    """(B,1,H,hd) x (B,S,KV,hd) -> (B,1,H,hd) attention of one new token
    per row to its cache rows ``j <= pos``. Forward-only, as the
    reference's decode is: off the CPU, a call that autograd would have to
    differentiate raises."""
    if is_dtensor(q) or is_dtensor(k_cache) or is_dtensor(v_cache):
        if isinstance(pos, torch.Tensor):
            return on_local_heads(decode_attention, q, k_cache, v_cache, pos)
        return on_local_heads(functools.partial(decode_attention, pos=pos),
                              q, k_cache, v_cache)
    if q.is_cpu:
        return decode_attention_plain(q, k_cache, v_cache, pos)
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        raise RuntimeError("decode_attention's kernel is forward-only and cannot be "
                           "differentiated")
    checked = _check(q, k_cache, v_cache, pos)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return _launch(q, k_cache, v_cache, *checked)

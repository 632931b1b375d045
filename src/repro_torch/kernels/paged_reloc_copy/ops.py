"""Paged relocation copy: the CUDA C++ kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/paged_reloc_copy/
paged_reloc_copy.py`` (``paged_reloc_copy``, body ``_copy_kernel``;
wrappers ``ops.py::apply_page_table``, ``as_pages``, ``pages_to_bytes``;
oracle ``ref.py::paged_reloc_copy_ref``): ``arena[dst[i]] = blob[src[i]]``
over 4096-byte pages viewed as ``(8, 128)`` int32, in place. Pages the
table does not name keep their bytes; ``n == 0`` returns the arena as it
is. The kernel itself is ``repro_torch/csrc/paged_reloc_copy.cu``; its
header says what bounds it on the H100 and what the design does about it.

``paged_reloc_copy(blob, arena, src, dst)`` takes ``blob`` ``(P, 8, 128)``
and ``arena`` ``(Q, 8, 128)`` int32 tensors on one device, and the page
table ``src``/``dst`` as host index arrays (numpy or CPU tensors: the
table is host numpy before upload). Before anything runs it checks on the
host that every ``src < P``, every ``dst < Q`` and ``dst`` is unique — an
index out of range would be a memory fault on the card, not a wrong
answer. Then:

* tensors on the CPU go to ``paged_reloc_copy_plain`` (the tests' path);
* tensors on a CUDA device upload the two index arrays and launch the
  kernel, or raise — there is no fallback to the plain version.

``launches`` counts kernel launches (plain-version calls do not count).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.objects import PAGE_BYTES

PAGE_ELEMS = PAGE_BYTES // 4            # int32 elements per page
PAGE_SHAPE = (8, PAGE_ELEMS // 8)       # (8, 128), the reference's page view
SOURCE = "paged_reloc_copy.cu"

launches = 0
_lib = None          # the ctypes library, loaded at first launch


def as_pages(buf, n_pages: int) -> np.ndarray:
    """bytes -> (n_pages, 8, 128) int32 pages (zero-padded)."""
    raw = np.frombuffer(bytes(buf), dtype=np.uint8)
    out = np.zeros(n_pages * PAGE_BYTES, np.uint8)
    out[: raw.size] = raw
    return out.view(np.int32).reshape((n_pages,) + PAGE_SHAPE)


def pages_to_bytes(pages) -> bytes:
    if isinstance(pages, torch.Tensor):
        pages = pages.detach().cpu().numpy()
    return np.asarray(pages).view(np.int32).tobytes()


def _index(idx, device) -> torch.Tensor:
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(idx), dtype=torch.int64).to(device)


def paged_reloc_copy_plain(blob, arena, src, dst):
    """The kernel's function in plain PyTorch: ``arena[dst] = blob[src]``
    in place; returns ``arena``. Indices may be host arrays or tensors."""
    src, dst = _index(src, arena.device), _index(dst, arena.device)
    if src.numel():
        arena[dst] = blob[src]
    return arena


def check_table(src, dst, blob_pages: int, arena_pages: int):
    """Host check of a page table before any copy: 1-D, equal lengths,
    ``0 <= src < blob_pages``, ``0 <= dst < arena_pages`` and ``dst``
    unique. Returns both as int32 numpy arrays."""
    src = np.asarray(src.cpu() if isinstance(src, torch.Tensor) else src)
    dst = np.asarray(dst.cpu() if isinstance(dst, torch.Tensor) else dst)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be 1-D of one length")
    if src.size == 0:
        return src.astype(np.int32), dst.astype(np.int32)
    if src.dtype.kind not in "iu" or dst.dtype.kind not in "iu":
        raise TypeError(f"page indices must be integers, got {src.dtype}/{dst.dtype}")
    if src.min() < 0 or src.max() >= blob_pages:
        raise IndexError(f"src page out of range [0, {blob_pages}): "
                         f"[{src.min()}, {src.max()}]")
    if dst.min() < 0 or dst.max() >= arena_pages:
        raise IndexError(f"dst page out of range [0, {arena_pages}): "
                         f"[{dst.min()}, {dst.max()}]")
    if np.bincount(dst, minlength=arena_pages).max() > 1:
        raise ValueError("dst pages must be unique (one write per arena page)")
    return src.astype(np.int32), dst.astype(np.int32)


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import load_library

        lib = load_library(SOURCE)
        ptr = ctypes.c_void_p
        lib.prc_copy.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int64, ptr]
        lib.prc_copy.restype = ctypes.c_int
        lib.prc_error_string.argtypes = [ctypes.c_int]
        lib.prc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(blob, arena):
    for name, t in (("blob", blob), ("arena", arena)):
        if t.dtype != torch.int32 or t.dim() != 3 or tuple(t.shape[1:]) != PAGE_SHAPE:
            raise ValueError(f"{name} must be (pages, 8, 128) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if blob.device != arena.device:
        raise ValueError(f"blob on {blob.device}, arena on {arena.device}")


def launch(blob, arena, src_dev, dst_dev):
    """Launch the kernel on index arrays already on the card and already
    checked by ``check_table`` (int32, contiguous). Returns ``arena``."""
    global launches
    n = src_dev.numel()
    if n == 0:
        return arena
    for t in (blob, arena):
        if t.data_ptr() % 16:
            raise ValueError("blob and arena must be 16-byte aligned")
    lib = _library()
    err = lib.prc_copy(
        blob.data_ptr(), arena.data_ptr(), src_dev.data_ptr(), dst_dev.data_ptr(),
        n, torch.cuda.current_stream(arena.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"paged_reloc_copy launch failed: {lib.prc_error_string(err).decode()}"
        )
    launches += 1
    return arena


def paged_reloc_copy(blob, arena, src, dst):
    """``arena[dst[i]] = blob[src[i]]`` over whole pages, in place; returns
    ``arena``."""
    _check(blob, arena)
    src, dst = check_table(src, dst, blob.shape[0], arena.shape[0])
    if src.size == 0:
        return arena
    if arena.device.type == "cpu":
        return paged_reloc_copy_plain(blob, arena, src, dst)
    if arena.device.type != "cuda":
        raise ValueError(f"paged_reloc_copy: no kernel for device {arena.device}")
    src_dev = torch.from_numpy(src).to(arena.device)
    dst_dev = torch.from_numpy(dst).to(arena.device)
    return launch(blob, arena, src_dev, dst_dev)


def apply_page_table(pt, blob, arena):
    """Execute a compiled ``PageTable`` (``core/relocation.py``) on page
    tensors; returns ``arena``, updated in place."""
    return paged_reloc_copy(blob, arena, pt.src_page, pt.dst_page)

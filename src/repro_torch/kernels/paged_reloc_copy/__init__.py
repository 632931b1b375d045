"""Paged relocation copy for Hopper: CUDA C++ kernel
(``csrc/paged_reloc_copy.cu``) behind ``ops.paged_reloc_copy``, with its
plain PyTorch version beside it. The device epoch loader
(``core/device_arena.py``) builds every table-driven arena with it."""

from . import ops
from .ops import (
    PAGE_ELEMS,
    PAGE_SHAPE,
    apply_page_table,
    as_pages,
    pages_to_bytes,
    paged_reloc_copy,
    paged_reloc_copy_plain,
)

__all__ = [
    "PAGE_ELEMS",
    "PAGE_SHAPE",
    "apply_page_table",
    "as_pages",
    "ops",
    "pages_to_bytes",
    "paged_reloc_copy",
    "paged_reloc_copy_plain",
]

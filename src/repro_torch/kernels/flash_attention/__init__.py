"""Flash attention for Hopper: CUDA C++ kernel (``csrc/flash_attention.cu``)
behind ``ops.flash_attention``, with its plain PyTorch version beside it."""

from . import ops
from .ops import flash_attention, flash_attention_plain

__all__ = ["ops", "flash_attention", "flash_attention_plain"]

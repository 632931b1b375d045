"""Decode attention for Hopper: a CUDA C++ kernel
(``csrc/decode_attention.cu``) behind ``ops.decode_attention``, with its
plain PyTorch version beside it."""

from . import ops
from .ops import decode_attention, decode_attention_plain

__all__ = ["ops", "decode_attention", "decode_attention_plain"]

"""RMSNorm for Hopper: a CUDA C++ kernel (``csrc/rmsnorm.cu``) behind
``ops.rmsnorm``, with its plain PyTorch version beside it."""

from . import ops
from .ops import rmsnorm, rmsnorm_plain

__all__ = ["ops", "rmsnorm", "rmsnorm_plain"]

"""RMSNorm for Hopper: a Triton kernel behind ``ops.rmsnorm``, with its
plain PyTorch version beside it."""

from . import ops
from .ops import rmsnorm, rmsnorm_plain

__all__ = ["ops", "rmsnorm", "rmsnorm_plain"]

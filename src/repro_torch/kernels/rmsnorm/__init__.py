"""RMSNorm for Hopper: a CUDA C++ kernel (``csrc/rmsnorm.cu``) behind
``ops.rmsnorm``, with a hand-written backward kernel for training, and the
plain PyTorch versions of both beside them."""

from . import ops
from .ops import rmsnorm, rmsnorm_backward_plain, rmsnorm_plain

__all__ = ["ops", "rmsnorm", "rmsnorm_backward_plain", "rmsnorm_plain"]

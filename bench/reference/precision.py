"""Products and norms of the references, in float32 or a lower precision.

``control(dtype)`` names the precision just below the one a configuration
states: float8 (e4m3) below bfloat16 or float16, bfloat16 below float32,
float32 below float64. In ``"fp8"`` both operands of every product are
rounded to e4m3 with a scale per row of the activations and per output
column of the weights (448 is e4m3's largest finite value), then
multiplied in float32. Norms, softmax, rotary phases and the scan stay in
float32 in every precision.
"""

from __future__ import annotations

import torch

_BELOW = {"float64": "f32", "float32": "bf16", "bfloat16": "fp8", "float16": "fp8"}
E4M3_MAX = 448.0


def control(dtype: str) -> str:
    return _BELOW[dtype]


def no_tf32() -> None:
    """A float32 product is a float32 product, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) in float32 after rounding to ``prec``."""
    if prec == "f32":
        return x.float() @ w.float()
    if prec == "bf16":
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()
    if prec == "fp8":
        return _fp8(x.float(), -1) @ _fp8(w.float(), 0)
    raise ValueError(f"unknown precision {prec!r}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()

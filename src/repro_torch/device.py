"""Device selection for the port's entry points, and dtype names.

There is no fallback: ``device="cuda"`` (every entry point's default)
raises when no card is present, and the CPU runs only when asked for
(``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and there is
    no card. On CUDA it also turns TF32 off for matmuls and cuDNN, so a
    float32 product is a full float32 product as it is in the reference."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """A dtype name of specs and arena slots ("bfloat16", "float32", ...)
    -> the torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return dt

"""zamba2-7b: hybrid 81L Mamba2 + shared attn [arXiv:2411.15242; unverified].

Selectable via ``--arch zamba2-7b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import ZAMBA2_7B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

"""starcoder2-3b: dense 30L GQA kv=2 RoPE [arXiv:2402.19173; hf].

Selectable via ``--arch starcoder2-3b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import STARCODER2_3B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

"""qwen2-moe-a2.7b: moe 24L 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Selectable via ``--arch qwen2-moe-a2.7b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import QWEN2_MOE_A27B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

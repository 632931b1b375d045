"""qwen1.5-110b: dense 80L QKV-bias GQA kv=8 [hf:Qwen/Qwen1.5-0.5B; hf].

Selectable via ``--arch qwen1.5-110b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import QWEN15_110B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

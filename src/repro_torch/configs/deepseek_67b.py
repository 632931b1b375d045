"""deepseek-67b: dense 95L llama-arch GQA kv=8 [arXiv:2401.02954; hf].

Selectable via ``--arch deepseek-67b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import DEEPSEEK_67B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

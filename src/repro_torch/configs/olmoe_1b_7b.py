"""olmoe-1b-7b: moe 16L 64e top-8 [arXiv:2409.02060; hf].

Selectable via ``--arch olmoe-1b-7b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import OLMOE_1B_7B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

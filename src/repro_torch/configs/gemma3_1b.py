"""gemma3-1b: dense 26L 5:1 local:global sliding window [hf:google/gemma-3-1b-pt; unverified].

Selectable via ``--arch gemma3-1b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import GEMMA3_1B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

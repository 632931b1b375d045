"""seamless-m4t-large-v2: audio enc-dec 24L+24L [arXiv:2308.11596; hf].

Selectable via ``--arch seamless-m4t-large-v2``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import SEAMLESS_M4T_LARGE_V2 as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

"""chameleon-34b: vlm 48L early-fusion VQ tokens [arXiv:2405.09818; unverified].

Selectable via ``--arch chameleon-34b``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import CHAMELEON_34B as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

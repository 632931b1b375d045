"""mamba2-370m: ssm 48L SSD state=128 [arXiv:2405.21060; unverified].

Selectable via ``--arch mamba2-370m``; reduced smoke variant via ``reduced(CONFIG)``.
"""

from .archs import MAMBA2_370M as CONFIG
from .base import reduced

SMOKE = reduced(CONFIG)

__all__ = ["CONFIG", "SMOKE"]

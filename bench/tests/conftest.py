"""The benchmark's own tests: ``python -m pytest bench/tests`` from the root
of the repository (CPU, a few minutes). Tests marked ``cuda`` run on the
card and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

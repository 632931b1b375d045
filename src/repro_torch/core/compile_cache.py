"""AOT compile cache — the compute-side relocation table.

The second late-binding tax an ML job pays at startup is compiling its
programs. Stable linking's discipline applies verbatim: the program
(architecture x shape x mesh) cannot change during an epoch, so its compiled
form can be materialized at end_mgmt and *loaded* at job start.

Keys are content hashes over (program key, mesh key, world hash). This
copy keeps the in-memory half of the reference package's cache only: the
reference serializes AOT-compiled XLA executables to disk, and the port's
steps run eagerly (the multi-device layer included: ``launch/steps.py``
builds placed steps, not compiled ones), so there is nothing to
serialize; every miss compiles and is recorded as ``"compiled"`` in the
stats (benchmarks stay honest). The natural thing for the AOT half to
cache is a captured CUDA graph of a step, which waits for ROADMAP Queue B2
item 3. ``Workspace`` constructs one so its API keeps its shape.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional


def cache_key(*parts: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()


@dataclass
class CompileStats:
    key: str = ""
    source: str = ""          # "memory" | "compiled"
    lower_s: float = 0.0
    compile_s: float = 0.0


@dataclass
class CompileCache:
    root: Path
    memory: dict[str, Any] = field(default_factory=dict)

    def get_or_compile(
        self,
        key: str,
        lower_fn: Callable[[], Any],
        *,
        stats: Optional[CompileStats] = None,
    ):
        """Return a compiled executable for ``key``.

        ``lower_fn`` must return an object with a ``compile()`` method
        (called only on a cache miss); the result is cached in memory.
        """
        stats = stats if stats is not None else CompileStats()
        stats.key = key
        if key in self.memory:
            stats.source = "memory"
            return self.memory[key], stats

        t0 = time.perf_counter()
        lowered = lower_fn()
        stats.lower_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        compiled = lowered.compile()
        stats.compile_s = time.perf_counter() - t1
        stats.source = "compiled"
        self.memory[key] = compiled
        return compiled, stats

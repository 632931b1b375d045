"""AOT compile cache — the compute-side relocation table.

The second late-binding tax an ML job pays at startup is compiling its
programs. Stable linking's discipline applies verbatim: the program
(architecture x shape x mesh) cannot change during an epoch, so it is
compiled once and *loaded* at every later start of the job.

Keys are content hashes over the program's identity (``cache_key``, the
reference's bytes). On the card the compiled form is a captured CUDA graph
of the training step (``train/program.py``): a fixed sequence of kernels
over buffers at fixed places, which replays without Python, autograd or
DTensor dispatch, as an XLA executable runs without its tracer. A captured
graph has no form that outlives its process, so this cache keeps the
reference's own fallback for a backend whose executables cannot be
serialized: it caches in memory only. ``source`` is ``"compiled"`` on a
miss and ``"memory"`` on a hit; ``"disk"`` never occurs, ``path`` names
where a serialized executable would lie and nothing is written there, and
``deserialize_s`` stays 0.0. ``Workspace`` constructs one, and the
``Trainer`` compiles its step through it.
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
    source: str = ""          # "disk" | "memory" | "compiled"
    lower_s: float = 0.0
    compile_s: float = 0.0
    deserialize_s: float = 0.0


@dataclass
class CompileCache:
    root: Path
    memory: dict[str, Any] = field(default_factory=dict)

    def path(self, key: str) -> Path:
        """Where a serialized executable for ``key`` would lie (never
        written: a captured graph has no serialized form)."""
        return Path(self.root) / f"{key[:32]}.graph"

    def get(self, key: str):
        """The executable cached for ``key``, or None; no stats, no compile
        (a caller that must place its inputs for a hit looks first)."""
        return self.memory.get(key)

    def get_or_compile(
        self,
        key: str,
        lower_fn: Callable[[], Any],
        *,
        stats: Optional[CompileStats] = None,
    ):
        """Return ``(executable, stats)`` for ``key``.

        ``lower_fn`` must return an object with a ``compile()`` method
        (both called only on a cache miss); the result is cached in memory.
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

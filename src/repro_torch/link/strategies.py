"""The load-strategy registry: loaders selected by name, drop-in extensible.

A strategy is a callable ``(executor, app, world) -> image`` registered
under a short name. ``Executor.load`` (and therefore ``Workspace.load``)
dispatches through this table instead of hard-coded branches, so

* benchmarks sweep strategies by name (``for s in available_strategies()``),
* new loaders (prefetch variants, tiered-storage readers, ...) plug in with
  ``@register_strategy("name")`` and immediately work everywhere,
* an unknown name fails with a ``StableLinkingError`` that lists what is
  registered.

Built-ins mirror the paper's Figure 5 (and push past it):

    stable      — table-driven epoch load (the contribution)
    stable-mmap — baked-arena epoch load: one copy-on-write mmap, zero
                  resolve / table parse / payload copy (requires
                  ``bake_arenas`` materialization, the default)
    stable-mmap-cached — epoch-resident load: repeat loads are EpochCache
                  hits serving prebuilt READ-ONLY views over one process-
                  shared mapping (fleet replicas share a single arena
                  mapping; mutate via ``stable-mmap`` instead)
    stable-shm  — cross-process epoch-resident load: the baked arena is
                  published once into a named POSIX shm segment and every
                  worker PROCESS attaches to that one physical copy
                  (``core/shm_arena.py``); read-only like the cached
                  strategy, guarded by the epoch token + closure key +
                  sidecar generation stamp
    stable-remote — tiered-store epoch load: the baked arena is found in
                  ``tables/``, the local store cache, or fetched (verified,
                  resumable, retried) from a remote served store — then
                  published/attached exactly like ``stable-shm``. With no
                  store attached it degrades to the local tiers, so the
                  benchmark sweep and a baking machine need no server
                  (``core/arena_store.py``; attach via ``ws.attach_store``
                  or ``ws.warmup(..., store=...)``)
    dynamic     — traditional dynamic linking (baseline; untouched so
                  benchmarks keep a faithful ld.so comparison point)
    indexed     — dynamic-shaped load resolving through the per-closure
                  symbol index (O(1) per ref)
    lazy        — per-symbol first-use faulting (PLT analogue, §6.2)
    prefetch    — stable + OS readahead hints on provider payloads (drop-in
                  variant, demonstrating the registry)

``auto`` is not a strategy but a dispatch rule: indexed during management
time (correct while the world is in flux, without the ld.so probe cost),
stable during an epoch.

Device arenas: the table-driven strategies (``stable``, ``prefetch``,
``dynamic``, ``indexed``, hence ``auto``) are registered with
``takes_device=True`` and accept ``device=`` — the executor then builds the
arena on that device with the ``paged_reloc_copy`` kernel
(``core/device_arena.py``) — and ``into=``, an earlier device image whose
arena the load overwrites in place (a trainer's compiled step owns it).
The baked-arena strategies and ``lazy`` take no device (``DEVICE_TODO``);
``Executor.load`` raises ``ValueError`` for them.

Blue/green rollover: the epoch-resident strategies (``stable-mmap-cached``,
``stable-shm``) are generation-addressed — their cache keys hash the app's
dependency closure, so a commit anywhere lands generation N+1 under *new*
keys while images already loaded from generation N keep serving untouched
(their cache entries survive the token bump as *retired* until
``ws.gc(drain=True)``). A serving loop flips between the two at a request
boundary via the ``ws.epoch_watch()`` / ``engine.adopt_epoch()`` handshake
(``serve/scheduler.py``): in-flight requests finish on N, new admissions
load from N+1 — no strategy ever observes a half-committed world.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Callable, Optional

from repro_torch.core.errors import UnknownStrategyError
from repro_torch.core.manager import Mode

# name -> (executor, app, world) -> LoadedImage | LazyImage
LoadStrategy = Callable[[object, object, object], object]

_STRATEGIES: dict[str, LoadStrategy] = {}

DEVICE_TODO = (
    "device arenas for the baked-arena strategies and lazy are ROADMAP "
    "Queue A item 13"
)


def register_strategy(
    name: str, fn: Optional[LoadStrategy] = None, *, takes_device: bool = False
):
    """Register a load strategy; usable as decorator or plain call.

    Re-registering a name replaces it (latest wins), so tests and notebooks
    can shadow built-ins locally. ``takes_device=True`` declares that the
    strategy accepts ``device=`` (a fourth, keyword argument) and builds its
    arena there, and ``into=`` (an earlier device image to load into; passed
    only when the caller gives one).
    """

    def _register(f: LoadStrategy) -> LoadStrategy:
        if takes_device:
            f.takes_device = True
        _STRATEGIES[name] = f
        return f

    return _register(fn) if fn is not None else _register


def unregister_strategy(name: str) -> None:
    _STRATEGIES.pop(name, None)


@contextmanager
def strategy_overrides(**strategies: Optional[LoadStrategy]):
    """Scoped strategy shadowing: snapshot the registry, apply ``name=fn``
    overrides (``name=None`` unregisters), and restore the exact previous
    registry on exit — even on exception.

    Bare ``register_strategy``/``unregister_strategy`` mutate process-global
    state: a test that shadows ``stable`` and forgets to restore it poisons
    every later test and benchmark sweep in the process. Use this instead::

        with strategy_overrides(stable=my_instrumented_stable):
            ws.load("app")          # dispatches to the shadow
        # built-in `stable` is back, along with anything else touched
    """
    saved = dict(_STRATEGIES)
    try:
        for name, fn in strategies.items():
            if fn is None:
                _STRATEGIES.pop(name, None)
            else:
                _STRATEGIES[name] = fn
        yield
    finally:
        _STRATEGIES.clear()
        _STRATEGIES.update(saved)


def snapshot_strategies() -> dict[str, LoadStrategy]:
    """Copy of the current registry (test fixtures snapshot/restore it)."""
    return dict(_STRATEGIES)


def restore_strategies(snapshot: dict[str, LoadStrategy]) -> None:
    _STRATEGIES.clear()
    _STRATEGIES.update(snapshot)


def available_strategies() -> list[str]:
    return sorted(_STRATEGIES)


def get_strategy(name: str) -> LoadStrategy:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise UnknownStrategyError(name, available_strategies()) from None


def resolve_strategy(name: str, *, mode: Mode) -> LoadStrategy:
    """Dispatch rule used by ``Executor.load``: resolve ``auto`` by mode,
    everything else by registry lookup."""
    if name == "auto":
        name = "indexed" if mode == Mode.MANAGEMENT else "stable"
    return get_strategy(name)


def strategy_takes_device(name: str, *, mode: Mode) -> bool:
    """Whether ``name`` (``auto`` resolved by ``mode``) builds device arenas."""
    return getattr(resolve_strategy(name, mode=mode), "takes_device", False)


# ------------------------------------------------------------------ built-ins
@register_strategy("stable", takes_device=True)
def _stable(executor, app, world, device=None, into=None):
    return executor._load_stable(app, world, device, into)


@register_strategy("stable-mmap")
def _stable_mmap(executor, app, world):
    return executor._load_stable_mmap(app, world)


@register_strategy("stable-mmap-cached")
def _stable_mmap_cached(executor, app, world):
    return executor._load_stable_mmap_cached(app, world)


@register_strategy("stable-shm")
def _stable_shm(executor, app, world):
    return executor._load_stable_shm(app, world)


@register_strategy("stable-remote")
def _stable_remote(executor, app, world):
    return executor._load_stable_remote(app, world)


@register_strategy("dynamic", takes_device=True)
def _dynamic(executor, app, world, device=None, into=None):
    return executor._load_dynamic(app, world, device, into)


@register_strategy("indexed", takes_device=True)
def _indexed(executor, app, world, device=None, into=None):
    return executor._load_indexed(app, world, device, into)


@register_strategy("lazy")
def _lazy(executor, app, world):
    # Wired through the per-closure binding cache: the first image pays the
    # PLT-analogue resolver per symbol, later images bind in O(1).
    return executor.lazy_image(app, world)


@register_strategy("prefetch", takes_device=True)
def _prefetch(executor, app, world, device=None, into=None):
    """Stable load preceded by OS readahead hints on every payload in the
    app's dependency closure — useful when payloads are cold on networked
    or spinning storage. The closure walk reads only manifests (no table
    parse, no payload bytes); platforms without posix_fadvise degrade to a
    plain stable load."""
    fadvise = getattr(os, "posix_fadvise", None)
    if fadvise is not None:
        from repro_torch.core.resolver import dependency_closure

        for obj in dependency_closure(app, world):
            payload = executor.registry.payload_path(obj)
            if not payload.exists():
                continue
            fd = os.open(payload, os.O_RDONLY)
            try:
                fadvise(fd, 0, 0, os.POSIX_FADV_WILLNEED)
            finally:
                os.close(fd)
    return executor._load_stable(app, world, device, into)

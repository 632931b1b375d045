"""Process-wide epoch-resident cache: map each arena once per epoch.

The stable-mmap strategy makes a single load one copy-on-write mmap; this
module makes the *second and every later* load of the same (app, closure) a dictionary hit.
The paper's thesis — relocation work belongs at the epoch boundary, not on
each execution — is pushed one rung further: within an epoch, everything a
load needs that is constant for the epoch (the parsed sidecar, the shared
read-only arena mapping, the prebuilt slot views, the per-closure symbol
index, the lazy-binding map, the provider payload mmaps) is resolved once
per process and then served from memory.

Design:

* **One cache per process** (``process_cache()``): serving replicas, test
  fixtures, and benchmark sweeps in the same interpreter all share it, so N
  same-process replicas of an application share ONE read-only arena mapping
  (the MAP_SHARED analogue) instead of N private ones.

* **Keys are content-addressed and root-scoped.** Entries are keyed by
  ``(registry root, app hash, closure hash)`` (plus a section name), so two
  workspaces over different stores never alias, while repeated loads within
  a store always do.

* **Epoch-token generations (retire, don't flash-clear).** The cache
  carries a monotonically increasing epoch token; every ``Manager.end_mgmt``
  (any workspace in the process) and every ``Workspace.gc`` bumps it.
  Entries record the token they were filled under and are treated as misses
  once it moves on — one integer compare makes the whole old generation
  invisible to reads without walking it. The token is the process-local
  image of the store's ``epoch_gen``, so an entry is logically keyed by
  ``(root, app hash, closure hash, generation)``. A bump *retires* the old
  generation instead of clobbering it: unpinned stale entries are dropped
  immediately, but entries still pinned — arena mappings handed out to
  live images, i.e. requests in flight on generation N — stay resident
  (invisible to new reads) until their pins drain or ``drain_retired()``
  reclaims them after the fleet has flipped to N+1. Content-addressed keys
  make stale *data* impossible; the token exists so that entries whose
  backing files were rewritten, repaired, or garbage-collected at a
  management boundary are re-validated against disk instead of trusted
  forever.

* **Capacity-bounded LRU**. Entries carry per-entry byte accounting
  (``cache_nbytes`` on the value, an ``nbytes`` hint at publish, or the
  value's own ``.nbytes``), and the cache enforces an optional global
  ``cache_bytes`` budget by evicting least-recently-used entries — the
  large-fleet alternative to growing without bound between management
  commits. Entries that are *pinned* — an explicit ``pin()`` count, or a
  value whose ``cache_pinned`` property is true (arena entries whose shared
  views are mapped out to live images) — are never evicted; the invariant
  is therefore: resident bytes <= ``cache_bytes`` OR every resident entry
  is pinned. An epoch-token bump drops the old generation's *unpinned*
  entries at once and retires the pinned remainder (see above); LRU paces
  the steady state within a generation.

* **Lock-free reads, double-checked-lock fills.** A hit is a dict lookup
  plus one integer compare plus an LRU touch (each a single GIL-atomic
  operation; no lock acquired). A miss takes a per-key fill lock,
  re-checks, builds, and publishes — concurrent loads of the same app
  during a fleet warm-start perform exactly one fill, while fills of
  *different* keys proceed in parallel.

Sections in use (see ``core/executor.py``):

    ``arena``         — ``ArenaEntry``: parsed sidecar + shared read-only
                        arena mapping + prebuilt slot views (stable-mmap /
                        stable-mmap-cached).
    ``shm-arena``     — ``shm_arena.ShmArenaEntry``: the cross-process
                        variant over a named POSIX shm segment (stable-shm).
    ``symbol-index``  — per-closure ``SymbolIndex`` (indexed resolution;
                        replaces the Executor-private index cache).
    ``indexed-table`` — the ``RelocationTable`` an indexed load resolves,
                        so repeat indexed loads skip resolve + table build.
    ``lazy-bindings`` — per-closure symbol -> Relocation maps, so second-
                        and-later lazy binds are O(1) dict hits.
    ``payload``       — provider payload mmaps, shared across loads.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional, Union

import numpy as np

# per-entry size hint: an int, or a callable applied to the built value
NbytesHint = Optional[Union[int, Callable[[Any], int]]]


@dataclass
class CacheStats:
    """Counters for observability (all monotone; reads are racy-but-safe)."""

    hits: int = 0
    fills: int = 0
    invalidations: int = 0   # epoch-token bumps
    evictions: int = 0       # LRU evictions (budget / section-cap)

    def snapshot(self) -> dict:
        return {
            "hits": self.hits,
            "fills": self.fills,
            "invalidations": self.invalidations,
            "evictions": self.evictions,
        }


@dataclass
class ArenaEntry:
    """One baked arena, resident for the epoch.

    ``shared_views()`` lazily maps the arena read-only ONCE per entry
    (``mode="r"``) and prebuilds the slot views over it — handing them out
    afterwards is a dict copy, not 128 slice/view/reshape calls. The build
    is deferred so processes that only ever use ``stable-mmap`` (private
    copy-on-write mappings per load, ``Executor._load_stable_mmap``) never
    pay for — or keep resident — a shared mapping they don't read.

    LRU contract: the entry accounts for ``arena_size`` bytes and is
    pinned (never evicted) from the moment its shared views are built —
    live images alias that one mapping, so evicting it would only force a
    second mapping of the same bytes. Un-mapped entries (stable-mmap's
    sidecar-only use) stay evictable and rebuild cheaply.
    """

    path: Path                       # .arena image on disk
    meta: dict                       # parsed sidecar (staleness guards etc.)
    slot_items: list                 # (name, offset, nbytes, dtype, shape)
    arena_size: int
    kernels: dict
    sidecar_stat: tuple              # (mtime_ns, size) of the sidecar at fill
    ro_arena: Optional[np.ndarray] = None          # built by shared_views()
    tensors: Optional[dict[str, np.ndarray]] = None
    _views_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )

    @property
    def cache_nbytes(self) -> int:
        return self.arena_size

    @property
    def cache_pinned(self) -> bool:
        return self.tensors is not None   # mapped out to live images

    def shared_views(self) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """The shared read-only mapping + prebuilt slot views, built on
        first use (double-checked: concurrent callers build once)."""
        tensors = self.tensors
        if tensors is not None:
            return self.ro_arena, tensors
        with self._views_lock:
            if self.tensors is not None:
                return self.ro_arena, self.tensors
            if self.arena_size:
                # .view(np.ndarray) drops the memmap subclass (mapping stays
                # alive via .base): the per-slot views below skip numpy's
                # memmap __array_finalize__, and writes still fault (the
                # WRITEABLE flag carries over from mode="r").
                ro = (
                    np.memmap(self.path, dtype=np.uint8, mode="r")
                    .view(np.ndarray)[: self.arena_size]
                )
            else:
                ro = np.empty(0, dtype=np.uint8)
            self.ro_arena = ro
            self.tensors = {
                name: ro[off : off + nbytes].view(dt).reshape(shape)
                for name, off, nbytes, dt, shape in self.slot_items
            }
            return self.ro_arena, self.tensors


class _CacheEntry:
    __slots__ = ("token", "value", "nbytes", "pins")

    def __init__(self, token: int, value: Any, nbytes: int):
        self.token = token
        self.value = value
        self.nbytes = nbytes
        self.pins = 0


class _SectionView:
    """Dict-shaped view of one cache section (token checks included).

    Exists so code written against a plain ``dict`` cache — notably
    ``IndexedResolver(index_cache=...)`` and ``Executor._prune_caches`` —
    can be pointed at the process-wide cache unchanged.
    """

    def __init__(self, cache: "EpochCache", section: str):
        self._cache = cache
        self._section = section

    def get(self, key, default=None):
        hit = self._cache.get(self._section, key)
        return default if hit is None else hit

    def __getitem__(self, key):
        hit = self._cache.get(self._section, key)
        if hit is None:
            raise KeyError(key)
        return hit

    def __setitem__(self, key, value) -> None:
        self._cache.put(self._section, key, value)

    def __contains__(self, key) -> bool:
        return self._cache.get(self._section, key) is not None

    def __len__(self) -> int:
        return self._cache._section_counts.get(self._section, 0)

    def clear(self) -> None:
        self._cache.clear_section(self._section)


class EpochCache:
    """Process-wide epoch-resident LRU cache (see module docstring).

    Thread-safety contract: ``get`` is lock-free (one dict read + one int
    compare + one LRU touch under the GIL); ``get_or_fill`` serializes
    fill functions per key via double-checked locking, so concurrent loads fill
    each entry exactly once; ``bump_epoch`` flash-invalidates every entry
    at once. Byte accounting, pinning, and eviction all happen under one
    mutex on the (rare) publish/invalidate paths.
    """

    def __init__(
        self,
        *,
        max_section_entries: int = 512,
        cache_bytes: Optional[int] = None,
    ):
        self._mu = threading.Lock()              # guards entries + accounting
        self._fill_locks: dict = {}
        # (section, key) -> _CacheEntry, least-recently-used first
        self._entries: "OrderedDict[tuple, _CacheEntry]" = OrderedDict()
        self._section_counts: dict[str, int] = {}
        self._bytes = 0
        self._token = 0
        self.max_section_entries = max_section_entries
        # Global resident-byte budget (None = unbounded). Enforced by LRU
        # eviction of unpinned entries at publish time; see class docstring
        # for the pinned-entries escape hatch.
        self.cache_bytes = cache_bytes
        self.stats = CacheStats()

    # ---------------------------------------------------------------- token
    @property
    def token(self) -> int:
        """The current epoch token. Entries filled under an older token are
        invisible to every read."""
        return self._token

    def bump_epoch(self) -> int:
        """Start a new generation (one integer increment) and retire the
        old one.

        Called by ``Manager.end_mgmt`` — any management commit in the
        process — and by ``Workspace.gc`` after deleting store entries.
        Every stale-token entry is invisible to reads the moment the token
        moves; *unpinned* stale entries (nothing alive references them) are
        dropped immediately, while pinned ones — arena mappings aliased by
        live images, i.e. requests still finishing on the old generation —
        stay resident as *retired* entries until their pins drain
        (``unpin``) or an explicit ``drain_retired()`` after the fleet has
        flipped. The fill-lock table is dropped wholesale (per-key locks
        are recreated on demand). A fill racing this bump publishes under
        its pre-bump token and is simply discarded.
        """
        with self._mu:
            self._token += 1
            for k in list(self._entries):
                e = self._entries.get(k)
                if e is not None and e.token != self._token \
                        and not self._is_pinned(e):
                    self._remove_locked(k)
            self._fill_locks.clear()
            self.stats.invalidations += 1
            return self._token

    def drain_retired(self) -> int:
        """Reclaim every retired (stale-token) entry, pinned or not.

        The request-boundary contract makes this safe: callers invoke it
        only once no in-flight work reads the old generation (the serve
        loop flips at ``n_active == 0``; ``Workspace.gc(drain=True)`` is
        the operator's explicit end-of-drain). Live numpy views an image
        already handed out keep their mappings alive via their own
        references — dropping the cache entry just stops the *cache*
        keeping the old generation resident. Returns the number of entries
        reclaimed."""
        with self._mu:
            n = 0
            for k in list(self._entries):
                e = self._entries.get(k)
                if e is not None and e.token != self._token:
                    self._remove_locked(k)
                    n += 1
            return n

    def retired_count(self) -> int:
        """Stale-token entries still resident (pinned through the bump)."""
        tok = self._token
        return sum(
            1 for e in list(self._entries.values()) if e.token != tok
        )

    def retired_bytes(self) -> int:
        """Accounted bytes held by retired entries (drain reclaims these)."""
        tok = self._token
        return sum(
            e.nbytes for e in list(self._entries.values()) if e.token != tok
        )

    def generations(self) -> dict[int, dict]:
        """Entry count + accounted bytes per resident token generation.

        Observability over the retire chain: back-to-back commits leave
        SEVERAL retired generations draining at once (each pinned by its
        own in-flight requests); this names each one so an operator — or
        ``Workspace.gc(dry_run=True)`` — can see exactly what a drain
        would reclaim, per generation."""
        out: dict[int, dict] = {}
        tok = self._token
        for e in list(self._entries.values()):
            g = out.setdefault(
                e.token,
                {"entries": 0, "bytes": 0, "retired": e.token != tok},
            )
            g["entries"] += 1
            g["bytes"] += e.nbytes
        return out

    # ---------------------------------------------------------------- reads
    def get(self, section: str, key) -> Optional[Any]:
        """Lock-free read: returns the entry or None (miss / stale token).
        A hit touches the LRU order (most-recently-used last)."""
        k = (section, key)
        e = self._entries.get(k)
        if e is not None and e.token == self._token:
            try:
                self._entries.move_to_end(k)
            except KeyError:
                pass  # raced an eviction/invalidation: still a valid hit
            self.stats.hits += 1
            return e.value
        return None

    # ---------------------------------------------------------------- fills
    def put(self, section: str, key, value, *, nbytes: NbytesHint = None) -> None:
        """Publish ``value`` under the *current* token."""
        self._publish(section, key, value, self._token, nbytes)

    def get_or_fill(
        self, section: str, key, build: Callable[[], Any],
        *, nbytes: NbytesHint = None,
    ) -> Any:
        """The double-checked-lock fill path.

        The token is captured *before* ``build`` runs: if a management
        commit lands mid-build, the publish is discarded and the next read
        refills — a cached entry can never outlive the epoch it was built
        in (the built value is still returned to this caller).
        """
        hit = self.get(section, key)
        if hit is not None:
            return hit
        with self._fill_lock(section, key):
            hit = self.get(section, key)
            if hit is not None:
                return hit
            token = self._token
            value = build()
            self._publish(section, key, value, token, nbytes)
            self.stats.fills += 1
            return value

    @staticmethod
    def _sizeof(value, nbytes: NbytesHint) -> int:
        if nbytes is not None:
            return int(nbytes(value)) if callable(nbytes) else int(nbytes)
        v = getattr(value, "cache_nbytes", None)
        if v is not None:
            return int(v)
        v = getattr(value, "nbytes", None)   # ndarrays / payload mmaps
        if isinstance(v, (int, np.integer)):
            return int(v)
        return 0

    @staticmethod
    def _is_pinned(e: _CacheEntry) -> bool:
        return e.pins > 0 or bool(getattr(e.value, "cache_pinned", False))

    def _publish(
        self, section: str, key, value, token: int, nbytes: NbytesHint = None
    ) -> None:
        with self._mu:
            if token != self._token:
                return  # born stale (commit landed mid-build): discard
            k = (section, key)
            old = self._entries.pop(k, None)
            if old is not None:
                self._bytes -= old.nbytes
                self._section_counts[section] -= 1
            e = _CacheEntry(token, value, self._sizeof(value, nbytes))
            self._entries[k] = e
            self._bytes += e.nbytes
            self._section_counts[section] = (
                self._section_counts.get(section, 0) + 1
            )
            self._evict_locked(section)

    def _evict_locked(self, section: str) -> None:
        """Enforce the per-section entry cap and the global byte budget by
        evicting least-recently-used *unpinned* entries. Invariant on
        return: bytes <= cache_bytes, or every resident entry is pinned.

        Iteration only ever walks ``list(self._entries)`` snapshots: the
        lock-free ``get`` calls ``move_to_end`` WITHOUT holding ``_mu``,
        which would invalidate a live OrderedDict iterator mid-scan
        (``list()`` is a single C call, atomic under the GIL)."""
        if self._section_counts.get(section, 0) > self.max_section_entries:
            for k in list(self._entries):
                e = self._entries.get(k)
                if e is None or k[0] != section or self._is_pinned(e):
                    continue
                self._remove_locked(k)
                self.stats.evictions += 1
                if (
                    self._section_counts.get(section, 0)
                    <= self.max_section_entries
                ):
                    break
        if self.cache_bytes is None:
            return
        while self._bytes > self.cache_bytes:
            victim = None
            for k in list(self._entries):   # LRU order, snapshot per pass
                e = self._entries.get(k)
                if e is not None and not self._is_pinned(e):
                    victim = k
                    break
            if victim is None:
                break  # everything resident is pinned: budget may overshoot
            self._remove_locked(victim)
            self.stats.evictions += 1

    def _remove_locked(self, k: tuple) -> None:
        e = self._entries.pop(k)
        self._bytes -= e.nbytes
        n = self._section_counts.get(k[0], 1) - 1
        if n:
            self._section_counts[k[0]] = n
        else:
            self._section_counts.pop(k[0], None)

    # ------------------------------------------------------------- pinning
    def pin(self, section: str, key) -> bool:
        """Pin one live entry against eviction (counted; see ``unpin``).
        Returns False when there is no current-token entry to pin."""
        with self._mu:
            e = self._entries.get((section, key))
            if e is None or e.token != self._token:
                return False
            e.pins += 1
            return True

    def unpin(self, section: str, key) -> None:
        with self._mu:
            e = self._entries.get((section, key))
            if e is not None and e.pins > 0:
                e.pins -= 1
                # a retired entry whose pins just drained has no readers
                # left by contract: reclaim it now, not at the next drain
                if e.token != self._token and not self._is_pinned(e):
                    self._remove_locked((section, key))

    # -------------------------------------------------------- invalidation
    def invalidate(self, section: str, key) -> None:
        """Drop one entry (e.g. its backing file failed re-validation)."""
        with self._mu:
            if (section, key) in self._entries:
                self._remove_locked((section, key))

    def clear_section(self, section: str) -> None:
        with self._mu:
            # snapshot first: a lock-free get()'s move_to_end must not
            # invalidate this scan (see _evict_locked)
            for k in [k for k in list(self._entries) if k[0] == section]:
                if k in self._entries:
                    self._remove_locked(k)

    def clear(self) -> None:
        """Drop everything (tests; equivalent to a token bump + walk)."""
        with self._mu:
            self._entries.clear()
            self._section_counts.clear()
            self._bytes = 0
            self._fill_locks.clear()

    # ------------------------------------------------------------- plumbing
    def section(self, name: str) -> _SectionView:
        """A dict-shaped view of one section (for dict-cache call sites)."""
        return _SectionView(self, name)

    def _fill_lock(self, section: str, key) -> threading.Lock:
        with self._mu:
            return self._fill_locks.setdefault(
                (section, key), threading.Lock()
            )

    def resident_bytes(self) -> int:
        """Accounted bytes currently resident (pinned entries included)."""
        return self._bytes

    def entry_count(self, section: str) -> int:
        """Live (current-token) entries in a section (tests/observability)."""
        tok = self._token
        return sum(
            1
            for k, e in list(self._entries.items())
            if k[0] == section and e.token == tok
        )


# The process-wide instance. Every Executor defaults to it, which is what
# makes N same-process replicas share one arena mapping; tests that need
# isolation construct their own EpochCache and pass it down.
_PROCESS_CACHE = EpochCache()


def process_cache() -> EpochCache:
    """The process-wide ``EpochCache`` singleton."""
    return _PROCESS_CACHE

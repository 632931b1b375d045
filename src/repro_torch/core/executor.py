"""The Executor (§4.2): materialization + epoch/management-time loading.

Three modes of operation, exactly as the paper's Figure 5:

* ``materialize``  — invoked by the Manager at ``end_mgmt``: resolves each
  application once (via the indexed resolver — O(1) per ref instead of the
  ld.so linear probe) and stores the observed relocation mapping as a flat
  table keyed by (app hash, closure hash).  Keying by *closure* hash — the
  digest of the app's dependency-closure content hashes — makes the step
  incremental: a publish only invalidates apps whose closure actually
  changed; everything else keeps its table (``tables_reused``).  The
  remaining apps fan out over a thread pool (``materialize_workers``).
* epoch load       — loads the stored table, verifies freshness, and applies
  relocations with grouped *sequential* reads per provider (the paper's
  prefetch-friendly access pattern), entirely skipping symbol search.
* management load  — falls back to per-load resolution so behaviour stays
  correct while the world is in flux (``auto`` now dispatches to the
  ``indexed`` strategy there; ``dynamic`` remains the untouched baseline).

**Baked arenas** push the paper's thesis to its floor: with
``bake_arenas=True`` (default) materialization also *pre-applies* the
relocation table into a page-aligned ``.arena`` image beside it, so the
``stable-mmap`` strategy's epoch load is a single copy-on-write
``np.memmap`` plus view construction — zero resolve, zero table parse, zero
payload copy.  The sidecar carries ``check_fresh``-style staleness guards
(app hash + closure hash), so a baked arena can never be applied under the
wrong world.

**The epoch-resident runtime** (``core/epoch_cache.py``) amortizes what is
left: every Executor shares the process-wide ``EpochCache``, so the parsed
sidecar, the read-only arena mapping, the prebuilt slot views, the
per-closure symbol index, the indexed load's resolved table, the lazy
binding map, and the provider payload mmaps are each produced once per
(app, closure) per epoch and then served as dictionary hits — flash-
invalidated by the epoch token any ``end_mgmt`` bumps.  ``load_all``
batch-preloads a whole world in parallel (fleet warm-start is one call).

Loading strategies exposed for the benchmarks:
  ``stable``      — table-driven (the paper's contribution).
  ``stable-mmap`` — baked arena, one CoW mmap (beyond-paper fast path).
  ``stable-mmap-cached`` — epoch-resident: repeat loads return prebuilt
                    read-only views over one process-shared mapping (the
                    amortized floor; tensors are immutable by design).
  ``stable-shm``  — cross-process epoch-resident: the arena lives in a named
                    POSIX shm segment, so N worker *processes* attach to one
                    physical copy (``core/shm_arena.py``); repeat loads in a
                    process are EpochCache hits like the cached strategy.
  ``dynamic``     — traditional dynamic linking (baseline).
  ``indexed``     — dynamic-shaped load over the symbol index (management).
  ``lazy``        — dynamic linking with per-symbol first-use faulting (the
                    lazy-binding/PLT analogue, §6.2).

The table-driven strategies (``stable``, ``prefetch``, ``dynamic``,
``indexed``) also build the arena on a torch device when ``load`` is given
one (``core/device_arena.py``): the payload pages go up once and the
``paged_reloc_copy`` kernel gathers them into the device arena, whose slot
views are the image's tensors. Without a device the image is numpy, as in
the reference.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch import obs

from . import shm_arena
from .epoch_cache import ArenaEntry, EpochCache, process_cache
from .errors import StaleTableError, UnknownObjectError
from .manager import Manager
from .objects import PAGE_BYTES, ObjectKind, RelocType, StoreObject, align_up
from .registry import Registry, World
from .relocation import FLAG_EDITED, RelocationTable, build_table
from .resolver import DynamicResolver, Relocation, cast_elements, np_dtype
from .symbol_index import IndexedResolver, closure_hash

Initializer = Callable[[str, tuple[int, ...], str], np.ndarray]

# Binding recorded for a weak kernel-dtype ref that resolved nowhere
# (RelocType.INIT with no arena slot). Kernel symbols bind to entry points,
# not tensor bytes, so the numeric initializer can never produce a value for
# them — the explicit no-op entry keeps ``LoadedImage.kernels`` total and
# lets callers detect the unbound op (`provider, entry = v.rsplit(":", 1)`
# still parses, with entry "-1").
WEAK_KERNEL_NOOP = "noop:-1"


def _zeros_init(name: str, shape: tuple[int, ...], dtype: str) -> np.ndarray:
    return np.zeros(shape, dtype=np_dtype(dtype))


def paged_payload_bytes(table: RelocationTable) -> int:
    """Payload bytes a page-table load accounts for: the rows' sizes, not
    the whole pages it copies (vectorized: this is the per-load path)."""
    rows = table.rows
    copied = ~np.isin(
        rows["type"], (int(RelocType.KERNEL), int(RelocType.INIT))
    )
    return int(rows["st_size"][copied].sum())


@dataclass
class LoadStats:
    strategy: str = ""
    resolve_s: float = 0.0      # symbol search (dynamic/indexed) / 0 (stable)
    table_load_s: float = 0.0   # table/sidecar deserialize / 0 (dynamic)
    io_s: float = 0.0           # payload reads into the arena
    index_build_s: float = 0.0  # symbol-index construction (indexed loads)
    relocations: int = 0
    probes: int = 0             # hash probes performed (search work)
    bytes_loaded: int = 0       # bytes copied (0 for mmap-backed loads)
    cache_hit: bool = False     # served from the process EpochCache
    shm_attached: bool = False  # stable-shm: attached an existing segment
    shm_segment: str = ""       # stable-shm: segment name (census/debug)
    store_source: str = ""      # stable-remote: tier that produced the
                                # arena (tables/cache/remote/bake)
    # device loads (inside io_s), each synchronised: payload read + upload;
    # the page-copy step (zeroed arena, host index checks and upload, one
    # kernel launch); the CAST/INIT/unaligned host rows + kernel binding
    upload_s: float = 0.0
    kernel_s: float = 0.0
    host_rows_s: float = 0.0
    # inside upload_s: the host's copies out of the payload mappings, and
    # its waits for a staging buffer's copy to the device to drain
    read_s: float = 0.0
    stage_wait_s: float = 0.0

    @property
    def startup_s(self) -> float:
        return self.resolve_s + self.table_load_s + self.io_s


@dataclass
class MaterializationResult:
    """What one ``end_mgmt`` materialization pass actually did.

    ``materialized`` lists apps whose closure changed (tables re-built);
    ``reused`` lists apps whose (app hash, closure hash) key survived the
    world change — their tables and baked arenas were left untouched.
    Exposed as ``Manager.last_materialization`` / ``tx.materialization`` and
    threaded into ``LinkReport.summary()``.
    """

    epoch: int = 0
    materialized: list[str] = field(default_factory=list)
    reused: list[str] = field(default_factory=list)
    index_build_s: float = 0.0   # symbol-index builds (cache misses only)
    bake_s: float = 0.0          # arena pre-application time
    wall_s: float = 0.0
    workers: int = 1

    @property
    def tables_reused(self) -> int:
        return len(self.reused)

    def summary(self) -> dict:
        return {
            "epoch": self.epoch,
            "materialized": sorted(self.materialized),
            "reused": sorted(self.reused),
            "tables_reused": self.tables_reused,
            "index_build_s": self.index_build_s,
            "bake_s": self.bake_s,
            "wall_s": self.wall_s,
            "workers": self.workers,
        }


@dataclass
class LoadedImage:
    """Result of loading an application: symbol name -> tensor view.

    A host load holds numpy arrays; a device load holds a torch ``uint8``
    arena on the device and torch views of it (``core/device_arena.py``)."""

    app: StoreObject
    arena: np.ndarray
    tensors: dict[str, np.ndarray]
    kernels: dict[str, str]               # op symbol -> "provider:entry"
    table: Optional[RelocationTable]
    stats: LoadStats = field(default_factory=LoadStats)

    def __getitem__(self, name: str) -> np.ndarray:
        return self.tensors[name]


class LazyImage:
    """Lazy-binding analogue: resolve+load each symbol at first access.

    Every access goes through ``__getitem__`` — the indirection is the GOT
    jump; the first-access slow path is the PLT resolver trampoline. Eager
    stable loading eliminates both (§6.2: "disable it!").

    ``bindings`` is the per-closure binding cache (an ``EpochCache``
    section entry shared by every lazy image of the same (app, closure)
    within the epoch): the first image pays the resolver trampoline per
    symbol, every later image binds the same symbol with one dict hit —
    the amortized-PLT behaviour real loaders get from a warm GOT.
    """

    def __init__(
        self,
        executor: "Executor",
        app: StoreObject,
        world: World,
        *,
        bindings: Optional[dict] = None,
    ):
        self._executor = executor
        self._app = app
        self._world = world
        self._resolver = DynamicResolver(world)
        self._scope = None
        self._cache: dict[str, object] = {}   # ndarray, or str for kernels
        self._refs = {r.name: r for r in app.refs}
        # symbol -> Relocation, shared across images of this closure
        self._bindings = bindings if bindings is not None else {}
        self.stats = LoadStats(strategy="lazy")

    def __getitem__(self, name: str):
        hit = self._cache.get(name)
        if hit is not None:
            return hit
        ref = self._refs.get(name)
        if ref is None:
            raise UnknownObjectError(f"{self._app.name} has no symbol {name!r}")
        reloc = self._bindings.get(name)
        if reloc is None:
            t0 = time.perf_counter()
            if self._scope is None:
                from .resolver import dependency_closure

                self._scope = dependency_closure(self._app, self._world)
            reloc = self._resolver.resolve_ref(ref, self._app, self._scope)
            self.stats.resolve_s += time.perf_counter() - t0
            self.stats.probes = self._resolver.probe_count
            self._bindings[name] = reloc
        else:
            self.stats.cache_hit = True
        if ref.dtype == "kernel":
            # kernel symbols bind to entry points, not tensor bytes; an
            # unresolved weak one binds the explicit no-op entry instead of
            # faulting through the numeric initializer
            val = (
                WEAK_KERNEL_NOOP
                if reloc.provider is None
                else f"{reloc.provider.name}:{reloc.st_value}"
            )
            self.stats.relocations += 1
            self._cache[name] = val
            return val
        t1 = time.perf_counter()
        arr = self._executor._read_single(reloc)
        self.stats.io_s += time.perf_counter() - t1
        self.stats.relocations += 1
        self.stats.bytes_loaded += arr.nbytes
        self._cache[name] = arr
        return arr

    def keys(self):
        return self._refs.keys()


class Executor:
    def __init__(
        self,
        registry: Registry,
        manager: Manager,
        *,
        initializer: Initializer = _zeros_init,
        io_threads: int = 0,
        loader: str = "paged",
        table_format: str = "raw",
        bake_arenas: bool = True,
        materialize_workers: int = 1,
        epoch_cache: Optional[EpochCache] = None,
        cache_bytes: Optional[int] = None,
    ):
        assert loader in ("paged", "rows")
        assert table_format in ("raw", "npz")
        self.registry = registry
        self.manager = manager
        self.initializer = initializer
        self.io_threads = io_threads
        self.table_format = table_format
        # "rows"  — the paper-faithful §4.2 loader: iterate the table with
        #           grouped sequential reads per provider.
        # "paged" — beyond-paper: the materialization-time page table is
        #           applied as one vectorized gather per provider (host
        #           execution of the paged_reloc_copy kernel's plan);
        #           CAST/INIT/unaligned rows fall back to the row loader.
        #           A device load always takes the page table (it compiles
        #           one where the table has none), whatever this says.
        self.loader = loader
        # Pre-apply tables into .arena images at materialization so the
        # stable-mmap strategy can epoch-load with a single CoW mmap.
        self.bake_arenas = bake_arenas
        # Fan re-materializations out over a thread pool (>1). Tables are
        # deterministic per app, so parallel == serial byte-for-byte.
        self.materialize_workers = max(1, int(materialize_workers))
        # The epoch-resident runtime: arena mappings, symbol indexes,
        # indexed tables, lazy bindings, and payload mmaps all live here,
        # process-wide by default (N same-process replicas share one
        # mapping) and flash-invalidated by any end_mgmt's token bump.
        self.epoch_cache = epoch_cache if epoch_cache is not None else process_cache()
        # Optional resident-byte budget for the epoch cache (LRU eviction of
        # unpinned entries). Applied to whichever cache this executor uses —
        # with the default process-wide cache that is a process-wide knob,
        # which is exactly the "bound the warm machine" intent.
        if cache_bytes is not None:
            self.epoch_cache.cache_bytes = int(cache_bytes)
        # scope-key -> SymbolIndex, shared across materializations AND
        # processes-wide via the EpochCache, so apps with the same
        # dependency closure resolve against one index (epoch-invalidated).
        self._index_cache = self.epoch_cache.section("symbol-index")
        # (app hash, world hash) -> closure hash; content-addressed, never
        # stale (a changed binding changes the world hash).
        self._closure_key_cache: dict[tuple[str, str], str] = {}
        self.last_materialization: Optional[MaterializationResult] = None
        # Tiered arena store (core/arena_store.TieredStore) consulted by
        # the stable-remote strategy when the baked arena is missing
        # locally; attached by Workspace.attach_store / warmup(store=...).
        self.arena_store = None
        # Wire the Manager's end_mgmt hooks (Figure 5's dashed control edge)
        # and point its commit-time invalidation at our cache.
        manager.on_materialize = self.materialize_all
        manager.on_edits = self.apply_interposition_edits
        manager.epoch_cache = self.epoch_cache

    # ---------------------------------------------------------- materialize
    def closure_key(self, app: StoreObject, world: World) -> str:
        """The app's closure hash under ``world`` (memoized per world)."""
        ck = (app.content_hash, world.world_hash)
        key = self._closure_key_cache.get(ck)
        if key is None:
            key = closure_hash(app, world)
            self._closure_key_cache[ck] = key
        return key

    def materialize(
        self,
        app: StoreObject,
        world: World,
        epoch: int,
        *,
        key: Optional[str] = None,
    ) -> RelocationTable:
        """Resolve one app (indexed — O(1) per ref) and persist its table
        (plus, with ``bake_arenas``, the pre-applied arena image)."""
        key = key or self.closure_key(app, world)
        table, _, _ = self._materialize_one(app, world, epoch, key)
        return table

    def _materialize_one(
        self, app: StoreObject, world: World, epoch: int, key: str
    ) -> tuple[RelocationTable, float, float]:
        """One app's materialization: returns (table, index_build_s, bake_s).
        Thread-safe for distinct apps (shared caches are content-keyed)."""
        resolver = IndexedResolver(world, index_cache=self._index_cache)
        relocations = resolver.resolve(app)
        table = build_table(
            app,
            relocations,
            world_hash=world.world_hash,
            epoch=epoch,
            closure_hash=key,
        )
        table.save(
            self.registry.table_path(app.content_hash, key),
            format=self.table_format,
        )
        bake_s = self._bake_arena(app, table, key) if self.bake_arenas else 0.0
        return table, resolver.index_build_s, bake_s

    def materialize_all(self, world: World, epoch: int) -> MaterializationResult:
        """end_mgmt hook: (re-)materialize exactly the applications whose
        dependency closure changed under the new world.

        Tables are keyed by (app hash, closure hash), so a publish that does
        not touch an app's closure leaves its key — and its table and baked
        arena — intact (``reused``).  The remaining apps are independent and
        fan out over ``materialize_workers`` threads; the produced tables
        are identical to a serial pass (content-addressed inputs, no shared
        mutable state beyond caches keyed by content).
        """
        t0 = time.perf_counter()
        result = MaterializationResult(epoch=epoch, workers=self.materialize_workers)
        todo: list[tuple[StoreObject, str]] = []
        # one readdir instead of 3 stats per app: the reuse check is pure
        # existence, and a commit with a large fleet would otherwise pay
        # O(apps) syscalls just to discover nothing changed
        tables_dir = self.registry.root / "tables"
        existing = (
            {p.name for p in tables_dir.iterdir()} if tables_dir.exists() else set()
        )
        for app in world.applications():
            key = self.closure_key(app, world)
            have_table = (
                self.registry.table_path(app.content_hash, key).name in existing
            )
            # a bake is only reusable when BOTH halves survived (a crash
            # between the arena and sidecar renames leaves it half-baked)
            have_arena = not self.bake_arenas or (
                self.registry.arena_path(app.content_hash, key).name in existing
                and self.registry.arena_meta_path(app.content_hash, key).name
                in existing
            )
            if have_table and have_arena:
                result.reused.append(app.name)
            else:
                todo.append((app, key))

        def _one(app: StoreObject, key: str) -> tuple[str, float, float]:
            _, index_s, bake_s = self._materialize_one(app, world, epoch, key)
            return app.name, index_s, bake_s

        if self.materialize_workers > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=self.materialize_workers) as pool:
                outs = list(pool.map(lambda ak: _one(*ak), todo))
        else:
            outs = [_one(app, key) for app, key in todo]
        for name, index_s, bake_s in outs:
            result.materialized.append(name)
            result.index_build_s += index_s
            result.bake_s += bake_s
        self._prune_caches(world)
        result.wall_s = time.perf_counter() - t0
        self.last_materialization = result
        return result

    def apply_interposition_edits(
        self, world: World, edits: list[dict]
    ) -> int:
        """end_mgmt hook for staged interposition edits (``tx.rebind``).

        Runs after ``materialize_all`` and before the commit lands, against
        the committing world's freshly materialized tables: matching rows
        are rebound to the staged provider (``FLAG_EDITED`` set), the table
        is re-saved, and the arena re-baked so every epoch strategy —
        including the shm fleet, whose segment names hash the sidecar —
        serves the edited mapping. A failure (provider stopped exporting
        the symbol, shape mismatch) propagates and aborts the commit with
        the management session still open. Returns rows rebound in total.
        """
        from . import interpose

        n_total = 0
        for edit in edits:
            app = world.resolve(edit["app"])
            provider = world.resolve(edit["provider"])
            key = self.closure_key(app, world)
            tpath = self.registry.table_path(app.content_hash, key)
            table = RelocationTable.load(tpath)
            n = interpose.rebind(
                table,
                symbol_glob=edit["symbol_glob"],
                new_provider=provider,
                requires_glob=edit.get("requires_glob"),
            )
            if n:
                table.save(tpath, format=self.table_format)
                if self.bake_arenas:
                    self._bake_arena(app, table, key)
            n_total += n
        return n_total

    def _prune_caches(self, world: World) -> None:
        """Keep the in-memory caches from growing with publish history.

        Closure keys for superseded worlds can never be asked for again;
        the shared symbol-index section is simply bounded (entries rebuild
        cheaply on the next miss). Everything else on the EpochCache is
        epoch-token invalidated by the commit that triggered this pass."""
        wh = world.world_hash
        self._closure_key_cache = {
            k: v for k, v in self._closure_key_cache.items() if k[1] == wh
        }
        if len(self._index_cache) > 64:
            self._index_cache.clear()

    # ----------------------------------------------------------------- load
    def load(
        self,
        app_name: str,
        *,
        strategy: str = "auto",
        world: Optional[World] = None,
        device=None,
        into=None,
    ):
        """Load an application image via a registered strategy.

        ``auto`` follows the paper: dynamic during management time, stable
        (table-driven) during an epoch. Everything else dispatches through
        the ``repro_torch.link.strategies`` registry, so new loaders are drop-in
        (``@register_strategy("name")``) and benchmarks select them by name.

        ``device`` (a torch device or its name) builds the arena there; only
        strategies registered with ``takes_device=True`` accept one, the
        rest raise ``ValueError``. ``None`` keeps the numpy host image.
        ``into`` (an earlier device ``LoadedImage`` of the same slot layout)
        builds the arena in that image's arena instead of a new one, on its
        device (``core/device_arena.py``). The load is a ``link.load`` span
        (``repro_torch.obs``).
        """
        # Imported lazily: core stays importable without the link facade,
        # and the registry module itself imports core.
        from repro_torch.link.strategies import DEVICE_TODO, resolve_strategy

        world = world or self.manager.world()
        app = world.resolve(app_name)
        fn = resolve_strategy(strategy, mode=self.manager.mode)
        if into is not None:
            device = into.arena.device if device is None else device
        if device is not None and not getattr(fn, "takes_device", False):
            raise ValueError(
                f"load strategy {strategy!r} builds no device arena "
                f"({DEVICE_TODO}); load it with device=None"
            )
        with obs.span("link.load", app=app_name, strategy=strategy):
            if device is None:
                return fn(self, app, world)
            if into is None:
                return fn(self, app, world, device=device)
            return fn(self, app, world, device=device, into=into)

    def load_all(
        self,
        names=None,
        *,
        strategy: str = "stable-mmap-cached",
        workers: int = 4,
        world: Optional[World] = None,
    ) -> dict:
        """Batch-preload applications in parallel (fleet warm-start).

        ``names=None`` loads every application of the current world. Loads
        fan out over ``workers`` threads; the EpochCache's per-key fill
        locks guarantee each (app, closure) arena is mapped exactly once no
        matter how many threads race on it, so warming a whole fleet at
        epoch start is one call against one world snapshot. Returns
        ``{name: image}``.
        """
        world = world or self.manager.world()
        if names is None:
            names = [a.name for a in world.applications()]
        names = list(names)

        def _one(name: str):
            return self.load(name, strategy=strategy, world=world)

        if workers > 1 and len(names) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                images = list(pool.map(_one, names))
        else:
            images = [_one(n) for n in names]
        return dict(zip(names, images))

    # ------------------------------------------------------------- internals
    def _load_stable(
        self, app: StoreObject, world: World, device=None, into=None
    ) -> LoadedImage:
        stats = LoadStats(strategy="stable")
        with obs.span("link.table_load") as span:
            key = self.closure_key(app, world)
            path = self.registry.table_path(app.content_hash, key)
            if not path.exists():
                # pre-closure-hash stores keyed tables by the world hash;
                # honour them until the next management cycle re-materializes
                legacy = self.registry.table_path(app.content_hash, world.world_hash)
                if legacy.exists():
                    path, key = legacy, world.world_hash
                else:
                    raise StaleTableError(
                        f"no materialized table for {app.name} under closure "
                        f"{key[:12]}; run begin_mgmt/end_mgmt"
                    )
            table = RelocationTable.load(path)
            table.check_fresh(key, app.content_hash)
        stats.table_load_s = span.dur
        return self._apply_table(app, table, stats, device, into)

    def _build_arena_entry(self, app: StoreObject, key: str) -> ArenaEntry:
        """Fill path of the epoch-resident arena cache: parse the sidecar
        and verify the ``check_fresh``-style staleness guards. The shared
        read-only mapping + prebuilt slot views build lazily on the first
        ``stable-mmap-cached`` load (``ArenaEntry.shared_views``)."""
        apath = self.registry.arena_path(app.content_hash, key)
        mpath = self.registry.arena_meta_path(app.content_hash, key)
        if not (apath.exists() and mpath.exists()):
            raise StaleTableError(
                f"no baked arena for {app.name} under closure {key[:12]}; "
                "run a management cycle with bake_arenas=True"
            )
        st = mpath.stat()
        meta = json.loads(mpath.read_text())
        # a baked arena can never be applied under the wrong world/app
        if meta.get("closure_hash") != key:
            raise StaleTableError(
                f"baked arena for closure {str(meta.get('closure_hash'))[:12]} "
                f"used against closure {key[:12]} — re-run end_mgmt"
            )
        if meta.get("app_hash") != app.content_hash:
            raise StaleTableError("baked arena belongs to a different application")
        slot_items = [
            (
                name,
                int(s["offset"]),
                int(s["nbytes"]),
                np_dtype(s["dtype"]),
                tuple(s["shape"]),
            )
            for name, s in meta["slots"].items()
        ]
        return ArenaEntry(
            path=apath,
            meta=meta,
            slot_items=slot_items,
            arena_size=int(meta["arena_size"]),
            kernels=dict(meta.get("kernels", {})),
            sidecar_stat=(st.st_mtime_ns, st.st_size),
        )

    def _arena_entry(
        self, app: StoreObject, key: str, *, validate_stat: bool
    ) -> tuple[ArenaEntry, bool]:
        """The (app, closure) arena entry, filled at most once per epoch.

        ``validate_stat=True`` re-stats the sidecar on every hit (one
        syscall) so an out-of-band rewrite is caught immediately — the
        ``stable-mmap`` contract. The cached strategy passes False and
        trusts the epoch token alone: like a running process whose ELF
        mappings survive an unlink, the entry stays valid until the next
        management boundary. Returns ``(entry, was_hit)``.
        """
        ckey = (str(self.registry.root), app.content_hash, key)
        entry = self.epoch_cache.get("arena", ckey)
        hit = entry is not None
        if hit and validate_stat:
            try:
                st = self.registry.arena_meta_path(app.content_hash, key).stat()
                stale = (st.st_mtime_ns, st.st_size) != entry.sidecar_stat
            except OSError:
                stale = True
            if stale:
                self.epoch_cache.invalidate("arena", ckey)
                entry, hit = None, False
        if entry is None:
            entry = self.epoch_cache.get_or_fill(
                "arena", ckey, lambda: self._build_arena_entry(app, key)
            )
        return entry, hit

    def _load_stable_mmap(self, app: StoreObject, world: World) -> LoadedImage:
        """Baked-arena epoch load: one copy-on-write mmap + view building.

        No symbol search, no table parse, no payload copy — the relocation
        work happened at ``end_mgmt`` (``_bake_arena``) and the sidecar
        parse at the epoch's first load (EpochCache).  ``mode="c"`` maps
        the arena copy-on-write: callers may mutate tensors freely without
        touching the baked image or other loads.
        """
        stats = LoadStats(strategy="stable-mmap")
        t0 = time.perf_counter()
        key = self.closure_key(app, world)
        entry, stats.cache_hit = self._arena_entry(app, key, validate_stat=True)
        stats.table_load_s = time.perf_counter() - t0

        t1 = time.perf_counter()
        if entry.arena_size:
            # plain-ndarray view of the CoW mapping: mutability and privacy
            # come from mmap mode="c"; dropping the subclass makes the 100+
            # per-slot views below plain (cheap) ndarray slices
            arena = (
                np.memmap(entry.path, dtype=np.uint8, mode="c")
                .view(np.ndarray)[: entry.arena_size]
            )
        else:
            arena = np.empty(0, dtype=np.uint8)
        tensors = {
            name: arena[off : off + nbytes].view(dt).reshape(shape)
            for name, off, nbytes, dt, shape in entry.slot_items
        }
        stats.io_s = time.perf_counter() - t1
        stats.relocations = int(entry.meta.get("relocations", 0))
        stats.bytes_loaded = 0  # mapped, not copied
        return LoadedImage(
            app=app,
            arena=arena,
            tensors=tensors,
            kernels=dict(entry.kernels),
            table=None,
            stats=stats,
        )

    def _load_stable_mmap_cached(
        self, app: StoreObject, world: World
    ) -> LoadedImage:
        """Epoch-resident load: the amortized floor of the whole pipeline.

        The first load of an epoch fills the shared arena entry (read-only
        mapping + prebuilt views); every later load is a dict hit plus two
        shallow dict copies — no stat, no mmap, no per-slot view building.
        The returned tensors are READ-ONLY views over the one process-wide
        mapping (numpy refuses writes); callers that must mutate use
        ``stable-mmap``, which pays for a private copy-on-write mapping.
        """
        stats = LoadStats(strategy="stable-mmap-cached")
        t0 = time.perf_counter()
        key = self.closure_key(app, world)
        entry, stats.cache_hit = self._arena_entry(
            app, key, validate_stat=False
        )
        ro_arena, tensors = entry.shared_views()
        stats.table_load_s = time.perf_counter() - t0
        stats.relocations = int(entry.meta.get("relocations", 0))
        stats.bytes_loaded = 0  # shared mapping, nothing copied
        return LoadedImage(
            app=app,
            arena=ro_arena,
            tensors=dict(tensors),
            kernels=dict(entry.kernels),
            table=None,
            stats=stats,
        )

    def _load_stable_shm(self, app: StoreObject, world: World) -> LoadedImage:
        """Cross-process epoch-resident load: attach the machine-shared
        segment for this (app, closure) instead of mapping the file.

        The first load on the whole MACHINE publishes the baked arena into
        a named POSIX shm segment (exclusive create; ``core/shm_arena``);
        every other process — and every later load in this one — attaches:
        N worker processes share one physical copy. Within a process,
        repeat loads are EpochCache hits returning prebuilt READ-ONLY
        views — the same token-trusting amortized floor as
        ``stable-mmap-cached``. Cross-process epoch changes need no stat
        probe: a commit anywhere changes the app's *closure key* (content
        addressing), which is a different cache key and a different
        segment name; the generation stamp additionally guards an attach
        against a re-baked sidecar under an unchanged key.
        """
        stats = LoadStats(strategy="stable-shm")
        t0 = time.perf_counter()
        key = self.closure_key(app, world)
        ckey = (str(self.registry.root), app.content_hash, key)
        entry = self.epoch_cache.get("shm-arena", ckey)
        stats.cache_hit = entry is not None
        if entry is None:

            def build():
                base = self._build_arena_entry(app, key)
                segment = shm_arena.publish_or_attach(
                    self.registry,
                    app.content_hash,
                    key,
                    arena_path=base.path,
                    arena_size=base.arena_size,
                    generation=shm_arena.generation_stamp(base.meta),
                    epoch_gen=self.manager.epoch_gen,
                )
                return shm_arena.ShmArenaEntry(
                    segment=segment,
                    meta=base.meta,
                    slot_items=base.slot_items,
                    arena_size=base.arena_size,
                    kernels=base.kernels,
                    sidecar_stat=base.sidecar_stat,
                )

            entry = self.epoch_cache.get_or_fill("shm-arena", ckey, build)
        ro_arena, tensors = entry.shared_views()
        stats.table_load_s = time.perf_counter() - t0
        stats.relocations = int(entry.meta.get("relocations", 0))
        stats.bytes_loaded = 0  # shared segment, nothing copied
        stats.shm_attached = entry.segment.attached
        stats.shm_segment = entry.segment.name
        return LoadedImage(
            app=app,
            arena=ro_arena,
            tensors=dict(tensors),
            kernels=dict(entry.kernels),
            table=None,
            stats=stats,
        )

    def _load_stable_remote(self, app: StoreObject, world: World) -> LoadedImage:
        """Tiered-store epoch load: make sure the baked arena exists
        locally (tables/ → local store cache → verified remote fetch →
        degraded local bake), then serve it exactly like ``stable-shm``.

        Repeat loads are EpochCache hits and skip the tier walk outright —
        the warm path is the shm attach, so a fetched fleet pays the
        network exactly once per (app, closure) per machine. With no store
        attached this is ``stable-shm`` plus two stat calls, which keeps
        the strategy loadable on a baking machine and in the benchmark
        sweep without a server."""
        key = self.closure_key(app, world)
        ckey = (str(self.registry.root), app.content_hash, key)
        source = "tables"
        if self.epoch_cache.get("shm-arena", ckey) is None:
            apath = self.registry.arena_path(app.content_hash, key)
            mpath = self.registry.arena_meta_path(app.content_hash, key)
            if not (apath.exists() and mpath.exists()):
                store = self.arena_store
                if store is None:
                    raise StaleTableError(
                        f"no baked arena for {app.name} under closure "
                        f"{key[:12]} and no arena store attached — bake via "
                        "end_mgmt, or attach one (Workspace.attach_store / "
                        "warmup(store=...))"
                    )
                source = store.ensure_arena(self, app, world, key)
        image = self._load_stable_shm(app, world)
        image.stats.strategy = "stable-remote"
        image.stats.store_source = source
        return image

    def _load_dynamic(
        self, app: StoreObject, world: World, device=None, into=None
    ) -> LoadedImage:
        stats = LoadStats(strategy="dynamic")
        t0 = time.perf_counter()
        resolver = DynamicResolver(world)
        relocations = resolver.resolve(app)
        table = build_table(
            app, relocations, world_hash=world.world_hash, epoch=self.manager.epoch
        )
        stats.resolve_s = time.perf_counter() - t0
        stats.probes = resolver.probe_count
        return self._apply_table(app, table, stats, device, into)

    def _load_indexed(
        self, app: StoreObject, world: World, device=None, into=None
    ) -> LoadedImage:
        """Dynamic-shaped load that resolves through the symbol index —
        the management-time fallback (``auto`` maps here while the world is
        in flux), sparing the O(refs x scope) ld.so probe.

        The resolved table is cached per (app, closure) on the EpochCache:
        repeat indexed loads within one closure skip resolution AND table
        construction outright — the work that would make ``indexed`` lose
        to ``dynamic`` on repeat loads. A staged publish that changes the
        app's closure changes the key, so management-time correctness is
        untouched; any commit flash-invalidates via the epoch token.
        """
        stats = LoadStats(strategy="indexed")
        t0 = time.perf_counter()
        key = self.closure_key(app, world)
        ckey = (str(self.registry.root), app.content_hash, key)
        table = self.epoch_cache.get("indexed-table", ckey)
        if table is not None:
            stats.cache_hit = True
        else:
            def build():
                resolver = IndexedResolver(world, index_cache=self._index_cache)
                relocations = resolver.resolve(app)
                stats.index_build_s = resolver.index_build_s
                stats.probes = resolver.probe_count
                return build_table(
                    app,
                    relocations,
                    world_hash=world.world_hash,
                    epoch=self.manager.epoch,
                    closure_hash=key,
                )

            table = self.epoch_cache.get_or_fill(
                "indexed-table", ckey, build,
                nbytes=lambda t: int(getattr(t.rows, "nbytes", 0)),
            )
        stats.resolve_s = time.perf_counter() - t0
        return self._apply_table(app, table, stats, device, into)

    def _bake_arena(self, app: StoreObject, table: RelocationTable, key: str) -> float:
        """Pre-apply ``table`` into a page-aligned arena image on disk.

        The image is the fully relocated arena the stable loader would have
        produced; ``stable-mmap`` maps it copy-on-write at epoch load.  The
        sidecar carries the staleness guards plus everything view building
        needs (slots, kernel bindings), so the load path never opens the
        table.  Returns the bake wall time.
        """
        t0 = time.perf_counter()
        padded = align_up(table.arena_size, PAGE_BYTES)
        arena = np.zeros(padded, dtype=np.uint8)
        kernels: dict[str, str] = {}
        self._fill_arena(table, arena[: table.arena_size], kernels)
        apath = self.registry.arena_path(app.content_hash, key)
        tmp = apath.with_suffix(".tmp")
        arena.tofile(tmp)
        tmp.rename(apath)
        sidecar = {
            "app": app.name,
            "app_hash": app.content_hash,
            "world_hash": table.meta["world_hash"],
            "closure_hash": key,
            "epoch": table.meta["epoch"],
            "arena_size": table.arena_size,
            "relocations": len(table),
            "slots": table.meta["slots"],
            "kernels": kernels,
        }
        # Interposition edits change arena BYTES without changing the
        # closure: stamp the edited rows into the sidecar so the shm
        # generation stamp (a hash of this JSON) moves and attached fleets
        # cannot serve the pre-edit segment for this key.
        edited = int(np.count_nonzero(table.rows["flags"] & FLAG_EDITED))
        if edited:
            sidecar["edited_rows"] = edited
        mpath = self.registry.arena_meta_path(app.content_hash, key)
        mtmp = mpath.with_suffix(".tmp")
        mtmp.write_text(json.dumps(sidecar, sort_keys=True))
        mtmp.rename(mpath)
        return time.perf_counter() - t0

    def _payload_mmap(self, store_name: str) -> np.ndarray:
        """Read-only mapping of one provider payload, shared across loads.

        Payloads are content-addressed and immutable, so the mapping is
        cached on the EpochCache (token-checked like everything else) —
        repeat loads, and especially per-symbol lazy faults, stop paying an
        mmap open per read."""
        ckey = (str(self.registry.root), store_name)
        # pre-check before get_or_fill so the hot path (lazy faults call
        # this per symbol) skips Path construction and lambda allocation
        hit = self.epoch_cache.get("payload", ckey)
        if hit is not None:
            return hit
        path = self.registry.root / "objects" / store_name / "payload.bin"
        return self.epoch_cache.get_or_fill(
            "payload",
            ckey,
            # plain-ndarray view: group reads slice payloads hundreds of
            # times per load and must not pay memmap __array_finalize__
            lambda: np.memmap(path, dtype=np.uint8, mode="r").view(np.ndarray),
        )

    def lazy_image(self, app: StoreObject, world: World) -> LazyImage:
        """A ``LazyImage`` wired to the per-closure binding cache.

        Images of the same (app, closure) share one symbol -> Relocation
        map for the epoch, so second-and-later lazy binds are O(1) dict
        hits instead of re-resolution. A broken staged closure (management
        time, missing dependency) falls back to image-private bindings —
        exactly the worlds where cached bindings could go stale mid-session.
        """
        try:
            key = self.closure_key(app, world)
            bindings = self.epoch_cache.get_or_fill(
                "lazy-bindings",
                (str(self.registry.root), app.content_hash, key),
                dict,
            )
        except UnknownObjectError:
            bindings = None
        return LazyImage(self, app, world, bindings=bindings)

    def _apply_table(
        self, app: StoreObject, table: RelocationTable, stats: LoadStats,
        device=None, into=None,
    ) -> LoadedImage:
        if device is not None:
            # built on the device with the paged_reloc_copy kernel; never
            # cached: each device load owns its arena (or ``into``'s)
            from .device_arena import apply_table_on_device

            return apply_table_on_device(self, app, table, stats, device, into)
        t0 = time.perf_counter()
        arena = np.empty(table.arena_size, dtype=np.uint8)
        kernels: dict[str, str] = {}
        stats.bytes_loaded = self._fill_arena(table, arena, kernels)
        stats.io_s = time.perf_counter() - t0
        stats.relocations = len(table.rows)
        slots = table.slots()
        tensors = {
            name: arena[s.offset : s.offset + s.nbytes]
            .view(np_dtype(s.dtype))
            .reshape(s.shape)
            for name, s in slots.items()
        }
        return LoadedImage(
            app=app,
            arena=arena,
            tensors=tensors,
            kernels=kernels,
            table=table,
            stats=stats,
        )

    def _fill_arena(
        self, table: RelocationTable, arena: np.ndarray, kernels: dict
    ) -> int:
        """Apply every relocation of ``table`` into ``arena`` (and bind
        kernel symbols into ``kernels``). Shared by the stable loader and
        the arena baker. Returns the payload bytes copied."""
        rows = table.rows
        if (
            self.loader == "paged"
            and table._pt_src is not None
            and "host_rows" in table.meta
        ):
            self._apply_paged(table, arena, kernels)
            return paged_payload_bytes(table)

        slots = table.slots()

        # Group rows by provider, sort by source offset: each provider's
        # payload is then read strictly sequentially (§4.2's key loading
        # optimization — "well suited for memory prefetching"). The group
        # boundaries come from one np.unique over the lexsorted provider
        # column instead of a per-row Python loop.
        order = np.lexsort((rows["st_value"], rows["provides_so_uuid"]))
        sorted_uuids = rows["provides_so_uuid"][order]
        uniq, starts = np.unique(sorted_uuids, return_index=True)
        bounds = np.append(starts, len(order))
        groups: dict[int, np.ndarray] = {
            int(u): order[bounds[j] : bounds[j + 1]]
            for j, u in enumerate(uniq)
        }

        def apply_group(uuid: int, idxs) -> int:
            nbytes = 0
            mm = None

            def payload():  # lazy: KERNEL/INIT-only groups have no payload
                nonlocal mm
                if mm is None:
                    obj = table.object_by_uuid(uuid)
                    mm = self._payload_mmap(obj["store_name"])
                return mm

            for i in idxs:
                r = rows[i]
                rt = int(r["type"])
                name = table.name_at(r["symbol_name"])
                if rt == RelocType.KERNEL:
                    prov = table.object_by_uuid(int(r["provides_so_uuid"]))
                    kernels[name] = f"{prov['name']}:{int(r['st_value'])}"
                    continue
                if rt == RelocType.INIT:
                    slot = slots.get(name)
                    if slot is None and int(r["st_size"]) == 0:
                        # unbound weak kernel ref (only kernel refs carry
                        # st_size 0): no arena slot exists and the
                        # initializer cannot make a "kernel" array — bind
                        # an explicit no-op entry instead
                        kernels[name] = WEAK_KERNEL_NOOP
                        continue
                    if slot is None:
                        slot = slots[name]  # slotless tensor ref: loud
                    dst = arena[slot.offset : slot.offset + slot.nbytes]
                    init = self.initializer(name, slot.shape, slot.dtype)
                    dst[:] = np.ascontiguousarray(init).view(np.uint8).ravel()
                    nbytes += slot.nbytes
                    continue
                slot = slots[name]
                dst = arena[slot.offset : slot.offset + slot.nbytes]
                src0 = int(r["st_value"]) + int(r["addend"])
                size = int(r["st_size"])
                src = payload()[src0 : src0 + size]
                if rt == RelocType.CAST:
                    prov_obj = table.object_by_uuid(uuid)
                    # provider dtype comes from its manifest symbol table
                    sdef = self._provider_symbol(prov_obj, name)
                    dst.view(np_dtype(slot.dtype))[:] = cast_elements(
                        src, sdef.dtype, slot.dtype
                    )
                else:
                    dst[:size] = src
                nbytes += size
            return nbytes

        if self.io_threads > 1 and len(groups) > 1:
            with ThreadPoolExecutor(max_workers=self.io_threads) as pool:
                futs = [
                    pool.submit(apply_group, u, idxs) for u, idxs in groups.items()
                ]
                return sum(f.result() for f in futs)
        return sum(apply_group(u, idxs) for u, idxs in groups.items())

    def _apply_paged(self, table: RelocationTable, arena: np.ndarray,
                     kernels: dict) -> None:
        """Vectorized page-table application (one gather per provider)."""
        src, dst = table._pt_src, table._pt_dst
        pad = align_up(arena.nbytes, PAGE_BYTES) - arena.nbytes
        if pad:
            # The gather writes whole destination pages; a non-page-multiple
            # arena (e.g. a hand-trimmed table layout) would overflow its
            # final page. Gather into a padded scratch and copy the real
            # prefix back — correctness over the zero-copy fast path here.
            scratch = np.zeros(arena.nbytes + pad, dtype=np.uint8)
            arena_pages = scratch.reshape(-1, PAGE_BYTES)
        else:
            scratch = None
            arena_pages = arena.reshape(-1, PAGE_BYTES)

        cursor = 0
        jobs = []
        for o in table.objects:
            n_pages = align_up(int(o["payload_size"]), PAGE_BYTES) // PAGE_BYTES
            if n_pages:
                jobs.append((o, cursor, cursor + n_pages))
            cursor += n_pages

        def copy_provider(o, lo, hi):
            mask = (src >= lo) & (src < hi)
            if not mask.any():
                return
            mm = self._payload_mmap(o["store_name"])
            pages = mm[: (hi - lo) * PAGE_BYTES].reshape(-1, PAGE_BYTES)
            arena_pages[dst[mask]] = pages[src[mask] - lo]

        if self.io_threads > 1 and len(jobs) > 1:
            with ThreadPoolExecutor(max_workers=self.io_threads) as pool:
                list(pool.map(lambda j: copy_provider(*j), jobs))
        else:
            for j in jobs:
                copy_provider(*j)

        if scratch is not None:
            # fold the padded gather back BEFORE host rows run, so their
            # direct writes into `arena` are not clobbered
            arena[:] = scratch[: arena.nbytes]

        # host-path rows: CAST / INIT / unaligned SLICE
        host_rows = table.meta.get("host_rows", [])
        if host_rows:
            self._apply_row_subset(
                table,
                lambda s: arena[s.offset : s.offset + s.nbytes],
                kernels,
                host_rows,
            )
        self._bind_kernels(table, kernels)

    @staticmethod
    def _bind_kernels(table: RelocationTable, kernels: dict) -> None:
        """Bind the table's KERNEL rows (never in the page table)."""
        rows = table.rows
        kmask = rows["type"] == int(RelocType.KERNEL)
        for i in np.nonzero(kmask)[0]:
            name = table.name_at(rows["symbol_name"][i])
            prov = table.object_by_uuid(int(rows["provides_so_uuid"][i]))
            kernels[name] = f"{prov['name']}:{int(rows['st_value'][i])}"

    def _apply_row_subset(self, table: RelocationTable, slot_bytes,
                          kernels: dict, idxs) -> None:
        """Apply rows ``idxs`` of ``table`` one by one; ``slot_bytes(slot)``
        returns the writable uint8 bytes of that arena slot."""
        rows = table.rows
        slots = table.slots()
        for i in idxs:
            r = rows[int(i)]
            rt = int(r["type"])
            name = table.name_at(r["symbol_name"])
            if rt == RelocType.KERNEL:
                prov = table.object_by_uuid(int(r["provides_so_uuid"]))
                kernels[name] = f"{prov['name']}:{int(r['st_value'])}"
                continue
            if rt == RelocType.INIT:
                slot = slots.get(name)
                if slot is None and int(r["st_size"]) == 0:
                    kernels[name] = WEAK_KERNEL_NOOP  # unbound weak kernel
                    continue
                if slot is None:
                    slot = slots[name]  # slotless tensor ref: loud
                dstb = slot_bytes(slot)
                init = self.initializer(name, slot.shape, slot.dtype)
                dstb[:] = np.ascontiguousarray(init).view(np.uint8).ravel()
                continue
            slot = slots[name]
            dstb = slot_bytes(slot)
            prov = table.object_by_uuid(int(r["provides_so_uuid"]))
            mm = self._payload_mmap(prov["store_name"])
            src0 = int(r["st_value"]) + int(r["addend"])
            size = int(r["st_size"])
            srcb = mm[src0 : src0 + size]
            if rt == RelocType.CAST:
                sdef = self._provider_symbol(prov, name)
                dstb.view(np_dtype(slot.dtype))[:] = cast_elements(
                    srcb, sdef.dtype, slot.dtype
                )
            else:
                dstb[:size] = srcb

    def _provider_symbol(self, prov_obj: dict, name: str):
        obj = self.registry.get(prov_obj["content_hash"])
        return self._find_symbol(obj, name)

    @staticmethod
    def _find_symbol(obj: StoreObject, name: str):
        sdef = obj.symbols.get(name)
        while sdef is None and "[" in name:
            name = name.rsplit("[", 1)[0]  # strip slice levels outward-in
            sdef = obj.symbols.get(name)
        if sdef is None:
            raise UnknownObjectError(f"{obj.name} has no symbol {name!r}")
        return sdef

    def _read_single(self, reloc: Relocation) -> np.ndarray:
        """Single-symbol read for the lazy path."""
        ref = reloc.ref
        if reloc.rtype == RelocType.INIT or reloc.provider is None:
            return self.initializer(ref.name, ref.shape, ref.dtype)
        mm = self._payload_mmap(reloc.provider.store_name)
        src0 = reloc.st_value + reloc.addend
        raw = np.array(mm[src0 : src0 + reloc.st_size])  # copy out of mmap
        sdef = self._find_symbol(reloc.provider, ref.name)
        if reloc.rtype == RelocType.CAST:
            return cast_elements(raw, sdef.dtype, ref.dtype).reshape(ref.shape)
        return raw.view(np_dtype(sdef.dtype)).reshape(ref.shape)

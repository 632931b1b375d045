"""Workspace — the one public entry point to a stable-linking session.

A ``Workspace`` owns and wires the four engine-room pieces that every caller
previously assembled by hand (``Registry`` + ``Manager`` + ``Executor`` +
``CompileCache``, including the ``on_materialize`` hook), and exposes the
paper's lifecycle as three verbs:

    ws = Workspace.open(root)          # or Workspace.ephemeral()

    with ws.management() as tx:        # management time, transactional
        tx.publish(bundle, payload)
        tx.publish(app)
        tx.remove("old:model")
    # clean exit  -> end_mgmt: commit + materialize, epoch += 1
    # exception   -> abort_mgmt: staged world discarded, epoch untouched

    img = ws.load("serve:model")               # epoch: table-driven
    img = ws.load("serve:model", strategy="lazy")   # by-name via registry
    ws.warmup(workers=8)                       # fleet warm-start: preload
                                               # the whole world in parallel
    ws.gc()                                    # reclaim dead tables/arenas

    report = ws.explain("serve:model")         # observable mid-epoch
    report.to_sqlite(); report.summary()

The engine-room objects stay reachable (``ws.registry`` etc.) for tooling
and benchmarks that measure below the facade, but application code should
not construct them directly any more.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Iterator, Optional

from repro_torch.core.compile_cache import CompileCache
from repro_torch.core.epoch_cache import EpochCache
from repro_torch.core.executor import Executor, Initializer, LoadStats, _zeros_init
from repro_torch.core.manager import Manager, Mode
from repro_torch.core.objects import StoreObject
from repro_torch.core.registry import GcReport, Registry, World
from repro_torch.core.relocation import RelocationTable, build_table
from repro_torch.core.resolver import DynamicResolver

from repro_torch.core.errors import ModeError, UnknownObjectError

from .journal import Journal
from .report import LinkReport, report_from_table
from .transaction import ManagementTransaction

# Rotate (compact) journal.jsonl once it grows past this; see
# repro_torch.link.journal.Journal. Long sweeps stay bounded, short sessions
# never rotate.
DEFAULT_JOURNAL_ROTATE_BYTES = 1 << 20


@dataclass(frozen=True)
class EpochChange:
    """What one ``EpochWatch.poll()`` observed when a commit landed."""

    epoch: int
    epoch_gen: int
    previous_epoch_gen: int
    world_hash: str = ""
    rolled_back_from: int = 0   # nonzero: this generation is a rollback


class EpochWatch:
    """Cheap commit detector over ``state.json`` (the rollover handshake).

    A serving worker cannot afford to re-parse state on every request just
    to notice the rare commit. ``poll()`` stats the file (two ints) and
    re-parses only when (mtime_ns, size) moved AND the parsed ``epoch_gen``
    actually advanced past what this watcher last reported — management-
    time persists (staging churn) move the stat without moving the
    generation and are filtered out here, so a poller flips exactly once
    per commit. Returns the ``EpochChange`` on a new generation, else None.

    Coarse-mtime fallback: two commits of the same byte size landing
    within the filesystem's mtime granularity (same ``st_mtime_ns``, same
    ``st_size`` — ext3, some network filesystems, 1s-granularity mounts)
    leave the stat identical, which the fast path would read as "nothing
    happened" forever. When the stat is unchanged the watch therefore
    still re-parses the state every ``fallback_interval_s`` (default
    250ms) and trusts the parsed ``epoch_gen`` — the missed double commit
    is noticed at most one fallback interval late instead of never.
    ``fallback_interval_s=None`` disables the fallback (pure stat
    behaviour, for cost-sensitive pollers on known-fine-grained
    filesystems).
    """

    def __init__(
        self,
        registry: Registry,
        *,
        epoch_gen: int,
        fallback_interval_s: Optional[float] = 0.25,
    ):
        self._registry = registry
        self.epoch_gen = int(epoch_gen)
        self._fallback_interval_s = fallback_interval_s
        self._next_fallback = (
            time.monotonic() + fallback_interval_s
            if fallback_interval_s is not None
            else None
        )
        self._stat: Optional[tuple[int, int]] = None
        try:
            st = os.stat(registry.state_path)
            self._stat = (st.st_mtime_ns, st.st_size)
        except OSError:
            pass
        self.polls = 0          # observability: stat probes issued
        self.parses = 0         # ... of which re-parsed the state file
        self.fallback_parses = 0  # ... forced by the coarse-mtime fallback

    def poll(self) -> Optional[EpochChange]:
        self.polls += 1
        try:
            st = os.stat(self._registry.state_path)
        except OSError:
            return None
        stat = (st.st_mtime_ns, st.st_size)
        if stat == self._stat:
            # Same stat: usually "nothing happened", but a same-size commit
            # within the mtime granularity window looks exactly like this.
            # Fall back to a throttled parse of epoch_gen.
            if self._next_fallback is None:
                return None
            now = time.monotonic()
            if now < self._next_fallback:
                return None
            self._next_fallback = now + self._fallback_interval_s
            self.fallback_parses += 1
        else:
            self._stat = stat
            if self._fallback_interval_s is not None:
                self._next_fallback = (
                    time.monotonic() + self._fallback_interval_s
                )
        self.parses += 1
        try:
            state = self._registry.read_state()
        except Exception:
            return None  # torn/unreadable state: next poll retries
        gen = int(state.get("epoch_gen", 0))
        if gen <= self.epoch_gen:
            return None  # staging churn or our own generation: not a commit
        self.epoch_gen = gen
        from repro_torch.core.registry import World

        return EpochChange(
            epoch=int(state.get("epoch", 0)),
            epoch_gen=gen,
            previous_epoch_gen=int(state.get("previous_epoch_gen", 0)),
            world_hash=World(
                self._registry, state.get("world", {})
            ).world_hash,
            rolled_back_from=int(state.get("rolled_back_from", 0)),
        )


@dataclass
class WarmupReport:
    """What one ``ws.warmup`` fleet preload actually did."""

    strategy: str
    workers: int
    wall_s: float = 0.0
    names: list[str] = field(default_factory=list)
    cache_hits: int = 0          # EpochCache hits during the warmup
    cache_fills: int = 0         # entries filled (first touch this epoch)
    images: dict = field(default_factory=dict)  # name -> LoadedImage
    degraded: bool = False       # store tier: some arena came from a
                                 # fallback bake instead of a fetch
    store: Optional[dict] = None  # StoreReport.summary() when a store
                                  # was attached for this warmup

    def summary(self) -> dict:
        return {
            "strategy": self.strategy,
            "workers": self.workers,
            "wall_s": self.wall_s,
            "names": sorted(self.names),
            "cache_hits": self.cache_hits,
            "cache_fills": self.cache_fills,
            "degraded": self.degraded,
            "store": self.store,
        }


class Workspace:
    """A wired stable-linking session over one registry root."""

    def __init__(
        self,
        root: str | os.PathLike,
        *,
        initializer: Initializer = _zeros_init,
        io_threads: int = 0,
        loader: str = "paged",
        table_format: str = "raw",
        bake_arenas: bool = True,
        materialize_workers: int = 1,
        epoch_cache: Optional[EpochCache] = None,
        cache_bytes: Optional[int] = None,
        journal_rotate_bytes: Optional[int] = DEFAULT_JOURNAL_ROTATE_BYTES,
        _ephemeral: bool = False,
    ):
        self.root = os.fspath(root)
        self.registry = Registry(self.root)
        self.manager = Manager(self.registry)
        # cache_bytes bounds the epoch-resident cache (LRU eviction of
        # unpinned entries past the budget; see core.epoch_cache). With the
        # default process-wide cache it is a process-wide knob; pass a
        # private epoch_cache for per-workspace budgets.
        self.executor = Executor(
            self.registry,
            self.manager,
            initializer=initializer,
            io_threads=io_threads,
            loader=loader,
            table_format=table_format,
            bake_arenas=bake_arenas,
            materialize_workers=materialize_workers,
            epoch_cache=epoch_cache,
            cache_bytes=cache_bytes,
        )
        self.compile_cache = CompileCache(self.registry.root / "executables")
        # Management-time journal: staged ops persisted beside state.json so
        # a crashed session's staging is operator-visible on the next open.
        # Rotated (replay-equivalent compaction) past journal_rotate_bytes
        # so very long sessions stay bounded; None disables rotation.
        self.journal = Journal(
            self.registry.journal_path, rotate_bytes=journal_rotate_bytes
        )
        self.manager.journal = self.journal
        self._ephemeral = _ephemeral
        self._last_stats: dict[str, LoadStats] = {}

    # ------------------------------------------------------------ construct
    @classmethod
    def open(cls, root: str | os.PathLike, **kw) -> "Workspace":
        """Open (or create) the workspace at ``root``."""
        return cls(root, **kw)

    @classmethod
    def ephemeral(cls, prefix: str = "repro-ws-", **kw) -> "Workspace":
        """A throwaway workspace in a temp directory (examples, tests,
        benchmarks). ``close()`` deletes it."""
        return cls(tempfile.mkdtemp(prefix=prefix), _ephemeral=True, **kw)

    def close(self) -> None:
        """Release the workspace; deletes the store if ephemeral.

        Ephemeral roots also unlink every shared-memory segment they
        recorded — arenas of BOTH live generations and data-plane rings — so
        a throwaway store cannot leave machine-wide segments behind even
        mid-rollover (a SIGKILLed worker still holding generation N included:
        its segments and rings are recorded, and records, not process state,
        drive the teardown). Persistent roots keep their segments (the warm
        machine).

        Ordering matters and is load-bearing: (1) retire-and-drain this
        process's epoch caches, so no cache entry keeps prebuilt views over
        segments about to vanish (retired old-generation entries included);
        (2) unlink every recorded segment while ``<root>/shm/`` still
        exists — the records ARE the census, so deleting the store first
        would orphan the segments machine-wide; (3) remove the store tree
        last."""
        if self._ephemeral:
            from repro_torch.core import shm_arena
            from repro_torch.core.epoch_cache import process_cache

            caches = [self.executor.epoch_cache]
            if self.executor.epoch_cache is not process_cache():
                caches.append(process_cache())
            for cache in caches:
                try:
                    cache.bump_epoch()
                    cache.drain_retired()
                except Exception:
                    pass  # never let teardown mask the caller's work
            try:
                shm_arena.unlink_root_segments(self.registry)
            except Exception:
                pass
            shutil.rmtree(self.root, ignore_errors=True)

    def __enter__(self) -> "Workspace":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (
            f"Workspace(root={self.root!r}, mode={self.mode.value}, "
            f"epoch={self.epoch})"
        )

    # ----------------------------------------------------------- properties
    @property
    def mode(self) -> Mode:
        return self.manager.mode

    @property
    def epoch(self) -> int:
        return self.manager.epoch

    @property
    def epoch_gen(self) -> int:
        """The commit generation this workspace currently serves."""
        return self.manager.epoch_gen

    def world(self) -> World:
        """The world view current loads resolve against."""
        return self.manager.world()

    # ------------------------------------------------------------- rollover
    def epoch_watch(
        self, *, fallback_interval_s: Optional[float] = 0.25
    ) -> EpochWatch:
        """A commit detector seeded at this workspace's current generation.

        The read half of the blue/green handshake: a serving loop polls the
        watch between requests (two ints of stat cost per poll) and, when a
        sibling process's ``end_mgmt`` lands generation N+1, flips at a
        request boundary via ``ws.refresh()`` / ``engine.adopt_epoch()``
        while its in-flight requests finish on N.

        ``fallback_interval_s`` throttles the coarse-mtime fallback parse
        (see :class:`EpochWatch`); ``None`` disables it.
        """
        return EpochWatch(
            self.registry,
            epoch_gen=self.epoch_gen,
            fallback_interval_s=fallback_interval_s,
        )

    def refresh(self) -> bool:
        """Adopt a sibling process's committed generation (read-side flip).

        Re-reads ``state.json``; when a newer commit is found the manager
        adopts the committed world + generation and the epoch caches are
        token-bumped so new loads fill from generation N+1 — while entries
        the old generation's in-flight requests still pin stay resident as
        *retired* until ``gc(drain=True)``. No-op (False) during a local
        management session or when nothing changed.
        """
        changed = self.manager.refresh()
        if changed:
            from repro_torch.core.epoch_cache import process_cache

            self.executor.epoch_cache.bump_epoch()
            if self.executor.epoch_cache is not process_cache():
                process_cache().bump_epoch()
        return changed

    def rollback_epoch(self, *, to_gen: Optional[int] = None) -> int:
        """Abort a bad flip: re-adopt a retained generation (default: the
        one serving before the last commit) as a NEW generation with
        byte-identical bindings.

        The previous world is still live on disk (the retained chain keeps
        its tables/arenas/segments reclaim-protected), so the re-adopt is
        a cheap re-link, not a restore. ``epoch_gen`` stays monotone — a
        rollback propagates through every ``ws.epoch_watch()`` in the
        fleet exactly like a commit — and ``state.json`` records
        ``rolled_back_from`` until the next normal commit; the journal
        records the abort. Refreshes first so a stale workspace always
        rolls back from the true newest generation. Returns the new
        ``epoch_gen``. The manager raises ``RollbackError`` when the
        window was already drained, ``ModeError`` during an open
        management session.
        """
        self.manager.refresh()
        gen = self.manager.rollback(to_gen=to_gen)
        # Manager.rollback bumped its own epoch_cache (and the process
        # cache); mirror end_mgmt's discipline for a privately injected
        # executor cache that the manager does not know about.
        if self.executor.epoch_cache is not self.manager.epoch_cache:
            self.executor.epoch_cache.bump_epoch()
        return gen

    def objects(self) -> Iterator[StoreObject]:
        return self.registry.iter_objects()

    # ------------------------------------------------------------ management
    @contextmanager
    def management(self, *, materialize: bool = True, resume: bool = False):
        """One transactional management time.

        Entering from an epoch runs ``begin_mgmt``. Entering while already
        in management (a fresh store, or a crashed session's leftovers)
        starts from a clean staged world unless ``resume=True`` explicitly
        adopts the dead session's staging: the journal is replayed over the
        committed world so ``tx.diff()`` / ``tx.preview()`` show exactly
        what was staged before the operator continues or resets. Clean exit
        commits and materializes; any exception rolls the staged world back
        and re-raises.
        """
        mgr = self.manager
        resumed = False
        if mgr.mode == Mode.MANAGEMENT:
            if resume:
                entries = self.journal.entries()
                if entries and entries[-1].seq >= mgr.journal_seq:
                    # The journal is authoritative on resume: replaying it
                    # over the committed world reproduces the staged world
                    # op by op (and heals a pending snapshot that lost the
                    # crashing op's write).
                    mgr.restore_staged(
                        self.journal.replay(mgr.committed_bindings)
                    )
                    resumed = True
                else:
                    # The journal is absent (pre-journal store, direct-
                    # Manager staging) or *behind* the persisted state
                    # (swapped/truncated out-of-band): the pending snapshot
                    # is the better record and is already live in staged.
                    # Resync the journal to describe it, so ops staged from
                    # here build on a complete record — otherwise a later
                    # crash+resume would replay a journal that silently
                    # drops the snapshot-adopted ops.
                    resumed = self._resync_journal_from_staged(mgr)
            else:
                mgr.reset_staged()
        else:
            mgr.begin_mgmt()
        tx = ManagementTransaction(mgr, resumed=resumed)
        try:
            yield tx
            tx._commit(materialize=materialize)
        except BaseException:
            # Covers both body exceptions and commit-time materialization
            # failures: either way the staged world is discarded and the
            # committed epoch stays authoritative.
            tx._rollback()
            raise

    def _resync_journal_from_staged(self, mgr: Manager) -> bool:
        """Rewrite the journal to describe the currently adopted staged
        world (synthetic publish/remove entries from the staged-vs-committed
        delta). Returns True when the adopted staging is non-empty."""
        from .journal import world_diff

        self.journal.clear()
        d = world_diff(mgr.committed_bindings, mgr.staged_bindings)
        if d.is_empty:
            return False
        published = {**d.added, **{n: nh for n, (_, nh) in d.upgraded.items()}}
        for name in sorted(published):
            h = published[name]
            try:
                obj = self.registry.get(h)
                self.journal.record(
                    "publish",
                    name=name,
                    content_hash=h,
                    payload_size=obj.payload_size,
                    kind=int(obj.kind),
                    version=obj.version,
                )
            except Exception:
                # manifest unreadable: record the binding itself at least
                self.journal.record("publish", name=name, content_hash=h)
        for name in sorted(d.removed):
            self.journal.record(
                "remove", name=name, content_hash=d.removed[name]
            )
        # persist the new journal_seq into state.json (staged unchanged)
        mgr.restore_staged(mgr.staged_bindings)
        return True

    # ----------------------------------------------------------------- load
    def load(
        self,
        name: str,
        *,
        strategy: str = "auto",
        world: Optional[World] = None,
    ):
        """Load an application image; dispatches via the strategy registry."""
        image = self.executor.load(name, strategy=strategy, world=world)
        stats = getattr(image, "stats", None)
        if stats is not None:
            self._last_stats[name] = stats
        return image

    def warmup(
        self,
        names=None,
        *,
        strategy: Optional[str] = None,
        workers: int = 4,
        store=None,
        policy=None,
    ) -> WarmupReport:
        """Batch-preload a world at epoch start (fleet warm-start, one call).

        Every named application (default: all of them) is loaded in
        parallel over ``workers`` threads through the process-wide
        EpochCache, so each (app, closure) arena is parsed and mapped
        exactly once no matter how many threads — or later replicas — ask
        for it. After ``warmup`` returns, every ``ws.load`` of a warmed app
        this epoch is a cache hit. The report carries the per-app images
        (``report.images``) plus hit/fill counts for observability.

        ``store=`` turns the warmup into a fleet warm-THROUGH-store: pass
        a served store URL (``repro_torch.launch.store``) — or an existing
        ``TieredStore`` — and missing arenas are downloaded (verified,
        resumable, retried; see ``core/arena_store``) then published to
        shm, instead of requiring a local bake. One machine bakes and
        exports; every other machine warms with one call. The default
        strategy flips to ``stable-remote`` when a store is attached;
        ``policy=`` forwards a ``FetchPolicy``. ``report.degraded`` /
        ``report.store`` surface what the fetch path had to survive.
        """
        if store is not None:
            self.attach_store(store, policy=policy)
        if strategy is None:
            strategy = (
                "stable-remote"
                if self.executor.arena_store is not None
                else "stable-mmap-cached"
            )
        t0 = time.perf_counter()
        images = self.executor.load_all(
            names, strategy=strategy, workers=workers
        )
        # hit/fill accounting from the per-image LoadStats, not global
        # cache-counter deltas: concurrent loaders (the fleet scenario)
        # must not bleed their traffic into this report
        flags = [
            bool(getattr(getattr(img, "stats", None), "cache_hit", False))
            for img in images.values()
        ]
        report = WarmupReport(
            strategy=strategy,
            workers=workers,
            wall_s=time.perf_counter() - t0,
            names=list(images),
            cache_hits=sum(flags),
            cache_fills=len(flags) - sum(flags),
            images=images,
        )
        tiered = self.executor.arena_store
        if tiered is not None:
            report.degraded = tiered.report.degraded
            report.store = tiered.report.summary()
        for name, image in images.items():
            stats = getattr(image, "stats", None)
            if stats is not None:
                self._last_stats[name] = stats
        return report

    # ------------------------------------------------------------ store tier
    def attach_store(self, store, *, policy=None, codec: str = "zlib"):
        """Attach the tiered arena store consulted by ``stable-remote``.

        ``store`` is a served store URL (``"http://host:port"``, see
        ``python -m repro_torch.launch.store``), or an already-built
        ``TieredStore`` (tests compose fault policies directly). Returns
        the attached ``TieredStore`` (``.report`` carries the counters).
        """
        from repro_torch.core.arena_store import TieredStore

        if isinstance(store, TieredStore):
            tiered = store
        else:
            tiered = TieredStore(
                self.registry, url=os.fspath(store) if not isinstance(store, str) else store,
                policy=policy, codec=codec,
            )
        self.executor.arena_store = tiered
        return tiered

    def detach_store(self) -> None:
        self.executor.arena_store = None

    def export_store(self, *, codec: str = "zlib") -> dict:
        """Publish every baked arena into ``<root>/store/`` (blobs +
        index) so ``repro_torch.launch.store`` can serve this machine's bakes
        to a fleet. Returns the export summary (entries, raw vs encoded
        bytes)."""
        from repro_torch.core.arena_store import export_store

        return export_store(self.registry, codec=codec)

    def store_report(self):
        """The attached store's ``StoreReport`` (None when detached)."""
        tiered = self.executor.arena_store
        return tiered.report if tiered is not None else None

    # -------------------------------------------------------------- garbage
    def gc(self, *, drain: bool = False, dry_run: bool = False) -> GcReport:
        """Reclaim dead store entries: delete every ``tables/`` file
        (materialized table, baked arena, sidecar) whose (app, closure) key
        appears in no world this workspace still honours, and unlink every
        shared-memory arena segment this root published whose key is dead,
        whose generation no longer matches its sidecar, or whose creator
        died mid-fill (``core.shm_arena.gc_segments`` — SIGKILLed workers
        cannot leak segments past the next explicit gc).

        The live set is the committed world plus — during management time —
        the staged world, including each world's legacy world-hash keys, so
        nothing a current or in-flight epoch could load is ever touched.
        **Every retained generation is live too** (the rollover window,
        now a chain): after a commit the outgoing world's tables, arenas,
        and shm segments stay protected by default — back-to-back commits
        keep BOTH still-draining generations protected — because a fleet's
        in-flight requests may still be finishing on them, and because the
        chain is what ``rollback_epoch`` rolls back to. Once every reader
        has flipped, ``gc(drain=True)`` closes the window: the retained
        chain is dropped (memory and state), retired epoch-cache entries
        are reclaimed, and the old generations' store files and segments
        become collectable in the same pass.

        ``dry_run=True`` is the operator preflight before ``drain=True``
        closes a rollback window: the report names exactly what the same
        call without ``dry_run`` would reclaim (tables, arenas, shm
        segments, rings — and, via ``retired_entries``/``retired_bytes``,
        the epoch-cache entries a drain would release), but nothing is
        unlinked, no state is persisted, and no cache token moves.

        The store tier rides along: quarantine records and orphaned
        partial downloads under ``<root>/store/`` are reclaimed in the
        same pass (``store_files_removed``) — verified blobs are kept as
        the warm fetch cache.

        Only an explicit call runs this; it is never triggered implicitly
        during an epoch. Returns a ``GcReport`` (``bytes_reclaimed``,
        ``removed_files``, ``segments_removed``, ``store_files_removed``).
        The epoch cache is token-bumped afterwards so no mapping outlives
        its backing file unnoticed.
        """
        if drain and not dry_run:
            # Close the rollover window first so the retained chain's keys
            # drop out of the live set computed below. Adopt any sibling's
            # newer commit before persisting the drop, so a stale manager
            # can never clobber a newer generation's state.
            self.manager.refresh()
            self.manager.drop_previous()
        worlds = [self.manager.committed_world()]
        if self.mode == Mode.MANAGEMENT:
            worlds.append(self.manager.world())
        if not drain:
            # every retained generation in the chain stays protected
            worlds.extend(w for _, w in self.manager.retained_worlds())
        # Another process may have committed (or staged) a newer world since
        # this workspace was opened; its keys are just as live. Re-read the
        # persisted state so a long-lived workspace can never gc a newer
        # epoch's tables out from under a sibling process.
        try:
            st = self.registry.read_state()
            worlds.append(World(self.registry, st.get("world", {})))
            worlds.append(World(self.registry, st.get("pending", {})))
            if not drain:
                for entry in st.get("retained", []):
                    worlds.append(
                        World(self.registry, entry.get("world", {}))
                    )
        except Exception:
            pass  # unreadable state: fall back to the in-memory views
        live: set[tuple[str, str]] = set()
        for world in worlds:
            try:
                apps = world.applications()
            except UnknownObjectError:
                continue  # world view with dangling refs: nothing resolvable
            for app in apps:
                # legacy pre-closure-hash stores keyed by the world hash
                live.add((app.content_hash, world.world_hash))
                try:
                    live.add((app.content_hash, self.executor.closure_key(app, world)))
                except UnknownObjectError:
                    # broken staged closure: it has no materialized key to
                    # protect (materialization would fail), skip it
                    continue
        report = self.registry.gc_stores(live, dry_run=dry_run)
        from repro_torch.core import shm_arena

        seg_removed, seg_bytes = shm_arena.gc_segments(
            self.registry, live, dry_run=dry_run
        )
        report.removed.extend(seg_removed)
        report.segments_removed = len(seg_removed)
        report.bytes_reclaimed += seg_bytes
        # Store tier: quarantine records and orphaned partial downloads
        # are reclaim-on-gc by contract (quarantined bytes are never
        # retried, so nothing ever reads them again). Verified blobs stay
        # — they are the warm fetch cache.
        from repro_torch.core.arena_store import gc_store_dirs

        store_removed, store_bytes = gc_store_dirs(
            self.registry, dry_run=dry_run
        )
        report.removed.extend(store_removed)
        report.store_files_removed = len(store_removed)
        report.bytes_reclaimed += store_bytes
        from repro_torch.core.epoch_cache import process_cache

        caches = [self.executor.epoch_cache]
        if self.executor.epoch_cache is not process_cache():
            caches.append(process_cache())
        if dry_run:
            # preflight only: report what a drain would additionally
            # reclaim from the epoch caches, touch nothing
            report.retired_entries = sum(c.retired_count() for c in caches)
            report.retired_bytes = sum(c.retired_bytes() for c in caches)
            return report
        # Mirror end_mgmt: a private (injected) cache is bumped AND the
        # process-wide one, so default-wired workspaces over the same root
        # never keep serving mappings of files this gc just unlinked.
        for cache in caches:
            cache.bump_epoch()
            if drain:
                # end of the rollover window: retired (old-gen,
                # still-pinned) entries are reclaimed now that no reader
                # is entitled to them any more
                cache.drain_retired()
        return report

    # -------------------------------------------------------------- explain
    def explain(self, name: str, *, pending: bool = False) -> LinkReport:
        """The app's relocation mapping, observable at any time.

        Reads the materialized table when the current world has one (the
        epoch path — no resolution happens); otherwise resolves dynamically
        to preview the mapping, without writing anything.

        ``pending=True`` (management time only) explains the *staged*,
        uncommitted world and attaches the app's relocation delta versus
        the committed epoch (``report.delta``), so an operator can inspect
        exactly what a commit would change before it lands.
        """
        if pending and self.mode != Mode.MANAGEMENT:
            raise ModeError(
                "explain(pending=True) outside management time: there is "
                "no staged world to preview"
            )
        world = self.world()
        app = world.resolve(name)
        try:
            key = self.executor.closure_key(app, world)
            path = self.registry.table_path(app.content_hash, key)
        except UnknownObjectError:
            # broken closure (a staged world missing a dependency): no
            # materialized table can exist for it
            path = None
        delta = None
        if pending:
            # Staged-world dry run for this app only. Tolerant: a staged
            # world with broken refs still explains (the breakage shows up
            # in delta.unresolved, not as a raise); the dry run's
            # relocations are reused for the preview table.
            from .journal import app_relocation_delta

            delta, relocations = app_relocation_delta(self.manager, app)
            table = build_table(
                app,
                relocations,
                world_hash=world.world_hash,
                epoch=self.epoch,
            )
            source = "staged-preview"
        elif path is not None and path.exists():
            table = RelocationTable.load(path)
            source = "materialized-table"
        else:
            resolver = DynamicResolver(world)
            table = build_table(
                app,
                resolver.resolve(app),
                world_hash=world.world_hash,
                epoch=self.epoch,
            )
            source = "dynamic-resolution"
        last_mat = self.manager.last_materialization
        return report_from_table(
            table,
            app=app.name,
            epoch=self.epoch,
            world_hash=world.world_hash,
            mode=self.mode.value,
            source=source,
            stats=self._last_stats.get(name),
            delta=delta,
            materialization=last_mat.summary() if last_mat is not None else None,
        )

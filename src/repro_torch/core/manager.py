"""The Manager (§4.1): mode state machine + object-registry gatekeeper.

``begin_mgmt`` / ``update_obj`` / ``end_mgmt`` exactly as in the paper:

* ``begin_mgmt``  — EPOCH -> MANAGEMENT. Staged world starts as a copy of the
  committed world.
* ``update_obj``  — only legal in MANAGEMENT; registers the object and updates
  the staged world binding for its name. Attempting this during an epoch
  raises ImmutableEpochError (the paper's key invariant).
* ``end_mgmt``    — commits the staged world, bumps the epoch counter, flips
  to EPOCH, and invokes the Executor with the ``materialize`` flag for every
  application whose relocation table is missing/stale under the new world.
* ``abort_mgmt``  — discards the staged world and returns to the committed
  one: the rollback half of ``repro_torch.link.Workspace.management()``
  transactions. Objects already written to the content-addressed store stay
  on disk (they are unreferenced, hence invisible to every world view).

In our ML framing a management time is a cluster maintenance window (publish
a checkpoint, roll a kernel library, change the mesh); an epoch is the
steady-state period in between, during which every job start may safely reuse
the materialized tables.

Crash consistency: the persisted state always carries both the committed
``world`` and the staged ``pending`` snapshot. A process that dies during
management time leaves ``mode=management`` + its partial ``pending`` behind;
on reload that pending is only honoured while still in management (an
explicit resume), and a state that claims ``mode=epoch`` has its pending
forced back to the committed world — a half-staged snapshot can never leak
into the next epoch's bindings.

Journal hooks: an optional ``journal`` sink (``repro_torch.link.journal.Journal``
or anything with ``record``/``clear``/``last_seq``) receives one entry per
staged op and is truncated at every session boundary (begin/commit/abort/
reset). The Manager itself stays journal-agnostic — with ``journal=None``
(direct engine-room wiring, benchmarks below the facade) behaviour and cost
are exactly as before, and nothing is journaled on the epoch load path.

Direct ``Manager`` wiring is deprecated for application code — use
``repro_torch.link.Workspace``, which adds transactional management times on top.
"""

from __future__ import annotations

import time
from enum import Enum
from typing import Callable, Optional

from .epoch_cache import process_cache
from .errors import (
    ImmutableEpochError,
    ModeError,
    RollbackError,
    UnknownObjectError,
)
from .objects import StoreObject
from .registry import Registry, World


class Mode(str, Enum):
    MANAGEMENT = "management"
    EPOCH = "epoch"


def _load_retained(st: dict) -> list[dict]:
    return [
        {
            "epoch_gen": int(e.get("epoch_gen", 0)),
            "world": dict(e.get("world", {})),
        }
        for e in st.get("retained", [])
        if e.get("world")
    ]


class Manager:
    #: How many outgoing generations each commit keeps reclaim-protected
    #: (the retained chain's length cap). 2 covers a commit landing while
    #: the fleet is still draining the PREVIOUS window — back-to-back
    #: rollovers; generations trimmed past the cap are gracefully retired:
    #: their pinned cache entries drain through the retire machinery and
    #: their store files become collectable at the next gc.
    RETAIN_GENERATIONS = 2

    def __init__(self, registry: Registry):
        self.registry = registry
        st = registry.read_state()
        self._mode = Mode(st.get("mode", "management"))
        self._epoch = int(st.get("epoch", 0))
        self._epoch_gen = int(st.get("epoch_gen", self._epoch))
        self._world = dict(st.get("world", {}))      # committed bindings
        # The retained generation chain (oldest first): outgoing committed
        # worlds kept through commits (blue/green rollover window) until
        # Workspace.gc(drain=True) drops them, so each retained gen's
        # tables/arenas/segments stay reclaim-protected while a fleet
        # drains onto the newest generation. Capped at RETAIN_GENERATIONS.
        self._retained: list[dict] = _load_retained(st)
        # Nonzero after a rollback: the generation that was aborted (its
        # world re-joins the chain so a mid-flip fleet can drain back).
        # Cleared by the next normal commit.
        self._rolled_back_from = int(st.get("rolled_back_from", 0))
        # Generations the most recent commit/rollback trimmed off the
        # chain (in-memory observability of the graceful retirement).
        self.last_retired: list[int] = []
        if self._mode == Mode.EPOCH:
            # A stale pending snapshot (e.g. from a crash mid-management in a
            # different process) must not survive into epoch state.
            self._staged = dict(self._world)
        else:
            self._staged = dict(st.get("pending", self._world))
        # Staged interposition edits (tx.rebind): applied to the freshly
        # materialized tables at end_mgmt, persisted as `pending_edits` so a
        # crashed session's staged edits are visible on resume.
        self._staged_edits: list[dict] = (
            [dict(e) for e in st.get("pending_edits", [])]
            if self._mode == Mode.MANAGEMENT
            else []
        )
        # Hook invoked by end_mgmt; wired to Executor.materialize_all.
        self.on_materialize: Optional[Callable[[World, int], None]] = None
        # Hook invoked by end_mgmt when interposition edits are staged;
        # wired to Executor.apply_interposition_edits.
        self.on_edits: Optional[Callable[[World, list], None]] = None
        # Result of the most recent end_mgmt materialization pass (an
        # Executor.MaterializationResult: which apps re-materialized, which
        # tables were reused, index/bake timings). In-memory only.
        self.last_materialization = None
        # Optional journal sink (record/clear/last_seq); wired by Workspace.
        self.journal = None
        self._journal_seq = int(st.get("journal_seq", 0))
        # The epoch-resident cache this manager's commits invalidate.
        # Executor.__init__ re-points it at its own cache when a private
        # one is injected (tests); the process cache is bumped either way.
        self.epoch_cache = process_cache()
        # Memoized world view (dropped by _persist on every state change).
        self._world_view: Optional[World] = None

    # ------------------------------------------------------------- properties
    @property
    def mode(self) -> Mode:
        return self._mode

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def epoch_gen(self) -> int:
        """The committed world's generation number (monotone across
        commits; the store-level analogue of the EpochCache token)."""
        return self._epoch_gen

    @property
    def previous_epoch_gen(self) -> int:
        """Generation number of the newest retained world (0 = none)."""
        return self._retained[-1]["epoch_gen"] if self._retained else 0

    @property
    def previous_bindings(self) -> dict[str, str]:
        """Bindings of the newest retained world (compat accessor over the
        head of the generation chain)."""
        return dict(self._retained[-1]["world"]) if self._retained else {}

    @property
    def rolled_back_from(self) -> int:
        """The generation the most recent rollback aborted (0 = the current
        generation was reached by a normal commit)."""
        return self._rolled_back_from

    def retained_generations(self) -> list[int]:
        """Generation numbers currently in the retained chain (oldest
        first) — every one of them is reclaim-protected."""
        return [e["epoch_gen"] for e in self._retained]

    def retained_worlds(self) -> list[tuple[int, World]]:
        """(epoch_gen, World) for every retained generation, oldest first."""
        return [
            (e["epoch_gen"], World(self.registry, e["world"]))
            for e in self._retained
        ]

    @property
    def staged_edits(self) -> list[dict]:
        """Interposition edits staged this session (``tx.rebind``)."""
        return [dict(e) for e in self._staged_edits]

    def previous_world(self) -> Optional[World]:
        """The newest retained generation's world view, or None once the
        chain has been dropped (``drop_previous`` / fresh store)."""
        if not self._retained:
            return None
        return World(self.registry, self._retained[-1]["world"])

    def drop_previous(self) -> None:
        """End the rollover window: forget every retained generation's
        bindings so the next ``Workspace.gc`` may reclaim their tables/
        arenas/segments. Called by ``Workspace.gc(drain=True)`` after the
        fleet drained."""
        if not self._retained:
            return
        self._retained = []
        self._persist()

    def _trim_retained(self) -> None:
        """Cap the chain: generations past RETAIN_GENERATIONS are
        gracefully retired — recorded in ``last_retired``, their keys
        become collectable at the next gc, and their still-pinned cache
        entries drain through the retire machinery (never flash-cleared)."""
        while len(self._retained) > self.RETAIN_GENERATIONS:
            self.last_retired.append(self._retained.pop(0)["epoch_gen"])

    def refresh(self) -> bool:
        """Re-read the persisted state and adopt a sibling process's commit.

        A Manager snapshots ``state.json`` at construction; a long-running
        serving worker that must observe another process's ``end_mgmt``
        (the rollover handshake) calls this at a request boundary. Only
        meaningful outside management time — a refresh mid-staging would
        clobber the open session, so it is a no-op then. Returns True when
        a newer generation was adopted."""
        if self._mode == Mode.MANAGEMENT:
            return False
        st = self.registry.read_state()
        gen = int(st.get("epoch_gen", int(st.get("epoch", 0))))
        if gen == self._epoch_gen and st.get("world", {}) == self._world:
            return False
        # Adopt only the committed half: a sibling may already be staging
        # its NEXT session (state mode=management), but this process is a
        # passive observer and stays in epoch mode on the committed world.
        self._epoch = int(st.get("epoch", 0))
        self._epoch_gen = gen
        self._world = dict(st.get("world", {}))
        self._retained = _load_retained(st)
        self._rolled_back_from = int(st.get("rolled_back_from", 0))
        self._staged = dict(self._world)
        self._journal_seq = int(st.get("journal_seq", self._journal_seq))
        self._world_view = None
        return True

    def world(self) -> World:
        """The world view current processes should link against.

        The view is memoized until the next state change (``_persist``
        drops it): ``World`` snapshots its bindings at construction, so the
        epoch load hot path stops paying a dict copy + world-hash digest
        per load."""
        if self._world_view is None:
            bindings = (
                self._staged if self._mode == Mode.MANAGEMENT else self._world
            )
            self._world_view = World(self.registry, bindings)
        return self._world_view

    def committed_world(self) -> World:
        return World(self.registry, self._world)

    @property
    def journal_seq(self) -> int:
        """Last journal sequence number the persisted state has seen.

        A journal whose tail is *behind* this value lost entries relative
        to the state file (swapped or truncated out-of-band) and must not
        be replayed over it; one at or ahead of it is authoritative."""
        return self._journal_seq

    @property
    def committed_bindings(self) -> dict[str, str]:
        return dict(self._world)

    @property
    def staged_bindings(self) -> dict[str, str]:
        return dict(self._staged)

    # ------------------------------------------------------------- operations
    def begin_mgmt(self) -> None:
        if self._mode == Mode.MANAGEMENT:
            raise ModeError("already in management time")
        self._mode = Mode.MANAGEMENT
        self._staged = dict(self._world)
        self._staged_edits = []
        self._journal_clear()
        self._persist()

    def update_obj(self, obj: StoreObject, payload: bytes = b"") -> StoreObject:
        """Register (or upgrade) an object. Management time only."""
        if self._mode != Mode.MANAGEMENT:
            raise ImmutableEpochError(
                f"update_obj({obj.name!r}) during epoch {self._epoch}: "
                "system objects are immutable outside management time"
            )
        self.registry.add(obj, payload)
        self._staged[obj.name] = obj.content_hash
        self._journal_record("publish", obj)
        self._persist()
        return obj

    def update_obj_file(self, obj: StoreObject, payload_file) -> StoreObject:
        if self._mode != Mode.MANAGEMENT:
            raise ImmutableEpochError(
                f"update_obj({obj.name!r}) during epoch {self._epoch}"
            )
        self.registry.add_with_payload_file(obj, payload_file)
        self._staged[obj.name] = obj.content_hash
        self._journal_record("publish-file", obj)
        self._persist()
        return obj

    def remove_obj(self, name: str) -> None:
        if self._mode != Mode.MANAGEMENT:
            raise ImmutableEpochError(f"remove_obj({name!r}) during epoch")
        if name not in self._staged:
            raise UnknownObjectError(name)
        old_hash = self._staged.pop(name)
        if self.journal is not None:
            self.journal.record("remove", name=name, content_hash=old_hash)
        self._persist()

    def stage_edit(
        self,
        app_name: str,
        symbol_glob: str,
        provider_name: str,
        requires_glob: Optional[str] = None,
    ) -> dict:
        """Stage a fine-grained interposition edit (``interpose.rebind``).

        Management time only. The edit is applied to ``app_name``'s freshly
        materialized table at ``end_mgmt`` (rows matching ``symbol_glob``
        rebound to the staged world's ``provider_name``, FLAG_EDITED set,
        arena re-baked), journaled as an ``edit`` row, and visible in
        ``tx.preview()`` before the commit. Both the app and the provider
        must be bound in the staged world when the edit is staged.
        """
        if self._mode != Mode.MANAGEMENT:
            raise ImmutableEpochError(
                f"stage_edit({app_name!r}) during epoch {self._epoch}: "
                "interposition edits are staged in management time"
            )
        if app_name not in self._staged:
            raise UnknownObjectError(app_name)
        if provider_name not in self._staged:
            raise UnknownObjectError(provider_name)
        edit = {
            "app": app_name,
            "symbol_glob": symbol_glob,
            "provider": provider_name,
            "requires_glob": requires_glob,
        }
        self._staged_edits.append(edit)
        if self.journal is not None:
            # name carries app + glob (the journal's name field is the
            # operator-facing identity of the row); content_hash pins the
            # provider bytes the edit will bind.
            self.journal.record(
                "edit",
                name=f"{app_name}!{symbol_glob}",
                content_hash=self._staged[provider_name],
                version=provider_name,
            )
        self._persist()
        return dict(edit)

    def reset_staged(self) -> None:
        """Drop staged changes without leaving management time.

        Used when a new management session starts over a leftover pending
        snapshot (e.g. after a crash) and must not inherit it.
        """
        if self._mode != Mode.MANAGEMENT:
            raise ModeError("reset_staged outside management time")
        self._staged = dict(self._world)
        self._staged_edits = []
        self._journal_clear()
        self._persist()

    def restore_staged(self, bindings: dict[str, str]) -> None:
        """Adopt an explicit staged world (journal replay on resume)."""
        if self._mode != Mode.MANAGEMENT:
            raise ModeError("restore_staged outside management time")
        self._staged = dict(bindings)
        self._persist()

    def abort_mgmt(self) -> None:
        """Roll back the current management time.

        The staged world is discarded and the committed world of the current
        epoch stays authoritative. If an epoch has ever been committed the
        manager returns to EPOCH mode (the state it was in before
        ``begin_mgmt``); a never-committed manager (epoch 0) stays in
        management with a clean slate, since there is no epoch to return to.
        """
        if self._mode != Mode.MANAGEMENT:
            raise ModeError("abort_mgmt outside management time")
        self._staged = dict(self._world)
        self._staged_edits = []
        if self._epoch > 0:
            self._mode = Mode.EPOCH
        self._journal_clear()
        self._persist()

    def end_mgmt(self, materialize: bool = True) -> int:
        """Commit the staged world and enter a new epoch.

        Returns the new epoch number. Invokes the materialization hook (the
        Executor with the ``materialize`` flag) *before* the epoch is usable,
        exactly as MATR extends Nix (§4.1).
        """
        if self._mode != Mode.MANAGEMENT:
            raise ModeError("end_mgmt outside management time")
        new_world = World(self.registry, dict(self._staged))
        new_epoch = self._epoch + 1
        # Retire the epoch-resident runtime's old generation BEFORE
        # materializing: every index/table/arena entry the materialization
        # pass fills is then born under the new token instead of being
        # invalidated microseconds after it was built. Pinned old-gen
        # entries (mapped out to requests still in flight) stay resident as
        # retired until the fleet drains — the blue/green window. Entries
        # other threads fill from old-epoch files in the window are
        # content-keyed, hence still correct if their closure survives the
        # commit and unreachable if not. A materialization failure leaves
        # only over-invalidation.
        self.epoch_cache.bump_epoch()
        if self.epoch_cache is not process_cache():
            process_cache().bump_epoch()
        if materialize and self.on_materialize is not None:
            # Materialization happens while still formally in management time:
            # the Executor may run the resolution path to observe mappings.
            # It runs BEFORE the commit below, so a failure (e.g. an
            # unresolvable symbol in a staged app) leaves the committed
            # world and epoch untouched — the management session stays open
            # to be fixed or aborted.
            self.last_materialization = self.on_materialize(new_world, new_epoch)
        if self._staged_edits:
            if self.on_edits is None:
                raise ModeError(
                    "interposition edits staged but no executor wired to "
                    "apply them (Manager.on_edits is unset)"
                )
            # Same window as materialization: a failing edit (e.g. the
            # provider stopped exporting the symbol) aborts the commit with
            # the session still open. Runs after materialize so it edits
            # the NEW generation's tables.
            self.on_edits(new_world, self.staged_edits)
        # Generation rollover: push the outgoing committed world onto the
        # retained chain beside the new one. Its tables/arenas/shm segments
        # stay gc-protected until the operator ends the drain
        # (Workspace.gc(drain=True)) or the chain cap retires it — a commit
        # landing while the fleet still drains the PREVIOUS window keeps
        # BOTH draining generations protected instead of implicitly
        # forgetting the older one.
        self.last_retired = []
        if self._world:
            self._retained.append(
                {"epoch_gen": self._epoch_gen, "world": dict(self._world)}
            )
            self._trim_retained()
        self._world = dict(self._staged)
        self._epoch = new_epoch
        self._epoch_gen += 1
        self._rolled_back_from = 0
        self._staged_edits = []
        self._mode = Mode.EPOCH
        self._journal_clear()
        self._persist()
        return self._epoch

    def rollback(self, to_gen: Optional[int] = None) -> int:
        """Abort a bad flip: re-adopt a still-retained generation's world.

        Epoch mode only (an open management session has ``abort_mgmt``).
        The target defaults to the newest retained generation — the world
        that was serving before the bad commit. A rollback is itself a new
        generation (``epoch_gen`` stays monotone, so every ``EpochWatch``
        in the fleet notices it exactly like a commit) whose bindings are
        byte-identical to the target's; the aborted generation takes the
        target's place in the retained chain, so a worker caught mid-flip
        onto it can drain back before its segments are reclaimed. The
        state records ``rolled_back_from`` (cleared by the next normal
        commit) and the journal records the abort as a ``rollback`` row —
        replay ignores it, so a later ``management(resume=True)`` can
        never resurrect the aborted generation's staged ops.

        Returns the new (rolled-back) ``epoch_gen``.
        """
        if self._mode == Mode.MANAGEMENT:
            raise ModeError(
                "rollback during management time: abort the open session "
                "first (abort_mgmt)"
            )
        if not self._retained:
            raise RollbackError(
                "no retained generation to roll back to (the rollover "
                "window was drained)"
            )
        if to_gen is None:
            entry = self._retained[-1]
        else:
            matches = [
                e for e in self._retained if e["epoch_gen"] == int(to_gen)
            ]
            if not matches:
                raise RollbackError(
                    f"generation {to_gen} is not in the retained window "
                    f"(retained: {self.retained_generations()})"
                )
            entry = matches[-1]
        bad_gen, bad_world = self._epoch_gen, dict(self._world)
        self.last_retired = []
        self._retained = [e for e in self._retained if e is not entry]
        if bad_world:
            self._retained.append(
                {"epoch_gen": bad_gen, "world": bad_world}
            )
            self._trim_retained()
        self._world = dict(entry["world"])
        self._staged = dict(self._world)
        self._epoch += 1
        self._epoch_gen += 1
        self._rolled_back_from = bad_gen
        # Same cache discipline as a commit: the aborted generation's
        # entries are retired (pins drain), new loads fill under the new
        # token — and hit the target generation's still-live files.
        self.epoch_cache.bump_epoch()
        if self.epoch_cache is not process_cache():
            process_cache().bump_epoch()
        if self.journal is not None:
            # The abort is journaled (then superseded at the next session
            # boundary). Replay applies only publish/remove ops, so this
            # marker can never re-stage anything.
            self.journal.clear()
            self.journal.record(
                "rollback",
                name=f"epoch_gen:{bad_gen}",
                version=str(entry["epoch_gen"]),
            )
        self._persist()
        return self._epoch_gen

    # --------------------------------------------------------------- internal
    def _journal_record(self, op: str, obj: StoreObject) -> None:
        if self.journal is not None:
            self.journal.record(
                op,
                name=obj.name,
                content_hash=obj.content_hash,
                payload_size=obj.payload_size,
                kind=int(obj.kind),
                version=obj.version,
            )

    def _journal_clear(self) -> None:
        if self.journal is not None:
            self.journal.clear()

    def _persist(self) -> None:
        self._world_view = None  # bindings may have changed: drop the memo
        if self.journal is not None:
            self._journal_seq = int(self.journal.last_seq)
        self.registry.write_state(
            {
                "mode": self._mode.value,
                "epoch": self._epoch,
                "epoch_gen": self._epoch_gen,
                "world": self._world,
                "pending": self._staged,
                "pending_edits": self._staged_edits,
                # previous/previous_epoch_gen mirror the chain head so
                # schema-3 readers keep seeing the two-generation window
                "previous": self.previous_bindings,
                "previous_epoch_gen": self.previous_epoch_gen,
                "retained": [
                    {"epoch_gen": e["epoch_gen"], "world": dict(e["world"])}
                    for e in self._retained
                ],
                "rolled_back_from": self._rolled_back_from,
                "journal_seq": self._journal_seq,
                "mtime": time.time(),
            }
        )

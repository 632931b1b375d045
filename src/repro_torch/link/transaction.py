"""Transactional management times: the write half of a Workspace session.

``Workspace.management()`` yields a ``ManagementTransaction``. All staged
mutations go through it; the context manager commits (``end_mgmt`` +
materialization) on clean exit and rolls the staged world back
(``Manager.abort_mgmt``) if the body raises — the committed world, epoch
counter, and every materialized table of the current epoch are untouched by
a failed transaction.

Payload bytes already written into the content-addressed store by a rolled-
back transaction stay on disk: they are unreferenced by any world view, so
they are invisible (and re-publishable for free, being content-addressed).

Observability: every staged op is journaled (``repro_torch.link.journal``) and the
transaction exposes pre-commit views — ``tx.diff()`` for the binding-level
``WorldDiff`` and ``tx.preview()`` for the per-application relocation delta
a commit would produce. Both are read-only dry runs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from repro_torch.core.errors import ModeError
from repro_torch.core.manager import Manager
from repro_torch.core.objects import StoreObject
from repro_torch.core.registry import World

from .journal import (
    JournalEntry,
    PreviewReport,
    WorldDiff,
    preview_world,
    world_diff,
)


class ManagementTransaction:
    """Handle for staging world mutations inside one management time."""

    def __init__(self, manager: Manager, *, resumed: bool = False):
        self._manager = manager
        self._open = True
        self.epoch: Optional[int] = None  # set on commit
        self.resumed = resumed            # adopted a crashed session's staging
        # set on commit: the Executor's MaterializationResult (which apps
        # re-materialized vs reused their tables/baked arenas)
        self.materialization = None

    # ------------------------------------------------------------- guards
    def _check_open(self) -> None:
        if not self._open:
            raise ModeError(
                "management transaction already closed "
                "(commit/rollback happened)"
            )

    @property
    def active(self) -> bool:
        return self._open

    # ---------------------------------------------------------- mutations
    def publish(self, obj: StoreObject, payload: bytes = b"") -> StoreObject:
        """Stage an object (and optional payload bytes) into the world."""
        self._check_open()
        return self._manager.update_obj(obj, payload)

    def publish_file(self, obj: StoreObject, payload_file: Path) -> StoreObject:
        """Stage an object whose payload was pre-written to a file."""
        self._check_open()
        return self._manager.update_obj_file(obj, payload_file)

    def remove(self, name: str) -> None:
        """Unbind ``name`` from the staged world."""
        self._check_open()
        self._manager.remove_obj(name)

    def rebind(
        self,
        app_name: str,
        *,
        symbol_glob: str,
        provider_name: str,
        requires_glob: Optional[str] = None,
    ) -> dict:
        """Stage an interposition edit: at commit, rows of ``app_name``'s
        table whose symbol matches ``symbol_glob`` (and whose requiring
        object matches ``requires_glob``, if given) are retargeted to
        ``provider_name`` and stamped ``FLAG_EDITED``. ``tx.preview()``
        shows the affected rows as ``kind="edited"`` before any table is
        touched. Returns the staged edit record."""
        self._check_open()
        return self._manager.stage_edit(
            app_name,
            symbol_glob=symbol_glob,
            provider_name=provider_name,
            requires_glob=requires_glob,
        )

    # ------------------------------------------------------------- views
    def world(self) -> World:
        """The staged world view as this transaction currently sees it."""
        self._check_open()
        return self._manager.world()

    def diff(self) -> WorldDiff:
        """Staged-vs-committed binding delta (added/removed/upgraded)."""
        self._check_open()
        return world_diff(
            self._manager.committed_bindings,
            self._manager.staged_bindings,
            committed_world_hash=self._manager.committed_world().world_hash,
            staged_world_hash=self._manager.world().world_hash,
        )

    def preview(self) -> PreviewReport:
        """Relocation-delta preview: dry-run materialization against the
        staged world. Reports, per application, which relocations change
        provider/addend, which go unresolved, and exactly which tables will
        be rebuilt at commit versus reused (``tables_to_rebuild`` /
        ``tables_reused`` — closure-hash keyed, so an unrelated publish
        reuses everything). Writes nothing."""
        self._check_open()
        return preview_world(self._manager)

    def journal_entries(self) -> list[JournalEntry]:
        """The staged ops journaled so far in this management session."""
        self._check_open()
        journal = self._manager.journal
        return journal.entries() if journal is not None else []

    # ----------------------------------------------------- lifecycle (ws)
    def _commit(self, *, materialize: bool) -> int:
        self._check_open()
        # Close only after end_mgmt succeeds: a commit-time materialization
        # failure must leave the transaction open so _rollback still runs.
        epoch = self._manager.end_mgmt(materialize=materialize)
        self._open = False
        self.epoch = epoch
        self.materialization = self._manager.last_materialization
        return epoch

    def _rollback(self) -> None:
        if not self._open:
            return
        self._open = False
        self._manager.abort_mgmt()

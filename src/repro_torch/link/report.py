"""LinkReport: one observable view of an application's relocation mapping.

``Workspace.explain(name)`` unifies what used to need three hand-wired
pieces (Executor stats, the raw ``RelocationTable``, and the ``inspector``
exporters) into a single mid-epoch-safe report object:

* summary numbers — epoch, world hash, relocation counts by type, provider
  breakdown, arena size;
* the last observed ``LoadStats`` for the app (if the workspace loaded it);
* the inspector's JSON / CSV / SQLite views of the full mapping.

Explaining never mutates anything and never reads payload bytes: during an
epoch it reads the materialized table; during management time (no committed
table for the staged world yet) it runs the dynamic resolver to show the
mapping the *next* epoch would materialize.
"""

from __future__ import annotations

import sqlite3
from dataclasses import dataclass, field
from typing import Iterable, Optional

from repro_torch.core import inspector
from repro_torch.core.executor import LoadStats
from repro_torch.core.objects import RelocType, StoreObject
from repro_torch.core.relocation import RelocationTable

_TYPE_NAMES = {int(t): t.name for t in RelocType}


@dataclass
class LinkReport:
    """The relocation mapping of one application under one world."""

    app: str
    epoch: int
    world_hash: str
    mode: str                      # manager mode when the report was taken
    source: str                    # "materialized-table" | "dynamic-resolution"
    relocations: int
    arena_bytes: int
    by_type: dict[str, int] = field(default_factory=dict)
    providers: dict[str, int] = field(default_factory=dict)
    stats: Optional[LoadStats] = None   # last observed load, if any
    table: RelocationTable = None       # the full mapping (not in summary())
    # pre-commit only (explain(pending=True)): the app's relocation delta
    # versus the committed epoch — a repro_torch.link.journal.RelocationDelta
    delta: Optional[object] = None
    # summary of the most recent end_mgmt materialization pass (which apps
    # re-materialized vs reused their tables, index/bake timings), if one
    # happened in this process — a MaterializationResult.summary() dict
    materialization: Optional[dict] = None

    @property
    def pending(self) -> bool:
        """True when this report explains a staged, uncommitted world."""
        return self.source == "staged-preview"

    # ------------------------------------------------------------ summary
    def summary(self) -> dict:
        """JSON-ready scalar view (no table, stats flattened)."""
        out = {
            "app": self.app,
            "epoch": self.epoch,
            "world_hash": self.world_hash,
            "mode": self.mode,
            "source": self.source,
            "relocations": self.relocations,
            "arena_bytes": self.arena_bytes,
            "by_type": dict(self.by_type),
            "providers": dict(self.providers),
        }
        if self.delta is not None:
            out["pending_delta"] = self.delta.summary()
        if self.materialization is not None:
            out["materialization"] = dict(self.materialization)
        if self.stats is not None:
            out["last_load"] = {
                "strategy": self.stats.strategy,
                "startup_s": self.stats.startup_s,
                "resolve_s": self.stats.resolve_s,
                "table_load_s": self.stats.table_load_s,
                "io_s": self.stats.io_s,
                "read_s": self.stats.read_s,
                "stage_wait_s": self.stats.stage_wait_s,
                "index_build_s": self.stats.index_build_s,
                "relocations": self.stats.relocations,
                "probes": self.stats.probes,
                "bytes_loaded": self.stats.bytes_loaded,
            }
        return out

    # ------------------------------------------------- inspector passthrough
    def records(self) -> list[dict]:
        """Full-string relocation rows (the paper's Figure 6 struct)."""
        return inspector.table_records(self.table)

    def to_json(self) -> str:
        return inspector.to_json(self.table)

    def to_csv(self) -> str:
        return inspector.to_csv(self.table)

    def to_sqlite(
        self,
        path: str = ":memory:",
        *,
        abi_objects: Iterable[StoreObject] = (),
    ) -> sqlite3.Connection:
        return inspector.to_sqlite(
            [self.table], abi_objects=abi_objects, path=path
        )


def report_from_table(
    table: RelocationTable,
    *,
    app: str,
    epoch: int,
    world_hash: str,
    mode: str,
    source: str,
    stats: Optional[LoadStats] = None,
    delta: Optional[object] = None,
    materialization: Optional[dict] = None,
) -> LinkReport:
    """Build the summary breakdowns from a relocation table."""
    rows = table.rows
    by_type: dict[str, int] = {}
    providers: dict[str, int] = {}
    for i in range(len(rows)):
        tname = _TYPE_NAMES[int(rows["type"][i])]
        by_type[tname] = by_type.get(tname, 0) + 1
        prov = table.object_by_uuid(int(rows["provides_so_uuid"][i]))
        pname = prov["name"] if prov is not None else "(initializer)"
        providers[pname] = providers.get(pname, 0) + 1
    return LinkReport(
        app=app,
        epoch=epoch,
        world_hash=world_hash,
        mode=mode,
        source=source,
        relocations=len(rows),
        arena_bytes=int(table.arena_size),
        by_type=by_type,
        providers=providers,
        stats=stats,
        table=table,
        delta=delta,
        materialization=materialization,
    )

"""Management-time journal: operator-visible staging, diffs, and previews.

The paper's second headline claim is *observability*: stable linking lets a
developer "accurately observe a relocation mapping" before runtime. This
module extends that observability to the management time itself — the window
between ``begin_mgmt`` and commit, which used to be a black box.

Three pieces:

* ``Journal`` — an append-only JSONL record of every staged operation
  (publish / publish-file / remove, with object hashes, sizes, timestamps),
  persisted as ``<root>/journal.jsonl`` alongside the Manager's state file.
  The Manager appends one entry per staged op and truncates the journal at
  every session boundary (commit, abort, reset, fresh begin), so the file
  always describes exactly the *current* management session. A process that
  dies mid-management leaves the journal behind;
  ``Workspace.management(resume=True)`` replays it so the operator sees what
  the dead session had staged before choosing to continue or reset.

* ``WorldDiff`` — the structural view: added / removed / upgraded bindings
  of the staged world versus the committed world (``tx.diff()``).

* ``PreviewReport`` — the semantic view: a relocation-delta preview
  (``tx.preview()``) that dry-runs resolution against the staged world and
  reports, per application, which relocations change provider/addend, which
  go unresolved, and which tables will be rebuilt at commit. Nothing is
  written: the committed world, its tables, and the epoch counter are
  untouched by a preview.

Journal writes happen only during management time; the epoch load hot path
never touches this module (see ``benchmarks/run.py --smoke``'s
``journal_epoch_overhead`` row, which asserts zero bytes of journal I/O
across the strategy sweep).

Journal file format (one JSON object per line)::

    {"seq": 1, "op": "publish", "name": "weights:olmoe", "version": "2",
     "kind": 1, "content_hash": "…", "payload_size": 4096, "ts": 1699.0}

``op`` is one of ``publish`` / ``publish-file`` / ``remove``; ``remove``
entries carry the unbound name and the hash it pointed at. ``seq`` is
1-based and strictly increasing within a session.
"""

from __future__ import annotations

import csv
import io
import json
import os
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import TYPE_CHECKING, Optional

from repro_torch.core.errors import UnknownObjectError, UnresolvedSymbolError
from repro_torch.core.objects import RelocType
from repro_torch.core.relocation import RelocationTable
from repro_torch.core.resolver import DynamicResolver, dependency_closure
from repro_torch.core.symbol_index import closure_hash

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.manager import Manager


# --------------------------------------------------------------------------
# The journal proper
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class JournalEntry:
    """One staged operation, as recorded in ``journal.jsonl``."""

    seq: int
    op: str                     # "publish" | "publish-file" | "remove" | "edit"
    name: str
    content_hash: str = ""      # hash bound ("" for remove of unknown)
    payload_size: int = 0
    kind: int = -1              # ObjectKind int (-1 when unknown/remove)
    version: str = ""
    ts: float = 0.0

    def to_json(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_json(d: dict) -> "JournalEntry":
        return JournalEntry(
            seq=int(d["seq"]),
            op=str(d["op"]),
            name=str(d["name"]),
            content_hash=str(d.get("content_hash", "")),
            payload_size=int(d.get("payload_size", 0)),
            kind=int(d.get("kind", -1)),
            version=str(d.get("version", "")),
            ts=float(d.get("ts", 0.0)),
        )


class Journal:
    """Append-only persisted record of one management session's staged ops.

    Satisfies the Manager's journal-sink protocol (``record`` / ``clear`` /
    ``last_seq``). Appends are flushed per entry so a crash loses at most
    the op that was in flight — and that op's staging is then also absent
    from the persisted ``pending`` snapshot, so journal and state cannot
    disagree by more than the crashing op.

    **Rotation** (``rotate_bytes``): a very long management session — a
    sweep republishing the same bundles thousands of times — grows the
    journal without bound even though its *net* staging is small. Once the
    file exceeds ``rotate_bytes`` after an append, it is compacted in
    place: only the LAST entry per name survives (exactly the entries
    ``replay`` would let win), original sequence numbers are kept (so
    ``last_seq`` and the state file's ``journal_seq`` stay consistent),
    and the file as it stood before the MOST RECENT rotation is parked at
    ``<path>.1`` (one generation — an earlier rotation's archive is
    overwritten). ``management(resume=True)`` replay over a rotated journal
    reproduces the same staged world as over the unrotated one. A session
    whose net staging is genuinely larger than the threshold cannot be
    shrunk and is left alone.
    """

    def __init__(
        self, path: str | os.PathLike, *, rotate_bytes: Optional[int] = None
    ):
        self.path = Path(path)
        self.rotate_bytes = rotate_bytes
        self.rotations = 0
        # After a no-op compaction (net staging genuinely >= threshold),
        # skip re-attempts until the file grows past this — otherwise every
        # append would re-parse the whole journal just to find nothing.
        self._rotate_retry_size = 0
        self._repair_torn_tail()
        self._seq = self._scan_last_seq()

    # ----------------------------------------------------------- protocol
    @property
    def last_seq(self) -> int:
        return self._seq

    def record(
        self,
        op: str,
        *,
        name: str,
        content_hash: str = "",
        payload_size: int = 0,
        kind: int = -1,
        version: str = "",
    ) -> JournalEntry:
        self._seq += 1
        entry = JournalEntry(
            seq=self._seq,
            op=op,
            name=name,
            content_hash=content_hash,
            payload_size=payload_size,
            kind=kind,
            version=version,
            ts=time.time(),
        )
        with self.path.open("a") as f:
            f.write(json.dumps(entry.to_json(), sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        if (
            self.rotate_bytes is not None
            and size > self.rotate_bytes
            and size > self._rotate_retry_size
        ):
            self._rotate(size)
        return entry

    def clear(self) -> None:
        """Truncate the journal (session boundary: begin/commit/abort/reset).
        The rotation archive describes the now-dead session and goes too."""
        self._seq = 0
        self._rotate_retry_size = 0
        if self.path.exists():
            self.path.write_text("")
        if self.archive_path.exists():
            self.archive_path.unlink()

    @property
    def archive_path(self) -> Path:
        """Where the most recent rotation parks the pre-compaction history."""
        return self.path.with_name(self.path.name + ".1")

    def _rotate(self, size: int) -> None:
        """Compact the journal to its replay-equivalent minimum.

        ``replay`` is last-wins per name, so only the final entry per name
        affects the staged world it reproduces. Their original ``seq``
        values are kept (they are already strictly increasing, and the
        newest entry is by construction a survivor), which keeps
        ``last_seq`` — and therefore the resume-authority check against
        ``state.json``'s ``journal_seq`` — exactly as before rotation.

        Crash safety: the old file is parked at ``archive_path`` first and
        the compacted file lands by atomic replace. A crash in between
        leaves no active journal — resume then falls back to the persisted
        ``pending`` snapshot and resyncs the journal from it
        (``Workspace._resync_journal_from_staged``), losing nothing.
        """
        entries = self.entries()
        last: dict[str, JournalEntry] = {}
        for e in entries:
            last.pop(e.name, None)   # re-insert to keep last-occurrence order
            last[e.name] = e
        if len(last) >= len(entries):
            # nothing to reclaim: net staging really is this large. Back
            # off until the file doubles so appends stay O(1) amortized.
            self._rotate_retry_size = size * 2
            return
        os.replace(self.path, self.archive_path)
        tmp = self.path.with_name(self.path.name + ".tmp")
        with tmp.open("w") as f:
            for e in last.values():
                f.write(json.dumps(e.to_json(), sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self.rotations += 1
        self._rotate_retry_size = 0

    # ------------------------------------------------------------- reading
    def entries(self) -> list[JournalEntry]:
        if not self.path.exists():
            return []
        out = []
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                out.append(JournalEntry.from_json(json.loads(line)))
            except (json.JSONDecodeError, KeyError, ValueError):
                # A crash mid-append can tear the final line; everything
                # before it is intact (appends are flushed per entry), so
                # stop there instead of making the store unopenable.
                break
        return out

    def replay(self, bindings: dict[str, str]) -> dict[str, str]:
        """Apply the journaled ops over ``bindings`` (the committed world),
        reproducing the staged world the recording session had built."""
        staged = dict(bindings)
        for e in self.entries():
            if e.op in ("publish", "publish-file"):
                staged[e.name] = e.content_hash
            elif e.op == "remove":
                staged.pop(e.name, None)
        return staged

    def _scan_last_seq(self) -> int:
        es = self.entries()
        return es[-1].seq if es else 0

    def _repair_torn_tail(self) -> None:
        """Rewrite the file to its parseable prefix when a crash tore the
        final line. Without this, the next append would merge onto the
        fragment and make BOTH entries unreadable — silently truncating
        every later op at the corrupt line."""
        if not self.path.exists():
            return
        raw = self.path.read_text()
        lines = [ln for ln in raw.splitlines() if ln.strip()]
        es = self.entries()  # parses the clean prefix only
        if len(es) == len(lines) and (not raw or raw.endswith("\n")):
            return
        with self.path.open("w") as f:
            for e in es:
                f.write(json.dumps(e.to_json(), sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())


# --------------------------------------------------------------------------
# Structural diff: staged world vs committed world
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WorldDiff:
    """Binding-level delta of a staged world against the committed world."""

    added: dict[str, str]                    # name -> new hash
    removed: dict[str, str]                  # name -> old hash
    upgraded: dict[str, tuple[str, str]]     # name -> (old hash, new hash)
    committed_world_hash: str = ""
    staged_world_hash: str = ""

    @property
    def is_empty(self) -> bool:
        return not (self.added or self.removed or self.upgraded)

    def summary(self) -> dict:
        return {
            "added": sorted(self.added),
            "removed": sorted(self.removed),
            "upgraded": sorted(self.upgraded),
            "committed_world_hash": self.committed_world_hash,
            "staged_world_hash": self.staged_world_hash,
        }

    def to_json(self) -> str:
        return json.dumps(
            {
                "added": dict(sorted(self.added.items())),
                "removed": dict(sorted(self.removed.items())),
                "upgraded": {
                    k: list(v) for k, v in sorted(self.upgraded.items())
                },
                "committed_world_hash": self.committed_world_hash,
                "staged_world_hash": self.staged_world_hash,
            },
            indent=1,
        )


def world_diff(
    committed: dict[str, str],
    staged: dict[str, str],
    *,
    committed_world_hash: str = "",
    staged_world_hash: str = "",
) -> WorldDiff:
    added = {n: h for n, h in staged.items() if n not in committed}
    removed = {n: h for n, h in committed.items() if n not in staged}
    upgraded = {
        n: (committed[n], h)
        for n, h in staged.items()
        if n in committed and committed[n] != h
    }
    return WorldDiff(
        added=added,
        removed=removed,
        upgraded=upgraded,
        committed_world_hash=committed_world_hash,
        staged_world_hash=staged_world_hash,
    )


# --------------------------------------------------------------------------
# Relocation-delta preview: dry-run materialization against the staged world
# --------------------------------------------------------------------------


@dataclass
class RelocationDelta:
    """Per-application relocation changes a commit would produce."""

    app: str
    new_app: bool = False            # app itself is newly staged
    dep_missing: Optional[str] = None  # a `needed` object absent from staged world
    changed: list[dict] = field(default_factory=list)
    unresolved: list[dict] = field(default_factory=list)
    edited: list[dict] = field(default_factory=list)  # staged interposition edits
    table_rebuilt: bool = False      # commit will (re-)materialize the table
    relocations: int = 0             # rows under the staged world

    @property
    def is_clean(self) -> bool:
        return not (self.changed or self.unresolved or self.dep_missing)

    def summary(self) -> dict:
        return {
            "app": self.app,
            "new_app": self.new_app,
            "dep_missing": self.dep_missing,
            "changed": len(self.changed),
            "unresolved": len(self.unresolved),
            "edited": len(self.edited),
            "table_rebuilt": self.table_rebuilt,
            "relocations": self.relocations,
        }


@dataclass
class PreviewReport:
    """The relocation-delta preview of one staged (uncommitted) world."""

    diff: WorldDiff
    deltas: list[RelocationDelta]
    epoch: int                       # epoch the commit would create
    committed_world_hash: str
    staged_world_hash: str

    @property
    def tables_to_rebuild(self) -> list[str]:
        """Apps whose dependency closure changed: commit re-materializes
        exactly these."""
        return [d.app for d in self.deltas if d.table_rebuilt]

    @property
    def tables_reused(self) -> list[str]:
        """Apps untouched by this staging: their closure hash — and hence
        their materialized table and baked arena — survives the commit."""
        return [d.app for d in self.deltas if not d.table_rebuilt]

    @property
    def is_clean(self) -> bool:
        """True when commit-time materialization cannot fail on resolution:
        no unresolved refs and no missing dependencies anywhere — including
        in newly staged apps. Changed providers/addends are the *point* of
        a roll, not a defect, so they do not make a preview dirty."""
        return not any(d.unresolved or d.dep_missing for d in self.deltas)

    def delta_for(self, app: str) -> Optional[RelocationDelta]:
        for d in self.deltas:
            if d.app == app:
                return d
        return None

    def summary(self) -> dict:
        return {
            "epoch": self.epoch,
            "committed_world_hash": self.committed_world_hash,
            "staged_world_hash": self.staged_world_hash,
            "world_diff": self.diff.summary(),
            "apps": [d.summary() for d in self.deltas],
            "tables_to_rebuild": self.tables_to_rebuild,
            "tables_reused": self.tables_reused,
        }

    # ------------------------------------------------------------- views
    def records(self) -> list[dict]:
        """Flat per-symbol rows (JSON/CSV-ready) across all applications."""
        out = []
        for d in self.deltas:
            for c in d.changed:
                out.append({"app": d.app, "kind": "changed", **c})
            for u in d.unresolved:
                out.append({"app": d.app, "kind": "unresolved", **u})
            for e in d.edited:
                out.append({"app": d.app, "kind": "edited", **e})
            if d.dep_missing:
                out.append(
                    {
                        "app": d.app,
                        "kind": "dep-missing",
                        "symbol": "",
                        "old_provider": d.dep_missing,
                        "new_provider": "",
                        "old_addend": 0,
                        "new_addend": 0,
                        "detail": f"needed object {d.dep_missing!r} unbound",
                    }
                )
        return out

    def to_json(self) -> str:
        return json.dumps(
            {"summary": self.summary(), "records": self.records()}, indent=1
        )

    def to_csv(self) -> str:
        fields = [
            "app", "kind", "symbol", "old_provider", "new_provider",
            "old_addend", "new_addend", "detail",
        ]
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=fields, extrasaction="ignore")
        w.writeheader()
        w.writerows(self.records())
        return buf.getvalue()


def _provider_key(name: str, version: str) -> str:
    return f"{name}@{version}" if version else name


def _mapping_from_table(table: RelocationTable) -> dict[str, dict]:
    """symbol -> binding record, from a materialized table."""
    out: dict[str, dict] = {}
    rows = table.rows
    for i in range(len(rows)):
        r = rows[i]
        sym = table.name_at(r["symbol_name"])
        prov = table.object_by_uuid(int(r["provides_so_uuid"]))
        out[sym] = {
            "provider": _provider_key(prov["name"], prov["version"])
            if prov is not None
            else "",
            "provider_hash": prov["content_hash"] if prov is not None else "",
            "addend": int(r["addend"]),
            "st_value": int(r["st_value"]),
            "type": int(r["type"]),
        }
    return out


def tolerant_resolve(app, world):
    """Dry-run resolution that never raises: a preview must report problems,
    not die on the first one.

    Returns ``(relocations, unresolved, dep_missing)`` — the bindable
    relocations, record dicts for strong refs without a provider, and the
    name of a missing ``needed`` object (whole-closure failure) if any.
    """
    try:
        scope = dependency_closure(app, world)
    except UnknownObjectError as e:
        return [], [], str(e)
    resolver = DynamicResolver(world, on_mismatch="skip")
    relocations = []
    unresolved: list[dict] = []
    for obj in scope:
        for ref in obj.refs:
            try:
                relocations.append(resolver.resolve_ref(ref, obj, scope))
            except UnresolvedSymbolError:
                unresolved.append(
                    {
                        "symbol": ref.name,
                        "old_provider": "",
                        "new_provider": "",
                        "old_addend": 0,
                        "new_addend": 0,
                        "detail": f"strong ref of {obj.name} has no provider",
                    }
                )
    return relocations, unresolved, None


def _binding_records(relocations) -> dict[str, dict]:
    """symbol -> binding record, from resolved relocations."""
    mapping: dict[str, dict] = {}
    for r in relocations:
        mapping[r.ref.name] = {
            "provider": _provider_key(r.provider.name, r.provider.version)
            if r.provider is not None
            else "",
            "provider_hash": r.provider.content_hash
            if r.provider is not None
            else "",
            "addend": int(r.addend),
            "st_value": int(r.st_value),
            "type": int(r.rtype),
        }
    return mapping


def _mapping_from_world(app, world) -> tuple[dict[str, dict], list[dict], Optional[str]]:
    """Tolerant dry-run resolution as a symbol -> binding-record mapping."""
    relocations, unresolved, dep_missing = tolerant_resolve(app, world)
    return _binding_records(relocations), unresolved, dep_missing


def app_relocation_delta(manager: "Manager", app) -> tuple[RelocationDelta, list]:
    """One application's relocation delta (staged vs committed), plus the
    staged-world relocations the dry run produced (reusable for a preview
    table, sparing callers a second resolution pass)."""
    registry = manager.registry
    committed = manager.committed_world()
    staged = manager.world()
    delta = RelocationDelta(app=app.name)
    # Tables are keyed by (app hash, closure hash): commit re-materializes
    # exactly the apps whose dependency closure changed. A broken staged
    # closure (missing dep) has no reusable table by definition.
    try:
        staged_key = closure_hash(app, staged)
        delta.table_rebuilt = not registry.table_path(
            app.content_hash, staged_key
        ).exists()
    except UnknownObjectError:
        delta.table_rebuilt = True
    # old mapping: what the committed epoch binds (table if materialized).
    # An *upgraded* app (same name, new content hash) is not new — its old
    # mapping comes from the committed version of the app object, so the
    # preview shows exactly what the app roll changes.
    committed_app = committed.get(app.name) if app.name in committed else None
    if committed_app is not None:
        try:
            committed_key = closure_hash(committed_app, committed)
        except UnknownObjectError:
            committed_key = committed.world_hash
        table_path = registry.table_path(
            committed_app.content_hash, committed_key
        )
        if not table_path.exists():
            # pre-closure-hash stores keyed tables by the world hash
            table_path = registry.table_path(
                committed_app.content_hash, committed.world_hash
            )
        if table_path.exists():
            old = _mapping_from_table(RelocationTable.load(table_path))
            old_unres: list[dict] = []
        else:
            old, old_unres, _ = _mapping_from_world(committed_app, committed)
    else:
        delta.new_app = True
        old, old_unres = {}, []
    relocations, new_unres, dep_missing = tolerant_resolve(app, staged)
    new = _binding_records(relocations)
    delta.dep_missing = dep_missing
    delta.relocations = len(new)
    old_unres_syms = {u["symbol"] for u in old_unres}
    # newly-unresolved only: refs broken by this staging, not pre-existing
    delta.unresolved = [
        u for u in new_unres if u["symbol"] not in old_unres_syms
    ]
    if not delta.new_app:
        for sym, nb in new.items():
            ob = old.get(sym)
            if ob is None:
                continue  # previously unresolved; not a provider change
            if (
                ob["provider_hash"] != nb["provider_hash"]
                or ob["addend"] != nb["addend"]
                or ob["st_value"] != nb["st_value"]
                or ob["type"] != nb["type"]
            ):
                delta.changed.append(
                    {
                        "symbol": sym,
                        "old_provider": ob["provider"],
                        "new_provider": nb["provider"],
                        "old_addend": ob["addend"],
                        "new_addend": nb["addend"],
                        "detail": (
                            "type "
                            f"{RelocType(ob['type']).name}->"
                            f"{RelocType(nb['type']).name}"
                            if ob["type"] != nb["type"]
                            else ""
                        ),
                    }
                )
        for sym, ob in old.items():
            if sym not in new and not any(
                u["symbol"] == sym for u in delta.unresolved
            ):
                # ref disappeared with a dep (e.g. provider removed and
                # the requiring object gone): surface as unresolved-ish
                delta.unresolved.append(
                    {
                        "symbol": sym,
                        "old_provider": ob["provider"],
                        "new_provider": "",
                        "old_addend": ob["addend"],
                        "new_addend": 0,
                        "detail": "binding vanished from staged world",
                    }
                )
    # Staged interposition edits (tx.rebind / Manager.stage_edit): preview
    # the rows the commit-time `interpose.rebind` will retarget, matched by
    # the same glob semantics it uses — so the operator sees the edit's
    # blast radius before any table is touched. These rows will carry
    # FLAG_EDITED in the recompiled table.
    staged_edits = [
        e for e in getattr(manager, "staged_edits", []) if e["app"] == app.name
    ]
    if staged_edits:
        from repro_torch.core.interpose import _match_glob

        for e in staged_edits:
            prov = staged.get(e["provider"])
            prov_key = (
                _provider_key(prov.name, prov.version) if prov else e["provider"]
            )
            seen: set[tuple[str, str]] = set()
            for r in relocations:
                sym = r.ref.name
                if not _match_glob(sym, e["symbol_glob"]):
                    continue
                rg = e.get("requires_glob")
                if rg and not _match_glob(r.requirer.name, rg):
                    continue
                if (sym, r.requirer.name) in seen:
                    continue
                seen.add((sym, r.requirer.name))
                delta.edited.append(
                    {
                        "symbol": sym,
                        "old_provider": _provider_key(
                            r.provider.name, r.provider.version
                        )
                        if r.provider is not None
                        else "",
                        "new_provider": prov_key,
                        "old_addend": int(r.addend),
                        "new_addend": int(r.addend),
                        "detail": (
                            f"staged edit {e['symbol_glob']!r}"
                            + (f" requires={rg!r}" if rg else "")
                            + f" in {r.requirer.name}"
                        ),
                    }
                )
    return delta, relocations


def preview_world(manager: "Manager") -> PreviewReport:
    """Dry-run the staged world and report the per-app relocation delta.

    Reads the committed table when one exists (the mapping the running epoch
    actually uses); resolves dynamically otherwise. Never writes: tables are
    only (re-)materialized by the real commit.
    """
    committed = manager.committed_world()
    staged = manager.world()
    diff = world_diff(
        manager.committed_bindings,
        manager.staged_bindings,
        committed_world_hash=committed.world_hash,
        staged_world_hash=staged.world_hash,
    )
    deltas = [
        app_relocation_delta(manager, app)[0]
        for app in staged.applications()
    ]
    return PreviewReport(
        diff=diff,
        deltas=deltas,
        epoch=manager.epoch + 1,
        committed_world_hash=committed.world_hash,
        staged_world_hash=staged.world_hash,
    )

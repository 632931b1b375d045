"""Content-addressed object registry — the Nix-store analogue (§4.1).

Layout on disk::

    <root>/
      objects/<hash16>-<name>-<version>/
        manifest.json
        payload.bin            (optional; tensors at PAGE_BYTES alignment)
      tables/<app_hash>-<closure_hash>.npz        (materialized tables)
      tables/<app_hash>-<closure_hash>.arena      (baked arena images)
      tables/<app_hash>-<closure_hash>.arena.json (baked arena sidecars)
      executables/<key>.jaxexe               (AOT compile cache, optional)
      shm/<segment>.json       (records of published shared-memory arena
                                segments; see core/shm_arena.py lifecycle)
      state.json               (mode, epoch counter, world view)
      journal.jsonl            (staged ops of the open management session)

The *world view* is the set of (object name -> content hash) bindings that is
current for the running epoch — the analogue of /nix/var/nix/profiles. The
``world_hash`` identifies it. Relocation tables and baked arenas are keyed by
(application content hash, *closure hash*) — the digest of the app's
dependency-closure content hashes (core/symbol_index.py) — so a table can
never be used against a world whose closure differs from the one it was
materialized for (StaleTableError otherwise), while worlds that changed only
outside the app's closure keep the key and reuse the table.

The registry itself is mode-agnostic; mutation gating lives in Manager.

State schema versioning: ``state.json`` carries a ``schema`` integer.
v1 (unversioned) predates the management journal; v2 added ``schema`` and
``journal_seq``; v3 adds the generation-addressed-world fields: a monotone
``epoch_gen`` (the commit generation — unlike ``epoch`` it is never reused
across store resets) plus ``previous`` / ``previous_epoch_gen``, which keep
the previous committed world's bindings alongside the new generation so a
live fleet can drain on N while N+1 serves (blue/green rollover — the old
generation's tables, arenas, and shm segments stay reclaim-protected until
``Workspace.gc(drain=True)``). v4 generalizes the two-generation window
into an explicit **retained generation chain**: ``retained`` is a list of
``{"epoch_gen": g, "world": {...}}`` entries (oldest first) so a commit
landing mid-drain keeps BOTH still-draining generations reclaim-protected
instead of implicitly forgetting the older one, and adds
``rolled_back_from`` — nonzero after ``Workspace.rollback_epoch`` aborted
a bad flip, naming the generation that was rolled back (cleared by the
next normal commit). ``previous`` / ``previous_epoch_gen`` are still
written (mirroring the newest retained entry) for older readers.
``read_state`` migrates older schemas in place, so stores written by older
builds keep working. A state written by a *newer* schema than this build
understands raises ``StateSchemaError`` instead of being silently misread.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Optional

from .errors import PayloadIntegrityError, StateSchemaError, UnknownObjectError
from .objects import StoreObject, payload_digest

# Current state.json schema. v1 = unversioned (pre-journal); v2 adds the
# `schema` stamp and `journal_seq` (last journal entry the state has seen);
# v3 adds `epoch_gen` plus the retained previous generation (`previous`,
# `previous_epoch_gen`) for blue/green epoch rollover; v4 generalizes that
# into the `retained` generation chain and adds the `rolled_back_from`
# abort marker.
STATE_SCHEMA = 4


class Registry:
    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        (self.root / "objects").mkdir(parents=True, exist_ok=True)
        (self.root / "tables").mkdir(parents=True, exist_ok=True)
        (self.root / "executables").mkdir(parents=True, exist_ok=True)
        self._manifest_cache: dict[str, StoreObject] = {}

    # ------------------------------------------------------------------ paths
    def object_dir(self, obj: StoreObject | str) -> Path:
        if isinstance(obj, StoreObject):
            return self.root / "objects" / obj.store_name
        # by content hash
        for p in (self.root / "objects").iterdir():
            if p.name.startswith(obj[:16]):
                return p
        raise UnknownObjectError(f"no object with content hash {obj!r}")

    def payload_path(self, obj: StoreObject) -> Path:
        return self.object_dir(obj) / "payload.bin"

    def table_path(self, app_hash: str, key: str) -> Path:
        """Materialized-table path. ``key`` is the app's closure hash
        (pre-incremental stores used the world hash; Executor._load_stable
        still probes that legacy key as a fallback)."""
        return self.root / "tables" / f"{app_hash[:16]}-{key[:16]}.npz"

    def arena_path(self, app_hash: str, key: str) -> Path:
        """Baked (pre-relocated) arena image for one (app, closure)."""
        return self.root / "tables" / f"{app_hash[:16]}-{key[:16]}.arena"

    def arena_meta_path(self, app_hash: str, key: str) -> Path:
        """Sidecar (slots/kernels/staleness guards) of a baked arena."""
        return self.root / "tables" / f"{app_hash[:16]}-{key[:16]}.arena.json"

    def executable_path(self, key: str) -> Path:
        return self.root / "executables" / f"{key[:32]}.jaxexe"

    # ---------------------------------------------------------------- objects
    def add(self, obj: StoreObject, payload: bytes = b"") -> StoreObject:
        """Insert an object into the store. Idempotent (content-addressed)."""
        d = self.root / "objects" / obj.store_name
        if d.exists():
            return obj  # identical content already present
        tmp = Path(tempfile.mkdtemp(dir=self.root / "objects"))
        try:
            (tmp / "manifest.json").write_text(
                json.dumps(obj.manifest_json(), indent=1, sort_keys=True)
            )
            if payload:
                if payload_digest(payload) != obj.payload_digest:
                    raise PayloadIntegrityError(
                        f"payload digest mismatch for {obj.name}"
                    )
                (tmp / "payload.bin").write_bytes(payload)
            tmp.rename(d)
        finally:
            if tmp.exists():
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        self._manifest_cache[obj.content_hash] = obj
        return obj

    def add_with_payload_file(self, obj: StoreObject, payload_file: Path) -> StoreObject:
        """Like add(), but moves a pre-written payload file (large bundles)."""
        d = self.root / "objects" / obj.store_name
        if d.exists():
            return obj
        tmp = Path(tempfile.mkdtemp(dir=self.root / "objects"))
        try:
            (tmp / "manifest.json").write_text(
                json.dumps(obj.manifest_json(), indent=1, sort_keys=True)
            )
            os.replace(payload_file, tmp / "payload.bin")
            tmp.rename(d)
        finally:
            if tmp.exists():
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        self._manifest_cache[obj.content_hash] = obj
        return obj

    def get(self, chash: str) -> StoreObject:
        if chash in self._manifest_cache:
            return self._manifest_cache[chash]
        d = self.object_dir(chash)
        obj = StoreObject.from_manifest(json.loads((d / "manifest.json").read_text()))
        self._manifest_cache[obj.content_hash] = obj
        return obj

    def iter_objects(self) -> Iterator[StoreObject]:
        for p in sorted((self.root / "objects").iterdir()):
            m = p / "manifest.json"
            if m.exists():
                yield StoreObject.from_manifest(json.loads(m.read_text()))

    # ------------------------------------------------------------------ state
    @property
    def state_path(self) -> Path:
        return self.root / "state.json"

    def read_state(self) -> dict:
        if self.state_path.exists():
            return migrate_state(json.loads(self.state_path.read_text()))
        return {
            "schema": STATE_SCHEMA,
            "mode": "management",
            "epoch": 0,
            "epoch_gen": 0,
            "world": {},
            "pending": {},
            "previous": {},
            "previous_epoch_gen": 0,
            "retained": [],
            "rolled_back_from": 0,
            "journal_seq": 0,
        }

    def write_state(self, state: dict) -> None:
        state = dict(state)
        state.setdefault("schema", STATE_SCHEMA)
        tmp = self.state_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state, indent=1, sort_keys=True))
        os.replace(tmp, self.state_path)

    @property
    def journal_path(self) -> Path:
        return self.root / "journal.jsonl"

    @property
    def shm_dir(self) -> Path:
        """Records of shared-memory arena segments this root published
        (created lazily by ``core.shm_arena`` on first publish)."""
        return self.root / "shm"

    # --------------------------------------------------------------- garbage
    def gc_stores(
        self, live_keys: Iterable[tuple[str, str]], *, dry_run: bool = False
    ) -> "GcReport":
        """Delete ``tables/`` entries (materialized tables, baked arenas,
        sidecars) whose (app hash, key) is not in ``live_keys``.

        Stores grow monotonically: every closure change leaves the old
        key's ``.npz``/``.arena``/``.arena.json`` behind. Callers compute
        the live set from every world they still honour (committed, plus
        staged during management) — see ``Workspace.gc``, which is the
        only caller; nothing ever runs this implicitly during an epoch.
        Unknown file shapes in ``tables/`` are left untouched.
        ``dry_run=True`` reports the same candidates without unlinking
        anything (the operator preflight before closing a rollback window).
        """
        live = {f"{app_hash[:16]}-{key[:16]}" for app_hash, key in live_keys}
        report = GcReport(dry_run=dry_run)
        tables = self.root / "tables"
        for p in sorted(tables.iterdir()) if tables.exists() else []:
            if not p.is_file():
                continue
            prefix = p.name.split(".", 1)[0]
            # every store file is "<app16>-<key16>.<ext>"
            if "-" not in prefix:
                continue
            if prefix in live:
                report.kept_files += 1
                continue
            size = p.stat().st_size
            if not dry_run:
                p.unlink()
            report.removed.append(p.name)
            report.bytes_reclaimed += size
        return report


@dataclass
class GcReport:
    """What one ``gc_stores`` pass reclaimed.

    ``Workspace.gc`` also folds shared-memory segment reclamation into the
    same report: unlinked segment names land in ``removed`` (and their
    sizes in ``bytes_reclaimed``), with ``segments_removed`` counting them
    separately from table-store files. ``dry_run=True`` marks a preflight
    pass: the same names/bytes are reported but nothing was unlinked, and
    ``retired_entries``/``retired_bytes`` name what a ``drain`` would
    additionally reclaim from the epoch caches."""

    removed: list[str] = field(default_factory=list)
    kept_files: int = 0
    bytes_reclaimed: int = 0
    segments_removed: int = 0
    dry_run: bool = False
    retired_entries: int = 0     # epoch-cache entries a drain would reclaim
    retired_bytes: int = 0
    store_files_removed: int = 0  # store-tier quarantine/partial files
                                  # reclaimed (names land in `removed` as
                                  # "store/<sub>/<file>")

    @property
    def removed_files(self) -> int:
        return len(self.removed) - self.segments_removed - self.store_files_removed

    def summary(self) -> dict:
        return {
            "dry_run": self.dry_run,
            "removed_files": self.removed_files,
            "segments_removed": self.segments_removed,
            "store_files_removed": self.store_files_removed,
            "kept_files": self.kept_files,
            "bytes_reclaimed": self.bytes_reclaimed,
            "retired_entries": self.retired_entries,
            "retired_bytes": self.retired_bytes,
            "removed": sorted(self.removed),
        }


def migrate_state(state: dict) -> dict:
    """Upgrade a loaded state dict to the current schema (in memory only;
    the next write persists the upgraded form)."""
    schema = int(state.get("schema", 1))
    if schema > STATE_SCHEMA:
        raise StateSchemaError(
            f"state.json schema {schema} is newer than this build's "
            f"{STATE_SCHEMA}; refusing to guess at its meaning"
        )
    if schema < 2:
        state = dict(state)
        state["schema"] = 2
        state.setdefault("journal_seq", 0)
        state.setdefault("pending", dict(state.get("world", {})))
    if schema < 3:
        # v2 stores have exactly one live generation: seed the generation
        # counter from the epoch (both count commits) with no retained
        # previous world — the first v3 commit starts the two-gen window.
        state = dict(state)
        state["schema"] = 3
        state.setdefault("epoch_gen", int(state.get("epoch", 0)))
        state.setdefault("previous", {})
        state.setdefault("previous_epoch_gen", 0)
    if schema < 4:
        # v3's single previous generation becomes a one-entry chain; an
        # empty previous world means the window was already closed.
        state = dict(state)
        state["schema"] = 4
        if "retained" not in state:
            prev = dict(state.get("previous", {}))
            state["retained"] = (
                [
                    {
                        "epoch_gen": int(state.get("previous_epoch_gen", 0)),
                        "world": prev,
                    }
                ]
                if prev
                else []
            )
        state.setdefault("rolled_back_from", 0)
    return state


class World:
    """An immutable name -> StoreObject view (one epoch's bindings)."""

    def __init__(self, registry: Registry, bindings: dict[str, str]):
        self._registry = registry
        self._bindings = dict(bindings)  # name -> content hash
        self._world_hash: Optional[str] = None  # bindings are frozen: memo

    def __contains__(self, name: str) -> bool:
        return name in self._bindings

    def __iter__(self):
        return iter(sorted(self._bindings))

    def __len__(self) -> int:
        return len(self._bindings)

    def resolve(self, name: str) -> StoreObject:
        try:
            return self._registry.get(self._bindings[name])
        except KeyError:
            raise UnknownObjectError(f"object {name!r} not in world view") from None

    def get(self, name: str) -> Optional[StoreObject]:
        h = self._bindings.get(name)
        return self._registry.get(h) if h else None

    @property
    def bindings(self) -> dict[str, str]:
        return dict(self._bindings)

    @property
    def world_hash(self) -> str:
        if self._world_hash is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(
                json.dumps(
                    self._bindings, sort_keys=True, separators=(",", ":")
                ).encode()
            )
            self._world_hash = h.hexdigest()
        return self._world_hash

    def applications(self) -> list[StoreObject]:
        from .objects import ObjectKind

        return [
            o for n in self for o in [self.resolve(n)] if o.kind == ObjectKind.APPLICATION
        ]

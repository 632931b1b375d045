"""The Inspector (§4.3): observable relocation mappings.

Exposes materialized relocation tables in the paper's three formats — JSON,
CSV, and a queryable SQLite database — plus the ``ABI(library)`` table
generator and the vignette queries of §5.3:

* Vignette 1 — ABI compatibility: relocations bound against an old bundle
  whose symbols vanish (or change shape — our symbol tables are typed, so
  the check is *semantic*, stronger than ELF name presence) in a new bundle.
* Vignette 2 — CVE audit: which applications bind symbol S from bundle B.
* Vignette 3 — fine-grained interposition lives in interpose.py.

SQL schema:
    relocations(app, epoch, symbol_name, type, addend, offset, st_value,
                st_size, requires_so, provides_so, requires_uuid,
                provides_uuid, flags)
    abi(object_name, version, symbol_name, shape, dtype, nbytes, offset)
    pending_changes(app, kind, symbol, old_provider, new_provider,
                    old_addend, new_addend, detail)
        — the management-time preview view (``preview_to_sqlite``): one row
          per relocation a staged-but-uncommitted world would change, so the
          vignette queries can be run against a roll *before* it lands.
"""

from __future__ import annotations

import csv
import io
import json
import sqlite3
from typing import Iterable, Optional

from .objects import RelocType, StoreObject
from .relocation import RelocationTable

_TYPE_NAMES = {int(t): t.name for t in RelocType}


def table_records(table: RelocationTable) -> list[dict]:
    """Reconstitute full-string rows (the paper's struct, Figure 6)."""
    out = []
    rows = table.rows
    for i in range(len(rows)):
        r = rows[i]
        out.append(
            {
                "app": table.meta["app"],
                "epoch": table.meta["epoch"],
                "type": _TYPE_NAMES[int(r["type"])],
                "flags": int(r["flags"]),
                "addend": int(r["addend"]),
                "offset": int(r["offset"]),
                "st_value": int(r["st_value"]),
                "st_size": int(r["st_size"]),
                "requires_so_uuid": int(r["requires_so_uuid"]),
                "provides_so_uuid": int(r["provides_so_uuid"]),
                "symbol_name": table.name_at(r["symbol_name"]),
                "requires_so_name": table.name_at(r["requires_so_name"]),
                "provides_so_name": table.name_at(r["provides_so_name"]),
            }
        )
    return out


def to_json(table: RelocationTable) -> str:
    return json.dumps(
        {"meta": {k: v for k, v in table.meta.items() if k != "slots"},
         "objects": table.objects,
         "relocations": table_records(table)},
        indent=1,
    )


def to_csv(table: RelocationTable) -> str:
    records = table_records(table)
    buf = io.StringIO()
    if records:
        w = csv.DictWriter(buf, fieldnames=list(records[0].keys()))
        w.writeheader()
        w.writerows(records)
    return buf.getvalue()


def abi_records(obj: StoreObject) -> list[dict]:
    """ABI(library): the symbols a bundle exports (§4.3)."""
    return [
        {
            "object_name": obj.name,
            "version": obj.version,
            "symbol_name": s.name,
            "shape": json.dumps(list(s.shape)),
            "dtype": s.dtype,
            "nbytes": s.nbytes,
            "offset": s.offset,
        }
        for s in obj.symbols.values()
    ]


def to_sqlite(
    tables: Iterable[RelocationTable],
    *,
    abi_objects: Iterable[StoreObject] = (),
    path: str = ":memory:",
) -> sqlite3.Connection:
    conn = sqlite3.connect(path)
    conn.execute(
        """CREATE TABLE IF NOT EXISTS relocations (
             app TEXT, epoch INT, type TEXT, flags INT, addend INT,
             offset INT, st_value INT, st_size INT,
             requires_so_uuid INT, provides_so_uuid INT,
             symbol_name TEXT, requires_so_name TEXT, provides_so_name TEXT)"""
    )
    conn.execute(
        """CREATE TABLE IF NOT EXISTS abi (
             object_name TEXT, version TEXT, symbol_name TEXT,
             shape TEXT, dtype TEXT, nbytes INT, offset INT)"""
    )
    for t in tables:
        recs = table_records(t)
        if recs:
            conn.executemany(
                """INSERT INTO relocations VALUES
                   (:app,:epoch,:type,:flags,:addend,:offset,:st_value,
                    :st_size,:requires_so_uuid,:provides_so_uuid,
                    :symbol_name,:requires_so_name,:provides_so_name)""",
                recs,
            )
    for o in abi_objects:
        conn.executemany(
            """INSERT INTO abi VALUES
               (:object_name,:version,:symbol_name,:shape,:dtype,:nbytes,
                :offset)""",
            abi_records(o),
        )
    conn.commit()
    return conn


def preview_records(preview) -> list[dict]:
    """Flat rows of a management-time preview (``tx.preview()``): one row per
    changed / unresolved relocation and per missing dependency. ``preview``
    is any object with the ``repro_torch.link.journal.PreviewReport`` protocol."""
    return list(preview.records())


def preview_to_sqlite(
    preview,
    *,
    conn: Optional[sqlite3.Connection] = None,
    path: str = ":memory:",
) -> sqlite3.Connection:
    """Load a pre-commit preview into a queryable ``pending_changes`` table
    (optionally into an existing connection beside ``relocations``/``abi``).

    The table always holds exactly the *latest* preview: previous rows are
    dropped first, so iterating on a roll (preview, restage, preview again
    on the same connection) never mixes stale pending rows with fresh ones.
    """
    if conn is None:
        conn = sqlite3.connect(path)
    conn.execute(
        """CREATE TABLE IF NOT EXISTS pending_changes (
             app TEXT, kind TEXT, symbol TEXT, old_provider TEXT,
             new_provider TEXT, old_addend INT, new_addend INT, detail TEXT)"""
    )
    conn.execute("DELETE FROM pending_changes")
    recs = preview_records(preview)
    if recs:
        conn.executemany(
            """INSERT INTO pending_changes VALUES
               (:app,:kind,:symbol,:old_provider,:new_provider,
                :old_addend,:new_addend,:detail)""",
            [{"detail": "", **r} for r in recs],
        )
    conn.commit()
    return conn


# --------------------------------------------------------------------------
# Vignette queries (§5.3) — provided both as SQL text and python helpers.
# --------------------------------------------------------------------------

ABI_COMPAT_SQL = """
SELECT RT.symbol_name, RT.requires_so_name
FROM relocations AS RT
LEFT JOIN abi AS ABI
  ON RT.symbol_name = ABI.symbol_name AND ABI.object_name = :new_bundle
WHERE RT.app = :app
  AND RT.provides_so_name = :old_bundle
  AND ABI.symbol_name IS NULL
"""

CVE_AUDIT_SQL = """
SELECT DISTINCT RT.app
FROM relocations AS RT
WHERE RT.symbol_name = :symbol
  AND RT.provides_so_name = :bundle
"""


def abi_incompatibilities(
    conn: sqlite3.Connection, *, app: str, old_bundle: str, new_bundle: str
) -> list[tuple[str, str]]:
    """Vignette 1 (Figure 8): symbols of `app` bound to `old_bundle` that the
    new bundle no longer exports."""
    cur = conn.execute(
        ABI_COMPAT_SQL,
        {"app": app, "old_bundle": old_bundle, "new_bundle": new_bundle},
    )
    return [tuple(r) for r in cur.fetchall()]


def abi_shape_changes(
    conn: sqlite3.Connection, *, app: str, old: StoreObject, new: StoreObject
) -> list[dict]:
    """Semantic ABI check (beyond the paper): symbols present in both bundle
    versions whose shape or dtype changed — invisible to name-only tools."""
    out = []
    for name, s_old in old.symbols.items():
        s_new = new.symbols.get(name)
        if s_new and (s_new.shape != s_old.shape or s_new.dtype != s_old.dtype):
            bound = conn.execute(
                "SELECT COUNT(*) FROM relocations WHERE app=? AND symbol_name=?"
                " AND provides_so_name=?",
                (app, name, old.name),
            ).fetchone()[0]
            if bound:
                out.append(
                    {
                        "symbol": name,
                        "old": (tuple(s_old.shape), s_old.dtype),
                        "new": (tuple(s_new.shape), s_new.dtype),
                    }
                )
    return out


def cve_audit(
    conn: sqlite3.Connection, *, bundle: str, symbol: str
) -> list[str]:
    """Vignette 2 (Figure 9): applications binding `symbol` from `bundle`."""
    cur = conn.execute(CVE_AUDIT_SQL, {"symbol": symbol, "bundle": bundle})
    return [r[0] for r in cur.fetchall()]

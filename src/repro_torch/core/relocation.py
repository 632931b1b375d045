"""Materialized relocation tables (§4.2, Figure 6).

The paper's ``RelocationTableItem`` struct is reproduced as a numpy
structured dtype — one dense row per relocation — with two deliberate
deviations, both noted in DESIGN.md §7:

* The paper inlines ``char[PATH_MAX]`` name fields (12 KiB/row!). We keep the
  table dense by storing u32 offsets into an ELF-style string table
  (``strtab``); the Inspector reconstitutes full strings. Density is what
  makes epoch loading "sequential and well suited for memory prefetching".
* UUIDs are content-hash-derived u64s (stable across machines) instead of
  per-materialization counters.

A table is keyed by (application content hash, closure hash), where the
closure hash (core/symbol_index.py) digests the content hashes of the app's
dependency closure in search order — the complete input of a resolution.  A
table can never be applied under a world whose closure differs from the one
it was materialized for; worlds that differ only *outside* the app's closure
share the key, which is what makes re-materialization incremental (an
unrelated publish leaves the table — and its baked arena — reusable).  The
world hash the table was materialized under is kept in ``meta`` for
observability; pre-closure-hash tables (no ``closure_hash`` in meta) fall
back to world-hash freshness, preserving old stores.

``PageTable`` is the device-native compilation of a relocation table:
because bundle payloads and the destination arena are PAGE_BYTES-aligned,
almost every relocation is a whole-page run; the page table is a flat
(dst_page -> src_page) gather map, executed on the host by the executor's
paged loader and on the card by the ``paged_reloc_copy`` CUDA kernel
(``core/device_arena.py``). Rows that are not page-clean (unaligned SLICEs,
CASTs, INITs) stay on the host path.
"""

from __future__ import annotations

import io
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from .errors import StaleTableError
from .objects import PAGE_BYTES, RelocType, StoreObject, align_up
from .resolver import Relocation, np_dtype

RELOC_DTYPE = np.dtype(
    [
        # --- how to process the relocation (from the requiring object) ---
        ("type", np.uint32),
        ("flags", np.uint32),
        ("addend", np.uint64),
        ("offset", np.uint64),            # destination offset in the arena
        # --- where the symbol is located (from the providing object) ---
        ("st_value", np.uint64),
        ("st_size", np.uint64),
        # --- object identities ---
        ("requires_so_uuid", np.uint64),
        ("provides_so_uuid", np.uint64),
        # --- inspector information (strtab offsets, not PATH_MAX arrays) ---
        ("symbol_name", np.uint32),
        ("requires_so_name", np.uint32),
        ("provides_so_name", np.uint32),
    ]
)

FLAG_EDITED = np.uint32(1)  # row was rebound by the Inspector/interposition


class _StrTab:
    """ELF-style string table: offset 0 is the empty string."""

    def __init__(self):
        self._buf = io.BytesIO()
        self._buf.write(b"\x00")
        self._index: dict[str, int] = {"": 0}

    def add(self, s: str) -> int:
        off = self._index.get(s)
        if off is None:
            off = self._buf.tell()
            self._buf.write(s.encode() + b"\x00")
            self._index[s] = off
        return off

    def bytes(self) -> bytes:
        return self._buf.getvalue()


def strtab_get(strtab: bytes, off: int) -> str:
    end = strtab.index(b"\x00", off)
    return strtab[off:end].decode()


@dataclass
class ArenaSlot:
    """Destination layout for one application symbol."""

    name: str
    shape: tuple[int, ...]
    dtype: str
    offset: int
    nbytes: int


def build_arena_layout(refs) -> tuple[dict[str, ArenaSlot], int]:
    """Deterministic, page-aligned destination layout for an app's refs.

    Order follows the application's manifest order (canonical pytree paths),
    so the arena is reproducible across machines and epochs.
    """
    slots: dict[str, ArenaSlot] = {}
    cursor = 0
    for ref in refs:
        if ref.dtype == "kernel":
            continue  # kernel symbols bind to entry points, not arena bytes
        dt = np_dtype(ref.dtype)
        nbytes = int(np.prod(ref.shape)) * dt.itemsize if ref.shape else dt.itemsize
        slots[ref.name] = ArenaSlot(
            name=ref.name,
            shape=tuple(ref.shape),
            dtype=ref.dtype,
            offset=cursor,
            nbytes=nbytes,
        )
        cursor += align_up(nbytes, PAGE_BYTES)
    return slots, cursor


@dataclass
class RelocationTable:
    rows: np.ndarray                      # structured, RELOC_DTYPE
    strtab: bytes
    objects: list[dict]                   # per-object sidecar (uuid order)
    meta: dict                            # app/world/epoch + arena layout
    _uuid_to_obj: dict = field(default_factory=dict, repr=False)
    # materialization-time page-table compilation (src/dst page indices):
    # the epoch loader's vectorized fast path + the CUDA kernel's input
    _pt_src: Optional[np.ndarray] = field(default=None, repr=False)
    _pt_dst: Optional[np.ndarray] = field(default=None, repr=False)

    # ------------------------------------------------------------ properties
    def __len__(self) -> int:
        return len(self.rows)

    @property
    def arena_size(self) -> int:
        return int(self.meta["arena_size"])

    @property
    def world_hash(self) -> str:
        return self.meta["world_hash"]

    def slots(self) -> dict[str, ArenaSlot]:
        return {
            name: ArenaSlot(name=name, **{k: tuple(v) if k == "shape" else v
                                           for k, v in d.items()})
            for name, d in self.meta["slots"].items()
        }

    def object_by_uuid(self, uuid: int) -> Optional[dict]:
        if not self._uuid_to_obj:
            self._uuid_to_obj = {int(o["uuid"]): o for o in self.objects}
        return self._uuid_to_obj.get(int(uuid))

    def name_at(self, off: int) -> str:
        return strtab_get(self.strtab, int(off))

    # -------------------------------------------------------------- (de)ser.
    #
    # Two formats:
    #   * format="npz"  — np.savez container (zip + per-entry CRC): the
    #     original implementation, kept as the §Perf baseline.
    #   * format="raw"  — MATR1: fixed header of section lengths, then raw
    #     rows / strtab / objects / meta / page-table bytes. Loading is
    #     one read + np.frombuffer views: zero parsing on the epoch path.
    _MAGIC = b"MATR1\x00"

    def save(self, path: str | Path, *, format: str = "raw") -> None:
        path = Path(path)
        tmp = path.with_suffix(".tmp")
        if format == "npz":
            np.savez(
                tmp,
                rows=self.rows,
                strtab=np.frombuffer(self.strtab, dtype=np.uint8),
                objects=np.frombuffer(
                    json.dumps(self.objects).encode(), dtype=np.uint8
                ),
                meta=np.frombuffer(json.dumps(self.meta).encode(), dtype=np.uint8),
            )
            # np.savez appends .npz to the name
            Path(str(tmp) + ".npz").rename(path)
            return
        rows_b = self.rows.tobytes()
        obj_b = json.dumps(self.objects).encode()
        meta_b = json.dumps(self.meta).encode()
        pt_b = (
            np.concatenate([self._pt_src, self._pt_dst]).astype("<i4").tobytes()
            if self._pt_src is not None
            else b""
        )
        header = np.array(
            [len(rows_b), len(self.strtab), len(obj_b), len(meta_b), len(pt_b)],
            dtype="<u8",
        ).tobytes()
        with tmp.open("wb") as f:
            f.write(self._MAGIC)
            f.write(header)
            f.write(rows_b)
            f.write(self.strtab)
            f.write(obj_b)
            f.write(meta_b)
            f.write(pt_b)
        tmp.rename(path)

    @staticmethod
    def load(path: str | Path) -> "RelocationTable":
        path = Path(path)
        with path.open("rb") as f:
            magic = f.read(6)
            if magic != RelocationTable._MAGIC:
                # npz fallback (baseline format)
                with np.load(path) as z:
                    return RelocationTable(
                        rows=z["rows"],
                        strtab=z["strtab"].tobytes(),
                        objects=json.loads(z["objects"].tobytes().decode()),
                        meta=json.loads(z["meta"].tobytes().decode()),
                    )
            buf = f.read()
        lens = np.frombuffer(buf[:40], dtype="<u8")
        off = 40
        secs = []
        for ln in lens:
            secs.append(buf[off : off + int(ln)])
            off += int(ln)
        rows = np.frombuffer(secs[0], dtype=RELOC_DTYPE).copy()
        t = RelocationTable(
            rows=rows,
            strtab=secs[1],
            objects=json.loads(secs[2].decode()),
            meta=json.loads(secs[3].decode()),
        )
        if secs[4]:
            pt = np.frombuffer(secs[4], dtype="<i4")
            half = len(pt) // 2
            t._pt_src = pt[:half].copy()
            t._pt_dst = pt[half:].copy()
        elif "host_rows" in t.meta:
            # page table was compiled but is empty (e.g. all-kernel apps)
            t._pt_src = np.zeros(0, np.int32)
            t._pt_dst = np.zeros(0, np.int32)
        return t

    def check_fresh(self, key: str, app_hash: str) -> None:
        """Reject a table whose resolution inputs differ from ``key``.

        ``key`` is the app's closure hash under the world being loaded
        (legacy tables without ``closure_hash`` compare their world hash —
        the stricter pre-incremental key they were saved under).
        """
        mine = self.meta.get("closure_hash") or self.meta["world_hash"]
        if mine != key:
            raise StaleTableError(
                f"table for closure {mine[:12]} used against closure "
                f"{key[:12]} — re-run end_mgmt to re-materialize"
            )
        if self.meta["app_hash"] != app_hash:
            raise StaleTableError("table belongs to a different application")


def build_table(
    app: StoreObject,
    relocations: Iterable[Relocation],
    *,
    world_hash: str,
    epoch: int,
    closure_hash: str = "",
) -> RelocationTable:
    """Materialize resolved relocations into a flat table (the paper's §4.2)."""
    relocations = list(relocations)
    slots, arena_size = build_arena_layout(app.refs)

    strtab = _StrTab()
    obj_sidecar: dict[int, dict] = {}

    def note_obj(o: Optional[StoreObject]) -> int:
        if o is None:
            return 0
        u = o.uuid
        if u not in obj_sidecar:
            obj_sidecar[u] = {
                "uuid": u,
                "name": o.name,
                "version": o.version,
                "content_hash": o.content_hash,
                "store_name": o.store_name,
                "payload_size": o.payload_size,
            }
        return u

    rows = np.zeros(len(relocations), dtype=RELOC_DTYPE)
    for i, r in enumerate(relocations):
        slot = slots.get(r.ref.name)
        dest = slot.offset if slot is not None else 0
        rows[i] = (
            int(r.rtype),
            0,
            r.addend,
            dest,
            r.st_value,
            r.st_size,
            note_obj(r.requirer),
            note_obj(r.provider),
            strtab.add(r.ref.name),
            strtab.add(r.requirer.name),
            strtab.add(r.provider.name if r.provider else ""),
        )

    meta = {
        "app": app.name,
        "app_hash": app.content_hash,
        "world_hash": world_hash,
        "closure_hash": closure_hash,
        "epoch": epoch,
        "arena_size": arena_size,
        "slots": {
            name: {
                "shape": list(s.shape),
                "dtype": s.dtype,
                "offset": s.offset,
                "nbytes": s.nbytes,
            }
            for name, s in slots.items()
        },
    }
    table = RelocationTable(
        rows=rows,
        strtab=strtab.bytes(),
        objects=list(obj_sidecar.values()),
        meta=meta,
    )
    # Compile the page table NOW (management time): the epoch loader and the
    # paged_reloc_copy kernel consume it without any per-row work.
    pt = compile_page_table(table)
    table._pt_src = pt.src_page
    table._pt_dst = pt.dst_page
    table.meta["host_rows"] = pt.host_rows.tolist()
    return table


# --------------------------------------------------------------------------
# Page-table compilation (consumed by kernels/paged_reloc_copy)
# --------------------------------------------------------------------------


@dataclass
class PageTable:
    """Flat gather map: ``dst[dst_page[i]] = blob[src_page[i]]``.

    ``blob_layout`` maps provider uuid -> page offset of that provider's
    payload inside the concatenated source blob. ``host_rows`` indexes table
    rows that could not be compiled to pages (CAST/INIT/unaligned SLICE).
    """

    dst_page: np.ndarray       # int32 [n]
    src_page: np.ndarray       # int32 [n]
    blob_layout: dict[int, int]
    blob_pages: int
    arena_pages: int
    host_rows: np.ndarray      # int64 indices into table.rows


def blob_layout(table: RelocationTable) -> tuple[dict[int, int], int]:
    """(provider uuid -> first page in the source blob, blob pages): the
    table's objects' payloads concatenated in sidecar order, each padded to
    whole pages — the layout ``PageTable.src_page`` indexes."""
    layout: dict[int, int] = {}
    cursor = 0
    for o in table.objects:
        layout[int(o["uuid"])] = cursor
        cursor += align_up(int(o["payload_size"]), PAGE_BYTES) // PAGE_BYTES
    return layout, cursor


def compile_page_table(table: RelocationTable) -> PageTable:
    P = PAGE_BYTES
    layout, cursor = blob_layout(table)

    dst_pages: list[np.ndarray] = []
    src_pages: list[np.ndarray] = []
    host_rows: list[int] = []
    rows = table.rows
    for i in range(len(rows)):
        r = rows[i]
        rt = int(r["type"])
        if rt == RelocType.KERNEL:
            continue
        src_byte = int(r["st_value"]) + int(r["addend"])
        size = int(r["st_size"])
        if (
            rt in (RelocType.DIRECT, RelocType.SLICE)
            and src_byte % P == 0
            and int(r["offset"]) % P == 0
            and int(r["provides_so_uuid"]) in layout
            and int(r["provides_so_uuid"]) != 0
        ):
            n = align_up(size, P) // P
            base_src = layout[int(r["provides_so_uuid"])] + src_byte // P
            base_dst = int(r["offset"]) // P
            dst_pages.append(np.arange(base_dst, base_dst + n, dtype=np.int32))
            src_pages.append(np.arange(base_src, base_src + n, dtype=np.int32))
        else:
            host_rows.append(i)

    dst = np.concatenate(dst_pages) if dst_pages else np.zeros(0, np.int32)
    src = np.concatenate(src_pages) if src_pages else np.zeros(0, np.int32)
    return PageTable(
        dst_page=dst,
        src_page=src,
        blob_layout=layout,
        blob_pages=cursor,
        arena_pages=align_up(table.arena_size, P) // P,
        host_rows=np.asarray(host_rows, dtype=np.int64),
    )

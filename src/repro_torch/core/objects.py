"""Object model for the stable linker.

The paper's world is ELF: applications and shared libraries exporting symbol
tables. Ours is the ML-framework analogue (see DESIGN.md §2):

* ``StoreObject``   — a content-addressed artifact in the registry. Kinds:
    - ``APPLICATION``: a job spec (model architecture + shape). It *requires*
      symbols (its parameter manifest == ELF relocation instructions) and
      names its dependencies (``needed`` == DT_NEEDED).
    - ``BUNDLE``: a weight bundle (shared library). It *exports* symbols —
      named tensors at byte offsets within its payload (== ELF symbol table).
    - ``KERNEL_LIB``: exports op symbols ("kernel:flash_attention@v2") bound
      to python entry points; enables kernel interposition (vignette 3).
* ``SymbolDef``     — an exported symbol: name, shape, dtype, payload offset.
* ``SymbolRef``     — a required symbol: name, shape, dtype, weak?.
* ``RelocType``     — the ML analogues of ELF relocation types.

Everything here is pure Python + hashlib; jax is deliberately not imported
(core is substrate-independent, exactly as the paper's linker is application-
independent).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Iterable, Mapping, Optional

# Tensors inside bundle payloads are aligned to PAGE_BYTES so that every
# relocation is a whole-page run in both source and destination. This is the
# TPU-native re-think of the paper's "sequential, prefetch-friendly" loader:
# page-granular relocations compile to a flat page table that a Pallas kernel
# can walk with scalar prefetch (kernels/paged_reloc_copy).
PAGE_BYTES = 4096


class RelocType(IntEnum):
    """ML analogues of ELF relocation types (R_X86_64_* in the paper)."""

    DIRECT = 0  # provider tensor matches shape+dtype exactly
    CAST = 1    # provider matches shape; dtype converted at load time
    SLICE = 2   # provider exports a stacked tensor; `addend` selects the slice
    INIT = 3    # weak symbol: no provider; fall back to the initializer
    KERNEL = 4  # op symbol bound to a kernel-library entry point


class ObjectKind(IntEnum):
    APPLICATION = 0
    BUNDLE = 1
    KERNEL_LIB = 2


@dataclass(frozen=True)
class SymbolDef:
    """A symbol exported by a bundle: ELF `Elf64_Sym` analogue.

    ``offset``/``nbytes`` locate the tensor bytes inside the object payload
    (``st_value``/``st_size`` in the paper's RelocationTableItem).
    """

    name: str
    shape: tuple[int, ...]
    dtype: str
    offset: int
    nbytes: int

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "offset": self.offset,
            "nbytes": self.nbytes,
        }

    @staticmethod
    def from_json(d: Mapping) -> "SymbolDef":
        return SymbolDef(
            name=d["name"],
            shape=tuple(d["shape"]),
            dtype=d["dtype"],
            offset=int(d["offset"]),
            nbytes=int(d["nbytes"]),
        )


@dataclass(frozen=True)
class SymbolRef:
    """A symbol required by an application (== a relocation instruction)."""

    name: str
    shape: tuple[int, ...]
    dtype: str
    weak: bool = False  # weak refs fall back to RelocType.INIT

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "shape": list(self.shape),
            "dtype": self.dtype,
            "weak": self.weak,
        }

    @staticmethod
    def from_json(d: Mapping) -> "SymbolRef":
        return SymbolRef(
            name=d["name"],
            shape=tuple(d["shape"]),
            dtype=d["dtype"],
            weak=bool(d.get("weak", False)),
        )


def _canonical_json(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


@dataclass(frozen=True)
class StoreObject:
    """A content-addressed object in the registry (Nix store path analogue).

    ``uuid`` is the first 8 bytes of the content hash interpreted as u64 —
    stable across machines (unlike the paper's per-materialization UUIDs,
    content addressing makes ours reproducible; noted in DESIGN.md §7).
    """

    name: str
    version: str
    kind: ObjectKind
    content_hash: str                      # hex blake2b-128 of manifest+payload
    symbols: Mapping[str, SymbolDef]       # exports (bundles / kernel libs)
    refs: tuple[SymbolRef, ...]            # imports (applications, mostly)
    needed: tuple[str, ...]                # DT_NEEDED: object *names*
    payload_digest: str = ""               # hex blake2b-128 of payload bytes
    payload_size: int = 0
    meta: Mapping[str, object] = field(default_factory=dict)

    @property
    def uuid(self) -> int:
        # masked to 63 bits so the value survives signed-int64 stores (SQLite)
        return int(self.content_hash[:16], 16) & 0x7FFF_FFFF_FFFF_FFFF

    @property
    def store_name(self) -> str:
        return f"{self.content_hash[:16]}-{self.name}-{self.version}"

    def manifest_json(self) -> dict:
        return {
            "name": self.name,
            "version": self.version,
            "kind": int(self.kind),
            "content_hash": self.content_hash,
            "symbols": [s.to_json() for s in self.symbols.values()],
            "refs": [r.to_json() for r in self.refs],
            "needed": list(self.needed),
            "payload_digest": self.payload_digest,
            "payload_size": self.payload_size,
            "meta": dict(self.meta),
        }

    @staticmethod
    def from_manifest(d: Mapping) -> "StoreObject":
        syms = {s["name"]: SymbolDef.from_json(s) for s in d.get("symbols", [])}
        return StoreObject(
            name=d["name"],
            version=d["version"],
            kind=ObjectKind(d["kind"]),
            content_hash=d["content_hash"],
            symbols=syms,
            refs=tuple(SymbolRef.from_json(r) for r in d.get("refs", [])),
            needed=tuple(d.get("needed", ())),
            payload_digest=d.get("payload_digest", ""),
            payload_size=int(d.get("payload_size", 0)),
            meta=dict(d.get("meta", {})),
        )


def content_hash(
    *,
    name: str,
    version: str,
    kind: ObjectKind,
    symbols: Iterable[SymbolDef],
    refs: Iterable[SymbolRef],
    needed: Iterable[str],
    payload_digest: str,
    meta: Optional[Mapping] = None,
) -> str:
    """Deterministic content hash over the manifest + payload digest."""
    h = hashlib.blake2b(digest_size=16)
    h.update(
        _canonical_json(
            {
                "name": name,
                "version": version,
                "kind": int(kind),
                "symbols": [s.to_json() for s in symbols],
                "refs": [r.to_json() for r in refs],
                "needed": list(needed),
                "payload_digest": payload_digest,
                "meta": dict(meta or {}),
            }
        )
    )
    return h.hexdigest()


def payload_digest(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def make_object(
    *,
    name: str,
    version: str,
    kind: ObjectKind,
    symbols: Iterable[SymbolDef] = (),
    refs: Iterable[SymbolRef] = (),
    needed: Iterable[str] = (),
    payload: bytes = b"",
    meta: Optional[Mapping] = None,
) -> tuple[StoreObject, bytes]:
    """Build a StoreObject (+ its payload bytes) with a computed content hash."""
    symbols = list(symbols)
    refs = tuple(refs)
    needed = tuple(needed)
    pdig = payload_digest(payload) if payload else ""
    chash = content_hash(
        name=name,
        version=version,
        kind=kind,
        symbols=symbols,
        refs=refs,
        needed=needed,
        payload_digest=pdig,
        meta=meta,
    )
    obj = StoreObject(
        name=name,
        version=version,
        kind=kind,
        content_hash=chash,
        symbols={s.name: s for s in symbols},
        refs=refs,
        needed=needed,
        payload_digest=pdig,
        payload_size=len(payload),
        meta=dict(meta or {}),
    )
    return obj, payload


def align_up(n: int, a: int = PAGE_BYTES) -> int:
    return (n + a - 1) // a * a

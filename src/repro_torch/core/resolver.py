"""The dynamic linker baseline: faithful ld.so search semantics (§2.1).

This module implements *traditional dynamic linking* over registry objects.
It is both (a) the baseline every benchmark compares against, and (b) the
resolution procedure the Executor *observes* during materialization — exactly
as MATR materializes "the relocation mapping produced by an invocation of a
traditional dynamic linker" (§4.2).

Semantics mirrored from ld.so:

* The search scope is the application followed by the breadth-first closure
  of its ``needed`` list (ELF load order).
* Every loaded object's references are resolved, not just the application's.
* For each reference the scope is probed **in order**; the first object whose
  symbol table contains the name wins (this is what makes interposition-by-
  search-order work, and what Figure 3 of the paper shows the limits of).
* Weak references that resolve nowhere become ``RelocType.INIT`` (weak-symbol
  semantics); strong ones raise UnresolvedSymbolError.

Slice matching: a provider may export a *stacked* symbol ``X`` with shape
``(k, *s)``; a reference named ``X[i]`` with shape ``s`` binds as a
``RelocType.SLICE`` with ``addend = i * prod(s) * itemsize`` — the ML
analogue of an ELF addend.
"""

from __future__ import annotations

import functools
import re
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .errors import SymbolMismatchError, UnresolvedSymbolError
from .objects import ObjectKind, RelocType, StoreObject, SymbolDef, SymbolRef
from .registry import World

_SLICE_RE = re.compile(r"^(?P<base>.*)\[(?P<idx>\d+)\]$")


# Stand-in numpy dtypes for element types numpy lacks. numpy has no
# bfloat16, so a bfloat16 symbol is held as its raw 2-byte pattern: the
# arena bytes stay identical to the reference package's, and every consumer
# that needs the values (the CAST path, repro_torch.convert) reinterprets
# them through torch.bfloat16 using the symbol's dtype NAME, never this
# stand-in's.
_STAND_INS = {"bfloat16": np.dtype("<u2")}


# numpy dtype lookup that understands names numpy lacks (bfloat16).
# Memoized: it sits on the load hot path (once per table row and once per
# tensor view); np.dtype instances are immutable, so sharing one per name
# across callers is safe.
@functools.lru_cache(maxsize=None)
def np_dtype(name: str) -> np.dtype:
    stand_in = _STAND_INS.get(name)
    if stand_in is not None:
        return stand_in
    return np.dtype(name)


def cast_elements(raw: np.ndarray, src_dtype: str, dst_dtype: str) -> np.ndarray:
    """Convert the elements in ``raw`` (bytes of ``src_dtype`` values) to
    ``dst_dtype`` — the value conversion of a CAST relocation.

    A numpy ``astype`` on the bfloat16 stand-in would convert the 2-byte
    *integer* pattern, silently giving wrong numbers, so any pair with
    bfloat16 on one side converts through torch (round to nearest even,
    as the reference's ml_dtypes does). A pair torch cannot convert raises.
    """
    if "bfloat16" not in (src_dtype, dst_dtype):
        return raw.view(np_dtype(src_dtype)).astype(np_dtype(dst_dtype))
    import torch

    def to_torch(name: str):
        dt = getattr(torch, name, None)
        if not isinstance(dt, torch.dtype):
            raise TypeError(f"CAST {src_dtype} -> {dst_dtype}: torch has no {name}")
        return dt

    src_t, dst_t = to_torch(src_dtype), to_torch(dst_dtype)
    host = np.array(raw, dtype=np.uint8)  # writable copy; raw may be an mmap
    if src_t is torch.bfloat16:
        t = torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(host.view(np_dtype(src_dtype)))
    out = t.to(dst_t)
    if dst_t is torch.bfloat16:
        return out.view(torch.int16).numpy().view(np_dtype("bfloat16"))
    return out.numpy()


@dataclass
class Relocation:
    """One resolved binding — the in-memory form of RelocationTableItem."""

    ref: SymbolRef
    requirer: StoreObject
    provider: Optional[StoreObject]
    rtype: RelocType
    addend: int = 0       # byte offset within the provider symbol (SLICE)
    st_value: int = 0     # provider symbol offset within its payload
    st_size: int = 0      # bytes this relocation transfers


def dependency_closure(app: StoreObject, world: World) -> list[StoreObject]:
    """Application followed by BFS over ``needed`` (ld.so load order)."""
    scope: list[StoreObject] = [app]
    seen = {app.name}
    queue = deque(app.needed)
    enqueued = set(app.needed)
    while queue:
        name = queue.popleft()
        if name in seen:
            continue
        obj = world.resolve(name)
        seen.add(name)
        scope.append(obj)
        for dep in obj.needed:
            if dep not in seen and dep not in enqueued:
                enqueued.add(dep)
                queue.append(dep)
    return scope


def _match(ref: SymbolRef, sdef: SymbolDef) -> Optional[tuple[RelocType, int, int]]:
    """Classify a name-matched (ref, def) pair.

    Returns (rtype, addend, nbytes) or None if the pair is not bindable
    (caller decides whether that is an error or a continue-search).
    """
    if ref.dtype == "kernel" or sdef.dtype == "kernel":
        # op symbols: function-pointer binding, st_value = entry index
        if ref.dtype == sdef.dtype == "kernel":
            return (RelocType.KERNEL, 0, 0)
        return None
    ref_dt = np_dtype(ref.dtype)
    def_dt = np_dtype(sdef.dtype)
    ref_elems = int(np.prod(ref.shape)) if ref.shape else 1
    if tuple(sdef.shape) == tuple(ref.shape):
        nbytes = ref_elems * def_dt.itemsize
        if sdef.dtype == ref.dtype:
            return (RelocType.DIRECT, 0, nbytes)
        return (RelocType.CAST, 0, nbytes)
    return None


def parse_slices(name: str) -> tuple[str, tuple[int, ...]]:
    """"X[1][2]" -> ("X", (1, 2)); "X" -> ("X", ())."""
    idxs: list[int] = []
    while True:
        m = _SLICE_RE.match(name)
        if not m:
            break
        idxs.append(int(m.group("idx")))
        name = m.group("base")
    return name, tuple(reversed(idxs))


def render_sliced(base: str, idxs) -> str:
    return base + "".join(f"[{i}]" for i in idxs)


def _match_slice(
    base_def: SymbolDef, ref: SymbolRef, idxs: tuple[int, ...]
) -> Optional[tuple[RelocType, int, int]]:
    """``X[i]...[k]`` against a stacked export ``X`` of shape
    (d0, ..., dk-1, *ref.shape); addend = ravel(idxs) * span."""
    k = len(idxs)
    if len(base_def.shape) != len(ref.shape) + k:
        return None
    if tuple(base_def.shape[k:]) != tuple(ref.shape):
        return None
    if any(i >= d for i, d in zip(idxs, base_def.shape[:k])):
        return None
    if base_def.dtype != ref.dtype:
        return None  # sliced casts unsupported: keeps load paths simple
    itemsize = np_dtype(base_def.dtype).itemsize
    span = int(np.prod(ref.shape)) * itemsize if ref.shape else itemsize
    flat = 0
    for i, d in zip(idxs, base_def.shape[:k]):
        flat = flat * d + i
    return (RelocType.SLICE, flat * span, span)


class DynamicResolver:
    """Traditional dynamic linking over a world view.

    ``probe_count`` is exposed so benchmarks can report the search work —
    the quantity stable linking eliminates.
    """

    def __init__(self, world: World, *, on_mismatch: str = "error"):
        assert on_mismatch in ("error", "skip")
        self.world = world
        self.on_mismatch = on_mismatch
        self.probe_count = 0

    # ------------------------------------------------------------ single ref
    def resolve_ref(
        self, ref: SymbolRef, requirer: StoreObject, scope: list[StoreObject]
    ) -> Relocation:
        base_name, idxs = parse_slices(ref.name)
        for obj in scope:
            if obj.kind == ObjectKind.APPLICATION and obj is not requirer:
                # applications export nothing in our model
                continue
            self.probe_count += 1
            sdef = obj.symbols.get(ref.name)
            if sdef is not None:
                m = _match(ref, sdef)
                if m is not None:
                    rtype, addend, nbytes = m
                    return Relocation(
                        ref=ref,
                        requirer=requirer,
                        provider=obj,
                        rtype=rtype,
                        addend=addend,
                        st_value=sdef.offset,
                        st_size=nbytes,
                    )
                if self.on_mismatch == "error":
                    raise SymbolMismatchError(
                        f"symbol {ref.name!r}: required shape "
                        f"{ref.shape}/{ref.dtype}, {obj.name} provides "
                        f"{tuple(sdef.shape)}/{sdef.dtype}"
                    )
                # skip: fall through to slice probing on this SAME object —
                # a provider may export a mismatched whole-name `X[i]` AND a
                # stacked base `X` the sliced ref can still bind against;
                # `continue` here would wrongly pass the object over.
            # sliced reference: try every split point — a provider may
            # export "X" (fully stacked) or "X[l]" (expert-stacked) etc.
            for k in range(1, len(idxs) + 1):
                partial = render_sliced(base_name, idxs[: len(idxs) - k])
                base = obj.symbols.get(partial)
                if base is None:
                    continue
                sm = _match_slice(base, ref, idxs[len(idxs) - k:])
                if sm is not None:
                    rtype, addend, nbytes = sm
                    return Relocation(
                        ref=ref,
                        requirer=requirer,
                        provider=obj,
                        rtype=rtype,
                        addend=addend,
                        st_value=base.offset,
                        st_size=nbytes,
                    )
        if ref.weak:
            if ref.dtype == "kernel":
                nbytes = 0
            else:
                dt = np_dtype(ref.dtype)
                nbytes = (
                    int(np.prod(ref.shape)) * dt.itemsize
                    if ref.shape
                    else dt.itemsize
                )
            return Relocation(
                ref=ref,
                requirer=requirer,
                provider=None,
                rtype=RelocType.INIT,
                st_size=nbytes,
            )
        raise UnresolvedSymbolError(
            ref.name, requirer.name, [o.name for o in scope]
        )

    # -------------------------------------------------------------- full app
    def resolve(self, app: StoreObject) -> list[Relocation]:
        """Resolve every loaded object's references against the global scope."""
        scope = dependency_closure(app, self.world)
        relocations: list[Relocation] = []
        for obj in scope:
            for ref in obj.refs:
                relocations.append(self.resolve_ref(ref, obj, scope))
        return relocations

    def resolve_with_hints(
        self, app: StoreObject, hints: dict[str, str]
    ) -> list[Relocation]:
        """Direct-binding baseline variant (§2.2.2, Solaris -B direct).

        ``hints`` maps symbol name -> provider object name; each ref probes
        only its hinted provider. Still pays per-symbol hashing + validation,
        which is the residual cost the paper notes mitigations retain.
        """
        scope = dependency_closure(app, self.world)
        by_name = {o.name: o for o in scope}
        relocations = []
        for obj in scope:
            for ref in obj.refs:
                hinted = hints.get(ref.name)
                sub_scope = [by_name[hinted]] if hinted in by_name else scope
                relocations.append(self.resolve_ref(ref, obj, sub_scope))
        return relocations

"""Fine-grained interposition (§5.3.3, Vignette 3).

Dynamic linking binds with one global search order, so "use malloc from
libduma *only for calls made by libmpm*" is inexpressible (Figure 3). A
materialized table makes each relocation row individually addressable: we
rebind matching rows to a different provider and set FLAG_EDITED.

ML framing: route ``kernel:rmsnorm`` for layers 3..7 to a checked debug
kernel, or point one layer's weights at an instrumented bundle, while every
other relocation keeps its default provider.
"""

from __future__ import annotations

import fnmatch
from typing import Optional


def _match_glob(name: str, glob: str) -> bool:
    """fnmatch with literal ``[i]`` slice suffixes: our symbol names use
    brackets for slices, so ``[`` is escaped unless the user writes a real
    character class is impossible — * and ? remain wildcards."""
    return fnmatch.fnmatchcase(name, glob.replace("[", "[[]"))

import numpy as np

from .errors import SymbolMismatchError, UnknownObjectError
from .objects import RelocType, StoreObject
from .relocation import FLAG_EDITED, RelocationTable, _StrTab
from .resolver import _match, _match_slice, parse_slices, render_sliced


def rebind(
    table: RelocationTable,
    *,
    symbol_glob: str,
    new_provider: StoreObject,
    requires_glob: Optional[str] = None,
) -> int:
    """Rebind rows whose symbol matches ``symbol_glob`` (and, optionally,
    whose *requiring* object matches ``requires_glob``) to ``new_provider``.

    Returns the number of rows rebound. Mutates ``table`` in place; callers
    persist via ``table.save`` — edits survive for the rest of the epoch and
    are visibly flagged in the Inspector output.
    """
    rows = table.rows
    # Snapshot row names from the CURRENT strtab before any offset rewrite.
    names = {
        field: [table.name_at(rows[field][i]) for i in range(len(rows))]
        for field in ("symbol_name", "requires_so_name", "provides_so_name")
    }
    # Rebuild the strtab so we can add the new provider's name; existing
    # strings are re-interned.
    strtab = _StrTab()
    remap: dict[int, int] = {}
    for field in ("symbol_name", "requires_so_name", "provides_so_name"):
        for off in np.unique(rows[field]):
            remap[int(off)] = strtab.add(table.name_at(int(off)))
    new_prov_off = strtab.add(new_provider.name)

    # sidecar entry for the new provider
    if table.object_by_uuid(new_provider.uuid) is None:
        table.objects.append(
            {
                "uuid": new_provider.uuid,
                "name": new_provider.name,
                "version": new_provider.version,
                "content_hash": new_provider.content_hash,
                "store_name": new_provider.store_name,
                "payload_size": new_provider.payload_size,
            }
        )
        table._uuid_to_obj = {}

    n = 0
    for i in range(len(rows)):
        for field in ("symbol_name", "requires_so_name", "provides_so_name"):
            rows[field][i] = remap[int(rows[field][i])]
        sym = names["symbol_name"][i]
        if not _match_glob(sym, symbol_glob):
            continue
        if requires_glob is not None and not _match_glob(
            names["requires_so_name"][i], requires_glob
        ):
            continue
        slot = table.meta["slots"].get(sym)
        if int(rows["type"][i]) == RelocType.KERNEL:
            sdef = new_provider.symbols.get(sym)
            if sdef is None:
                raise UnknownObjectError(
                    f"{new_provider.name} does not export kernel {sym!r}"
                )
            rows["st_value"][i] = sdef.offset
        else:
            if slot is None:
                continue
            from .objects import SymbolRef

            ref = SymbolRef(sym, tuple(slot["shape"]), slot["dtype"])
            base_name, idxs = parse_slices(sym)
            sdef = new_provider.symbols.get(sym)
            sm = None
            if sdef is not None:
                mm = _match(ref, sdef)
                if mm is None:
                    raise SymbolMismatchError(
                        f"{new_provider.name}:{sym} shape/dtype incompatible"
                    )
                rtype, addend, nbytes = mm
                rows["st_value"][i] = sdef.offset
            else:
                for k in range(1, len(idxs) + 1):
                    partial = render_sliced(base_name, idxs[: len(idxs) - k])
                    base = new_provider.symbols.get(partial)
                    if base is None:
                        continue
                    sm = _match_slice(base, ref, idxs[len(idxs) - k:])
                    if sm is not None:
                        rtype, addend, nbytes = sm
                        rows["st_value"][i] = base.offset
                        break
                if sm is None:
                    raise UnknownObjectError(
                        f"{new_provider.name} does not export {sym!r}"
                    )
            rows["type"][i] = int(rtype)
            rows["addend"][i] = addend
            rows["st_size"][i] = nbytes
        rows["provides_so_uuid"][i] = new_provider.uuid
        rows["provides_so_name"][i] = new_prov_off
        rows["flags"][i] |= FLAG_EDITED
        n += 1

    table.strtab = strtab.bytes()
    if n:
        # rebinding moved source offsets: recompile the page table so the
        # paged epoch loader sees the edit
        from .relocation import compile_page_table

        pt = compile_page_table(table)
        table._pt_src = pt.src_page
        table._pt_dst = pt.dst_page
        table.meta["host_rows"] = pt.host_rows.tolist()
    return n

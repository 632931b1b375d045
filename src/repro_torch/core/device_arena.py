"""Table-driven epoch loads that build the arena on a torch device.

The reference applies a materialized page table on the host
(``Executor._apply_paged``, a numpy gather per provider); its Pallas
``paged_reloc_copy`` kernel was that gather's device form. Here the kernel
takes that place, and ``apply_table_on_device`` is what ``_apply_table``
runs when a load names a device:

(a) take the table's compiled page table, or compile it
    (``compile_page_table``) when the table carries none;
(b) upload the payloads of the providers the page table reads into one
    device blob laid out as ``blob_layout`` — through two pinned staging
    buffers on CUDA, never by wrapping the read-only payload mmap;
(c) launch ``paged_reloc_copy`` once into a ``torch.zeros`` arena (padding
    and unnamed pages read as zero, so every byte is defined) — or, given
    ``into`` (an earlier device image of the same slot layout), into that
    image's arena, zeroed first: a compiled step whose kernels read fixed
    addresses gets each start's world there, with no second resident copy
    of the state (``train/program.py``);
(d) apply the CAST/INIT/unaligned rows (``meta["host_rows"]``) after the
    kernel, as the reference folds its gather in before them: the rows run
    on the host with the executor's row code against a host copy of each
    slot they touch, and each slot goes back up whole. With the default
    zeros initializer an INIT row of a slot would write the zeros the
    arena already holds, so it is left out (``rows_to_apply``): a
    trainer's first start would otherwise copy its whole optimizer state
    (weak symbols, all INIT) down and up again;
(e) bind KERNEL symbols on the host;
(f) free the blob and synchronise, so ``LoadStats`` covers the device
    work: ``upload_s``, ``kernel_s`` and ``host_rows_s`` split ``io_s``,
    each the length of its span (``link.upload``, ``link.page_copy``,
    ``link.host_rows``; ``repro_torch.obs``), and ``read_s`` and
    ``stage_wait_s`` split the host's part of ``upload_s``;
(g) return a ``LoadedImage`` whose ``arena`` is the device bytes
    (``uint8``, ``arena_size`` long) and whose ``tensors[name]`` are views
    of it in the slot's own torch dtype (bfloat16 included).

Slot bytes equal the host image's (``tests/test_torch_paged.py``). Device
images never enter the ``EpochCache``: each load owns its arena.
``slot_layout_digest`` names a layout: an arena's addresses are part of
a compiled program's identity.
"""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device, torch_dtype

from .objects import PAGE_BYTES, RelocType, align_up
from .relocation import RelocationTable, blob_layout, compile_page_table

STAGE_BYTES = 64 << 20      # each of the two pinned staging buffers


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _upload_blob(executor, table: RelocationTable, src: np.ndarray,
                 dev: torch.device, stats) -> torch.Tensor:
    """The source blob on ``dev``: every provider that ``src`` reads, its
    payload at its ``blob_layout`` pages (tail of a partial page zeroed).
    Pages of providers no entry reads are left unwritten. Each host copy
    out of a payload's mapping is a ``link.payload_read`` span (summed in
    ``stats.read_s``), each wait for a staging buffer's copy to drain a
    ``link.stage_wait`` (``stats.stage_wait_s``)."""
    from repro_torch.kernels.paged_reloc_copy import PAGE_SHAPE

    layout, n_pages = blob_layout(table)
    blob = torch.empty((n_pages,) + PAGE_SHAPE, dtype=torch.int32, device=dev)
    flat = blob.view(-1).view(torch.uint8)
    read = np.zeros(n_pages, dtype=bool)
    read[src] = True
    jobs = []                                   # (payload mmap, blob offset, pages)
    for o in table.objects:
        lo = layout[int(o["uuid"])]
        pages = align_up(int(o["payload_size"]), PAGE_BYTES) // PAGE_BYTES
        if pages and read[lo : lo + pages].any():
            jobs.append((executor._payload_mmap(o["store_name"]), lo * PAGE_BYTES,
                         pages * PAGE_BYTES))
    if dev.type != "cuda":
        host = flat.numpy()
        for mm, off, size in jobs:
            n = min(mm.size, size)
            with obs.span("link.payload_read", bytes=n) as read:
                host[off : off + n] = mm[:n]
            stats.read_s += read.dur
            host[off + n : off + size] = 0
        return blob
    # two pinned buffers: the host fills one while the other's copy runs
    stages = [torch.empty(STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
              for _ in range(2)]
    done: list = [None, None]
    k = 0
    for mm, off, size in jobs:
        n = min(mm.size, size)
        if n < size:
            flat[off + n : off + size].zero_()
        for a in range(0, n, STAGE_BYTES):
            m = min(STAGE_BYTES, n - a)
            i = k % 2
            if done[i] is not None:
                with obs.span("link.stage_wait") as wait:
                    done[i].synchronize()
                stats.stage_wait_s += wait.dur
            with obs.span("link.payload_read", bytes=m) as read:
                stages[i].numpy()[:m] = mm[a : a + m]
            stats.read_s += read.dur
            flat[off + a : off + a + m].copy_(stages[i][:m], non_blocking=True)
            done[i] = torch.cuda.Event()
            done[i].record()
            k += 1
    return blob


def rows_to_apply(executor, table: RelocationTable, rows) -> list:
    """The host rows that change a ``torch.zeros`` arena: all of them, but
    for the INIT rows of slots when the executor's initializer is the
    default zeros one (an INIT row without a slot, a weak kernel ref that
    binds the no-op entry, stays)."""
    from .executor import _zeros_init

    if executor.initializer is not _zeros_init:
        return list(rows)
    slots = table.slots()
    types, names = table.rows["type"], table.rows["symbol_name"]
    return [i for i in rows if not (int(types[i]) == RelocType.INIT
                                    and table.name_at(names[i]) in slots)]


def _apply_host_rows(executor, table: RelocationTable, flat: torch.Tensor,
                     kernels: dict, rows) -> None:
    """Run ``rows`` on the host against host copies of the slots they
    touch (read back first: a row may fill only part of its slot), then
    write each touched slot back into ``flat``."""
    host: dict[int, tuple] = {}

    def slot_bytes(slot):
        hit = host.get(slot.offset)
        if hit is None:
            span = flat[slot.offset : slot.offset + slot.nbytes]
            hit = host[slot.offset] = (span, span.to("cpu", copy=True).numpy())
        return hit[1]

    executor._apply_row_subset(table, slot_bytes, kernels, rows)
    for span, data in host.values():
        span.copy_(torch.from_numpy(data))


def slot_layout_digest(slots: dict) -> str:
    """A digest of an arena's slot layout (each slot's name, offset, bytes,
    dtype and shape, in the layout's order)."""
    rows = [[s.name, s.offset, s.nbytes, s.dtype, list(s.shape)] for s in slots.values()]
    return hashlib.blake2b(json.dumps(rows).encode(), digest_size=16).hexdigest()


def _target_arena(into, table: RelocationTable, dev: torch.device, pages: int):
    """``into``'s arena as the kernel's int32 pages, zeroed, after checking
    that it is ``pages`` pages on ``dev`` laid out as ``table``'s slots."""
    from repro_torch.kernels.paged_reloc_copy import PAGE_SHAPE

    arena = into.arena
    if arena.device.type != dev.type or dev.index not in (None, arena.device.index):
        raise ValueError(f"the destination arena is on {arena.device}, not {dev}")
    if into.table is None or into.table.slots() != table.slots():
        raise ValueError("the destination arena's slot layout differs from the table's")
    if arena.numel() != pages * PAGE_BYTES or arena.storage_offset() % 4:
        raise ValueError(f"the destination arena holds {arena.numel()} bytes, not the "
                         f"table's {pages} pages of {PAGE_BYTES}")
    out = arena.view(torch.int32).view((pages,) + PAGE_SHAPE)
    with torch.no_grad():
        out.zero_()
    return out


def apply_table_on_device(executor, app, table: RelocationTable, stats, device,
                          into=None):
    """Steps (a)-(g) of the module docstring; returns the ``LoadedImage``.
    With ``into`` the arena is ``into.arena``: its tensors, and every view
    taken of it before, hold this load's bytes."""
    from repro_torch.kernels.paged_reloc_copy import PAGE_SHAPE, paged_reloc_copy

    from .executor import LoadedImage, paged_payload_bytes

    dev = resolve_device(device)
    t0 = time.monotonic()
    if table._pt_src is not None and "host_rows" in table.meta:   # (a)
        src, dst = table._pt_src, table._pt_dst
        host_rows = table.meta["host_rows"]
    else:
        pt = compile_page_table(table)
        src, dst, host_rows = pt.src_page, pt.dst_page, pt.host_rows.tolist()

    with obs.span("link.upload") as upload:
        blob = _upload_blob(executor, table, src, dev, stats)     # (b)
        _sync(dev)
    stats.upload_s = upload.dur

    with obs.span("link.page_copy", pages=len(src)) as copy:
        arena_pages = align_up(table.arena_size, PAGE_BYTES) // PAGE_BYTES
        if into is None:
            arena = torch.zeros((arena_pages,) + PAGE_SHAPE, dtype=torch.int32,
                                device=dev)
        else:
            arena = _target_arena(into, table, dev, arena_pages)
        paged_reloc_copy(blob, arena, src, dst)                   # (c)
        _sync(dev)
    stats.kernel_s = copy.dur
    del blob

    with obs.span("link.host_rows") as rows:
        flat = arena.view(-1).view(torch.uint8)
        kernels: dict[str, str] = {}
        host_rows = rows_to_apply(executor, table, host_rows)     # (d)
        if host_rows:
            _apply_host_rows(executor, table, flat, kernels, host_rows)
        executor._bind_kernels(table, kernels)                    # (e)
        _sync(dev)                                                # (f)
    stats.host_rows_s = rows.dur

    tensors = {}                                                  # (g)
    for name, s in table.slots().items():
        dt = torch_dtype(s.dtype)
        if s.offset % dt.itemsize:
            raise ValueError(f"slot {name!r} at offset {s.offset} is not "
                             f"aligned for {s.dtype}")
        tensors[name] = flat[s.offset : s.offset + s.nbytes].view(dt).view(s.shape)
    stats.io_s = time.monotonic() - t0
    stats.relocations = len(table.rows)
    stats.bytes_loaded = paged_payload_bytes(table)
    return LoadedImage(
        app=app,
        arena=flat[: table.arena_size],
        tensors=tensors,
        kernels=kernels,
        table=table,
        stats=stats,
    )

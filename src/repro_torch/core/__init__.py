"""repro_torch.core — stable linking (the paper's contribution), substrate-free.

This is the ENGINE ROOM. The public session API lives one level up in
``repro_torch.link``: ``Workspace.open(root)`` wires everything below into one
object with transactional management times (``with ws.management() as tx``),
by-name load strategies, and ``ws.explain()`` observability. New application
code should go through ``Workspace``; constructing ``Manager``/``Executor``
pairs by hand (including the ``on_materialize`` hook) is deprecated and kept
for tooling and benchmarks that measure below the facade.

Engine-room surface:

    Registry, World              — content-addressed object store + world views
    Manager, Mode                — begin_mgmt / update_obj / end_mgmt / abort_mgmt
    Executor, LoadedImage        — materialize + strategy-registry loading
    DynamicResolver              — the traditional-dynamic-linking baseline
    IndexedResolver, SymbolIndex — GNU-hash-analogue indexed resolution
    closure_hash                 — per-app dependency-closure identity (the
                                   key that makes re-materialization
                                   incremental)
    RelocationTable, PageTable   — materialized tables (+ TPU page compilation)
    EpochCache, process_cache    — the epoch-resident runtime: process-wide
                                   shared-arena / index / binding cache
                                   (capacity-bounded LRU, flash-invalidated
                                   at every end_mgmt)
    shm_arena, run_fleet         — cross-process shared arenas: named POSIX
                                   shm segments so N worker processes map
                                   one physical copy (``stable-shm``)
    TieredStore, export_store    — tiered remote arena store: one machine
                                   bakes + exports, a fleet fetches with a
                                   verified, resumable, retried path and
                                   degrades to local bakes (``stable-remote``)
    ShmRing                      — the serving data plane: SPSC shm
                                   request/response rings (fixed slots,
                                   per-slot generation counters, record-
                                   driven gc like the arenas)
    inspector, interpose         — observability + fine-grained rebinding
    CompileCache                 — AOT executable materialization
"""

from .arena_store import (
    ArenaStoreError,
    FetchPolicy,
    StoreReport,
    TieredStore,
    export_store,
)
from .compile_cache import CompileCache, CompileStats, cache_key
from .epoch_cache import ArenaEntry, CacheStats, EpochCache, process_cache
from .errors import (
    ImmutableEpochError,
    ModeError,
    PayloadIntegrityError,
    StableLinkingError,
    StaleTableError,
    StateSchemaError,
    SymbolMismatchError,
    UnknownObjectError,
    UnknownStrategyError,
    UnresolvedSymbolError,
)
from .executor import (
    WEAK_KERNEL_NOOP,
    Executor,
    LazyImage,
    LoadedImage,
    LoadStats,
    MaterializationResult,
)
from .manager import Manager, Mode
from .objects import (
    PAGE_BYTES,
    ObjectKind,
    RelocType,
    StoreObject,
    SymbolDef,
    SymbolRef,
    align_up,
    make_object,
)
from .registry import GcReport, Registry, World
from .relocation import (
    PageTable,
    RelocationTable,
    build_arena_layout,
    build_table,
    compile_page_table,
)
from .resolver import DynamicResolver, Relocation, dependency_closure, np_dtype
from .shm_arena import (
    SharedArenaSegment,
    ShmArenaEntry,
    list_segments,
    run_fleet,
    segment_exists,
    unlink_segment,
)
from .shm_ring import ShmRing, ShmRingError, ring_name
from .symbol_index import IndexedResolver, SymbolIndex, closure_hash

__all__ = [
    "ArenaEntry",
    "ArenaStoreError",
    "FetchPolicy",
    "StoreReport",
    "TieredStore",
    "export_store",
    "CacheStats",
    "CompileCache",
    "CompileStats",
    "EpochCache",
    "GcReport",
    "cache_key",
    "process_cache",
    "ImmutableEpochError",
    "ModeError",
    "PayloadIntegrityError",
    "StableLinkingError",
    "StaleTableError",
    "StateSchemaError",
    "SymbolMismatchError",
    "UnknownObjectError",
    "UnknownStrategyError",
    "UnresolvedSymbolError",
    "Executor",
    "WEAK_KERNEL_NOOP",
    "LazyImage",
    "LoadedImage",
    "LoadStats",
    "Manager",
    "Mode",
    "PAGE_BYTES",
    "ObjectKind",
    "RelocType",
    "StoreObject",
    "SymbolDef",
    "SymbolRef",
    "align_up",
    "make_object",
    "Registry",
    "World",
    "PageTable",
    "RelocationTable",
    "build_arena_layout",
    "build_table",
    "compile_page_table",
    "DynamicResolver",
    "IndexedResolver",
    "MaterializationResult",
    "Relocation",
    "SharedArenaSegment",
    "ShmArenaEntry",
    "ShmRing",
    "ShmRingError",
    "ring_name",
    "SymbolIndex",
    "closure_hash",
    "dependency_closure",
    "list_segments",
    "np_dtype",
    "open_workspace",
    "run_fleet",
    "segment_exists",
    "unlink_segment",
]


def open_workspace(root):
    """Deprecated shim for the old hand-wiring pattern.

    Returns a ``repro_torch.link.Workspace`` (the replacement for constructing
    Registry/Manager/Executor by hand). Prefer importing it directly::

        from repro_torch.link import Workspace
        ws = Workspace.open(root)
    """
    import warnings

    warnings.warn(
        "repro_torch.core.open_workspace is a transition shim; import "
        "repro_torch.link.Workspace directly",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.link import Workspace

    return Workspace.open(root)

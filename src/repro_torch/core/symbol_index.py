"""Indexed symbol resolution: the GNU-hash analogue of the ld.so search.

``DynamicResolver`` (resolver.py) probes every object in the search scope,
name by name — O(refs x scope) hash probes per application, the quadratic
symbol-search cost the paper (and the GNU-hash/prelink lineage surveyed in
Liska, *Optimizing large applications*) exists to eliminate.  This module
removes it from *materialization* without touching the faithful baseline:

* ``SymbolIndex`` — a per-scope name -> scope-ordered exporter map built
  once per dependency closure.  Candidates merge in linear-probe order, so
  search-order interposition semantics are preserved exactly; slice bases
  (a stacked export ``X`` serving refs ``X[i]``) are found through the same
  dict via progressively stripped partial names, and successful bindings are
  memoized per ref so applications sharing a closure resolve in O(1).
* ``IndexedResolver`` — drop-in for ``DynamicResolver`` on the strict
  (``on_mismatch="error"``) path: ``Executor.materialize`` and the
  management-time ``indexed`` load strategy use it.  ``DynamicResolver``
  itself stays untouched as the ld.so baseline every benchmark compares
  against.
* ``closure_hash`` — the identity of an application's *resolution inputs*:
  a digest over the content hashes of its dependency closure in scope
  order.  Everything a resolution can observe (symbol tables, refs,
  ``needed`` edges) is covered by the closure's content hashes, so two
  worlds whose bindings differ only in objects *outside* an app's closure
  produce the same closure hash — the key that makes re-materialization
  incremental (core/executor.py keys tables and baked arenas by it).

Equivalence contract: for any world that resolves without
``SymbolMismatchError`` suppression, ``IndexedResolver.resolve(app)``
returns exactly the relocations ``DynamicResolver(world).resolve(app)``
returns, in the same order (tested in tests/test_perf_pipeline.py).
Tolerant/skip-mode resolution (previews over broken staged worlds) keeps
using ``DynamicResolver(on_mismatch="skip")``: skip mode may bind a *later*
exporter of a name, which a first-wins index cannot represent.
"""

from __future__ import annotations

import hashlib
import time
from typing import Optional

import numpy as np

from .errors import SymbolMismatchError, UnresolvedSymbolError
from .objects import ObjectKind, RelocType, StoreObject
from .registry import World
from .resolver import (
    Relocation,
    _match,
    _match_slice,
    dependency_closure,
    np_dtype,
    parse_slices,
    render_sliced,
)


def closure_hash(app: StoreObject, world: World) -> str:
    """Digest of the app's dependency-closure content hashes (scope order).

    This is the complete input of a resolution: the requiring refs, every
    reachable symbol table, and the search order itself are all functions of
    the closure's content hashes.  Unlike ``world.world_hash`` it does NOT
    change when an object outside the closure is published — which is
    exactly what lets an epoch commit reuse the tables of untouched apps.
    """
    h = hashlib.blake2b(digest_size=16)
    for obj in dependency_closure(app, world):
        h.update(obj.content_hash.encode())
    return h.hexdigest()


def scope_key(scope: list[StoreObject]) -> tuple[str, ...]:
    """Cache key for a search scope: the ordered content-hash tuple."""
    return tuple(o.content_hash for o in scope)


# Memo sentinel: a weak ref that resolved nowhere (binds RelocType.INIT).
_WEAK_INIT = object()


class SymbolIndex:
    """Scope-ordered symbol index over one search scope.

    For every name exported by a non-application object the index keeps the
    exporters in scope order; candidate merging then reproduces exactly the
    order ld.so's linear probe visits them.  Applications export nothing to
    other objects (their own symbols are visible only to their own refs),
    so they are excluded from the shared index and consulted per-requirer
    instead.
    """

    def __init__(self, scope: list[StoreObject]):
        self.scope = scope
        self._pos = {id(obj): pos for pos, obj in enumerate(scope)}
        # name -> ALL exporters in scope order. The whole-name probe only
        # ever consults the first (strict mode raises on the first
        # name-matched mismatch, exactly where the linear probe would), but
        # slice probes must see every exporter: a base that soft-fails
        # _match_slice on one provider can still bind on a later one.
        index: dict[str, list[tuple[int, StoreObject, object]]] = {}
        for pos, obj in enumerate(scope):
            if obj.kind == ObjectKind.APPLICATION:
                continue
            for name, sdef in obj.symbols.items():
                index.setdefault(name, []).append((pos, obj, sdef))
        self._index = index
        # ref -> (provider, rtype, addend, st_value, st_size) | _WEAK_INIT;
        # only for requirers without private symbols (the common case), so
        # every app sharing this closure resolves repeated refs in O(1).
        self._memo: dict = {}
        self.probe_count = 0  # dict lookups performed (search work)

    # ------------------------------------------------------------ resolution
    def resolve_ref(self, ref, requirer: StoreObject) -> Relocation:
        own = (
            requirer.symbols
            if requirer.kind == ObjectKind.APPLICATION and requirer.symbols
            else None
        )
        if own is None:
            hit = self._memo.get(ref)
            if hit is _WEAK_INIT:
                return self._weak_init(ref, requirer)
            if hit is not None:
                provider, rtype, addend, st_value, st_size = hit
                return Relocation(
                    ref=ref, requirer=requirer, provider=provider,
                    rtype=rtype, addend=addend, st_value=st_value,
                    st_size=st_size,
                )
        reloc = self._resolve_uncached(ref, requirer, own)
        if own is None:
            if reloc.rtype == RelocType.INIT and reloc.provider is None:
                self._memo[ref] = _WEAK_INIT
            else:
                self._memo[ref] = (
                    reloc.provider, reloc.rtype, reloc.addend,
                    reloc.st_value, reloc.st_size,
                )
        return reloc

    def _resolve_uncached(self, ref, requirer, own) -> Relocation:
        base_name, idxs = parse_slices(ref.name)
        req_pos = self._pos.get(id(requirer), 0)
        # Candidates replicate the dynamic probe order: (scope position,
        # probe rank) where rank 0 is the whole-name probe and rank k is the
        # slice probe that strips k index levels — exactly the order
        # DynamicResolver.resolve_ref visits them.
        cands: list[tuple[int, int, StoreObject, object, tuple[int, ...]]] = []

        def note(name: str, rank: int, sub_idxs: tuple[int, ...]) -> None:
            self.probe_count += 1
            hits = self._index.get(name)
            if hits is not None:
                # rank 0 (whole name): the first exporter decides — strict
                # mode either binds it or raises, never probes past it.
                # rank k (slice base): every exporter is a candidate.
                for pos, obj, sdef in hits[:1] if rank == 0 else hits:
                    cands.append((pos, rank, obj, sdef, sub_idxs))
            if own is not None:
                sdef = own.get(name)
                if sdef is not None:
                    cands.append((req_pos, rank, requirer, sdef, sub_idxs))

        note(ref.name, 0, ())
        for k in range(1, len(idxs) + 1):
            partial = render_sliced(base_name, idxs[: len(idxs) - k])
            note(partial, k, idxs[len(idxs) - k:])

        for pos, rank, obj, sdef, sub_idxs in sorted(
            cands, key=lambda c: (c[0], c[1])
        ):
            if rank == 0:
                m = _match(ref, sdef)
                if m is None:
                    # strict mode, like DynamicResolver(on_mismatch="error"):
                    # a name match that is not bindable is a hard error
                    raise SymbolMismatchError(
                        f"symbol {ref.name!r}: required shape "
                        f"{ref.shape}/{ref.dtype}, {obj.name} provides "
                        f"{tuple(sdef.shape)}/{sdef.dtype}"
                    )
            else:
                m = _match_slice(sdef, ref, sub_idxs)
                if m is None:
                    continue
            rtype, addend, nbytes = m
            return Relocation(
                ref=ref, requirer=requirer, provider=obj, rtype=rtype,
                addend=addend, st_value=sdef.offset, st_size=nbytes,
            )
        if ref.weak:
            return self._weak_init(ref, requirer)
        raise UnresolvedSymbolError(
            ref.name, requirer.name, [o.name for o in self.scope]
        )

    @staticmethod
    def _weak_init(ref, requirer) -> Relocation:
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
            ref=ref, requirer=requirer, provider=None,
            rtype=RelocType.INIT, st_size=nbytes,
        )


class IndexedResolver:
    """O(1)-per-ref resolution over per-closure symbol indexes.

    Same result as ``DynamicResolver(world)`` (strict mode) — see the module
    docstring's equivalence contract — at a fraction of the probe count.
    ``index_cache`` (scope-key -> SymbolIndex) is shared by the Executor so
    every application with the same dependency closure reuses one index.
    """

    def __init__(
        self,
        world: World,
        *,
        index_cache: Optional[dict] = None,
    ):
        self.world = world
        self._cache = index_cache if index_cache is not None else {}
        self.index_build_s = 0.0  # time spent building indexes (cache misses)
        self.probe_count = 0

    @staticmethod
    def _cache_key(scope: list[StoreObject]) -> tuple[str, ...]:
        # Applications contribute nothing to the shared index (they export
        # only to themselves), so apps whose *dependency* lists match share
        # one index — the common serving-fleet case. An application that
        # does export private symbols falls back to the exact scope key,
        # where per-requirer positions matter.
        if any(
            o.kind == ObjectKind.APPLICATION and o.symbols for o in scope
        ):
            return scope_key(scope)
        return tuple(
            o.content_hash
            for o in scope
            if o.kind != ObjectKind.APPLICATION
        )

    def index_for(self, scope: list[StoreObject]) -> SymbolIndex:
        key = self._cache_key(scope)
        idx = self._cache.get(key)
        if idx is None:
            t0 = time.perf_counter()
            idx = SymbolIndex(scope)
            self.index_build_s += time.perf_counter() - t0
            self._cache[key] = idx
        return idx

    def resolve_ref(self, ref, requirer, scope) -> Relocation:
        idx = self.index_for(scope)
        p0 = idx.probe_count
        reloc = idx.resolve_ref(ref, requirer)
        self.probe_count += idx.probe_count - p0
        return reloc

    def resolve(self, app: StoreObject) -> list[Relocation]:
        """Resolve every loaded object's references against the scope index
        (same coverage and order as ``DynamicResolver.resolve``)."""
        scope = dependency_closure(app, self.world)
        idx = self.index_for(scope)
        p0 = idx.probe_count
        relocations = [
            idx.resolve_ref(ref, obj) for obj in scope for ref in obj.refs
        ]
        self.probe_count += idx.probe_count - p0
        return relocations

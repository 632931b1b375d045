"""Sharding context: ``with mesh_rules(mesh, rules): ...`` — the port of
the reference's ``dist/context.py``.

Models call ``constrain(x, logical_axes)`` unconditionally. Outside a
``mesh_rules`` context (unit tests, single-device runs), and for a plain
tensor, it is the identity. Inside one, on a DTensor, it resolves the
logical axes through ``dist.sharding.spec_for`` and redistributes the
tensor to the placements they give: the counterpart of
``with_sharding_constraint``, applied eagerly. This keeps model code
mesh-agnostic — the launcher owns placement policy.

The context is a thread-local stack so nested meshes resolve against the
innermost one.
"""

from __future__ import annotations

import sys
import threading
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

from .sharding import ShardingRules, placements_for, spec_for

_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing DTensor's package
    (a second to import) where no DTensor can exist yet."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def current_mesh_rules() -> Optional[Tuple[object, Optional[ShardingRules]]]:
    """The innermost installed (mesh, rules), or None outside any context."""
    st = _stack()
    return st[-1] if st else None


@contextmanager
def mesh_rules(mesh, rules: Optional[ShardingRules] = None):
    """Install mesh+rules for the duration of a step."""
    st = _stack()
    st.append((mesh, rules))
    try:
        yield
    finally:
        st.pop()


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute the DTensor ``x`` to the placements its logical axes
    resolve to. Identity without a ``mesh_rules`` context and for a plain
    tensor, so model code can place constraints without caring where it
    runs."""
    ctx = current_mesh_rules()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements_for(spec_for(tuple(axes), tuple(x.shape), mesh, rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)

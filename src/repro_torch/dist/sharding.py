"""Logical-axis sharding rules: declarative FSDP / TP placement, the port
of the reference's ``dist/sharding.py`` onto DTensor.

Models declare *logical* axis names on every parameter and activation
(``ParamSpec.axes``); a ``ShardingRules`` maps each logical axis to an
ordered list of candidate mesh axes. ``spec_for`` resolves one shape against
one mesh:

* first candidate mesh axis that exists on the mesh, has size > 1, is not
  already used by an earlier dimension of the same tensor, and divides the
  dimension evenly wins;
* otherwise the dimension is replicated (``None``);
* trailing ``None`` entries are trimmed so fully-replicated tensors get the
  canonical empty spec.

``spec_for`` returns the reference's ``PartitionSpec`` entries as a tuple:
one mesh-axis name or ``None`` per tensor dimension. DTensor places a
tensor the other way round, one placement per MESH dimension;
``placements_for`` turns the entries into that form (``Shard(tensor_dim)``
where a mesh axis shards a dimension, ``Replicate()`` elsewhere).

Rule sets are registered in ``RULESETS`` by name so CLIs (dryrun --rules)
can select placement policies without code changes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

# Default placement: FSDP over the "data" axis (params' embed dim), tensor
# parallelism over the "model" axis (vocab / mlp hidden / heads). Sequence
# and cache axes stay replicated unless a specialised rule set shards them.
_DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("data",),
    "embed": ("data",),
    "mlp": ("model",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "experts": ("model",),
    "d_state": ("model",),
    "d_inner": ("model",),
    "conv": ("model",),
}


@dataclass(frozen=True)
class ShardingRules:
    """A named logical-axis -> candidate-mesh-axes mapping."""

    name: str = "default"
    rules: Mapping[str, tuple[str, ...]] = field(
        default_factory=lambda: dict(_DEFAULT_RULES)
    )

    def candidates(self, axis: Optional[str]) -> tuple[str, ...]:
        if axis is None:
            return ()
        return tuple(self.rules.get(axis, ()))

    # ------------------------------------------------------- named variants
    @classmethod
    def default(cls) -> "ShardingRules":
        return cls()

    @classmethod
    def long_context(cls) -> "ShardingRules":
        """500k-token shapes: the KV/SSM cache shards along its sequence
        axis over "data" (the cache dominates memory; weights stay FSDP)."""
        return cls(
            "long",
            {**_DEFAULT_RULES, "cache_seq": ("data",), "seq": ("data",)},
        )

    @classmethod
    def decode_seq(cls) -> "ShardingRules":
        """Flash-decode cache sharding for GQA decode shapes: the cache
        sequence axis shards over "data" so per-step attention reads are
        local; heads keep the default TP placement."""
        return cls("decode_seq", {**_DEFAULT_RULES, "cache_seq": ("data",)})

    @classmethod
    def decode_tp(cls) -> "ShardingRules":
        """Pure tensor-parallel decode: heads/mlp over "model", everything
        sequence-like replicated (latency-optimal at small batch)."""
        return cls("decode_tp", {**_DEFAULT_RULES, "cache_seq": ()})

    @classmethod
    def decode_2d_tp(cls) -> "ShardingRules":
        """2D decode: head-like axes may fall back to "data" when "model"
        is exhausted by an earlier dimension of the same tensor."""
        over = {
            ax: ("model", "data")
            for ax in ("heads", "kv_heads", "mlp", "vocab")
        }
        return cls("decode_2d_tp", {**_DEFAULT_RULES, **over})


RULESETS = {
    "default": ShardingRules.default,
    "long": ShardingRules.long_context,
    "decode_seq": ShardingRules.decode_seq,
    "decode_tp": ShardingRules.decode_tp,
    "decode_2d_tp": ShardingRules.decode_2d_tp,
}


def _mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(tuple(mesh.mesh_dim_names), tuple(mesh.shape)))


def spec_for(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[ShardingRules] = None,
) -> tuple[Optional[str], ...]:
    """Resolve logical axes against a mesh: the single placement oracle.

    Returns the entries of the reference's ``PartitionSpec``: one mesh-axis
    name or ``None`` per tensor dimension, trailing ``None``s trimmed."""
    rules = rules or ShardingRules()
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    entries: list[Optional[str]] = []
    for ax, dim in zip(axes, shape):
        choice = None
        for cand in rules.candidates(ax):
            n = sizes.get(cand, 0)
            if n > 1 and cand not in used and dim > 1 and dim % n == 0:
                choice = cand
                used.add(cand)
                break
        entries.append(choice)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def placements_for(entries: Sequence[Optional[str]], mesh) -> tuple:
    """``spec_for``'s entries -> one DTensor placement per mesh dimension:
    ``Shard(d)`` on the mesh axis that shards tensor dimension ``d``,
    ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(entries):
        if ax is not None:
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], entries: Sequence[Optional[str]],
                mesh) -> tuple[int, ...]:
    """The shape of one device's shard under ``spec_for``'s entries (every
    sharded dimension divides evenly, as ``spec_for`` guarantees)."""
    sizes = _mesh_sizes(mesh)
    out = list(shape)
    for d, ax in enumerate(entries):
        if ax is not None:
            out[d] //= sizes[ax]
    return tuple(out)

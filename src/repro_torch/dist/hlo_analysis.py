"""Roofline terms of one traced step, the port of the reference's
``dist/hlo_analysis.py``: the same names (``Roofline``,
``CollectiveStats``, ``collective_stats``, ``cost_analysis_terms``), read
from a torch trace of the step instead of from XLA's compiled HLO.

Three per-device cost terms bound a step:

* compute     — FLOPs / peak FLOPs
* memory      — HBM bytes accessed / HBM bandwidth
* collective  — wire bytes moved by collectives / interconnect bandwidth

``StepTrace`` is a dispatch mode that sees every op one device runs: as
``torch.distributed.tensor.debug.CommDebugMode`` does, it declines
DTensor-level calls so that DTensor lowers each op to its local op and
its collectives first (``CommDebugMode`` counts those collectives; the
wire bytes also need each one's result bytes and group size, which this
mode records), and it skips the global-shape ops DTensor runs only to
infer output shapes. For each local op it counts

* FLOPs with the formulas of ``torch.utils.flop_counter.FlopCounterMode``
  (its registry: matrix products, attention, convolutions);
* HBM bytes as the bytes of the op's tensor operands and results (a view
  moves none), the counterpart of XLA's "bytes accessed" for a program
  that runs op by op, with nothing fused;
* collectives (``torch.distributed``'s functional collectives, which
  DTensor's redistributions emit) with their result bytes and group
  size, and the wire bytes of the reference's ring conventions
  (per-device bytes on the wire, group size g):

      all-gather          result_bytes * (g-1)/g
      reduce-scatter      result_bytes * (g-1)     (result is the shard)
      all-reduce          result_bytes * 2(g-1)/g  (RS + AG phases)
      all-to-all          result_bytes * (g-1)/g
      collective-permute  result_bytes

and the peak of the bytes the step's tensors hold at once (each result's
storage from its op until it is freed).

The peaks are an H100 SXM's data-sheet figures, per GPU: 989 TFLOP/s bf16
dense tensor-core compute, 3.35 TB/s HBM3, and 450 GB/s per direction of
NVLink 4, which an NVLink Switch System keeps between any two GPUs of a
256-GPU pod (so the pod mesh's axes all run at that rate).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field

PEAK_FLOPS = 989e12    # H100 SXM, bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12       # H100 SXM, HBM3 bytes/s
ICI_BW = 450e9         # H100 SXM, NVLink 4 bytes/s per direction per GPU

_FUNCOL = {             # torch.distributed functional collective -> HLO name
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


def _wire_bytes(op: str, result_bytes: int, g: int) -> int:
    if op == "all-reduce":
        return result_bytes * 2 * (g - 1) // g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "collective-permute":
        return result_bytes
    # all-gather / all-to-all
    return result_bytes * (g - 1) // g


@dataclass
class CollectiveStats:
    count: int = 0
    by_op: dict = field(default_factory=dict)
    schedule: list = field(default_factory=list)  # [(op, wire_bytes), ...]

    @property
    def total_bytes(self) -> int:
        return sum(self.by_op.values())


def collective_stats(trace: "StepTrace") -> CollectiveStats:
    """Per-device collective wire bytes of a traced step, in the order run."""
    st = CollectiveStats()
    for op, result_bytes, g in trace.collectives:
        b = _wire_bytes(op, result_bytes, g)
        st.count += 1
        st.by_op[op] = st.by_op.get(op, 0) + b
        st.schedule.append((op, b))
    return st


def cost_analysis_terms(trace: "StepTrace") -> tuple[float, float]:
    """(flops, hbm_bytes) per device of a traced step."""
    return float(trace.flops), float(trace.hbm_bytes)


# ------------------------------------------------------------------ trace
_inside = threading.local()           # set while DTensor infers shapes


@contextlib.contextmanager
def _shape_inference_marked():
    """Mark DTensor's shape inference (it runs each op once more at global
    shapes, on fake tensors) so ``StepTrace`` leaves it out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, op_schema):
        _inside.depth = getattr(_inside, "depth", 0) + 1
        try:
            return orig(self, op_schema)
        finally:
            _inside.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    if names:
        return dist.get_world_size(_resolve_process_group(names[-1]))
    sizes = [a for a in args if isinstance(a, int)]
    return sizes[0] if sizes else 1


class StepTrace:
    """``with StepTrace() as tr: step(...)`` — the per-device FLOPs, HBM
    bytes, collectives and peak tensor bytes of what ran (module
    docstring)."""

    def __init__(self):
        self.flops = 0
        self.hbm_bytes = 0
        self.ops = 0
        self.collectives: list[tuple[str, int, int]] = []   # (op, result bytes, g)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._mode = None
        self._stack = None

    def _freed(self, n: int) -> None:
        self.live_bytes -= n

    def _record(self, func, args, kwargs, out) -> None:
        import torch

        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            op = _FUNCOL.get(packet.__name__)
            if op is not None:
                res = sum(_nbytes(t) for t in _tensors(out))
                self.collectives.append((op, res, _group_size(func, args)))
            return
        self.ops += 1
        reg = self._registry
        if packet in reg:
            self.flops += reg[packet](*args, **kwargs, out_val=out)
        rets = func._schema.returns
        view = bool(rets) and rets[0].alias_info is not None and not rets[0].alias_info.is_write
        if view:
            return
        self.hbm_bytes += sum(_nbytes(t) for t in _tensors(args))
        self.hbm_bytes += sum(_nbytes(t) for t in _tensors(kwargs.get("out", ())))
        for t in _tensors(out):
            n = _nbytes(t)
            self.hbm_bytes += n
            if rets and rets[0].alias_info is None and isinstance(t, torch.Tensor):
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(t, self._freed, n)

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode

        trace = self
        self._registry = FlopCounterMode().flop_registry

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented      # DTensor lowers it to local ops
                out = func(*args, **kwargs)
                if not getattr(_inside, "depth", 0):
                    trace._record(func, args, kwargs, out)
                return out

        self._stack = contextlib.ExitStack()
        self._stack.enter_context(_shape_inference_marked())
        self._mode = self._stack.enter_context(_Mode())
        return self

    def __exit__(self, *exc):
        self._stack.close()
        return False


@dataclass
class Roofline:
    """Per-device roofline: which term bounds the step and by how much."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    model_flops: float = 0.0  # useful (model-math) FLOPs, for MFU

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_frac(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_frac(self) -> float:
        """MFU upper bound: useful-compute time / roofline-bound time."""
        if not self.bound_s:
            return 0.0
        return (self.model_flops / PEAK_FLOPS) / self.bound_s

    def to_json(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound_s": self.bound_s,
            "dominant": self.dominant,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }

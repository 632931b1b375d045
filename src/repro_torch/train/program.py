"""The training step compiled once per program identity: the port's
counterpart of the reference's AOT-compiled step executable.

The reference's ``Trainer._startup`` lowers its jitted step and compiles
it through ``CompileCache.get_or_compile``; the executable holds no weight
values, so one key serves every start of an epoch. Here the compiled form
on the card is a CUDA graph of one step: the kernels the step launches,
recorded once over buffers at fixed addresses and replayed with no
Python, autograd or DTensor dispatch. Its "no weight values" becomes "no
world in the program": the buffers are the program's own, and each start
puts its world into them (a table-driven load into the program's arena,
``core/device_arena.py``; on a mesh larger than one device, a copy of
each rank's shards).

``LoweredStep(step_fn, params, opt_state, batch, device=...)`` is the
lowered form (``lower_fn``'s result): the step, the state it trains in
place, and static input buffers shaped and typed as ``batch``.
``LoweredStep.compile()`` is the compiled ``StepProgram``:

* on CUDA, one warm-up step on a side stream (cuBLAS's workspaces, the
  rmsnorm backward's per-stream ticket and partials, NCCL's communicator
  all exist before capture), run on a snapshot of the state that is put
  back after it, so compiling trains nothing and each step of a run
  appears once in its losses; then the cached blocks go back and one step
  is captured into a ``torch.cuda.CUDAGraph`` with a private memory pool
  on the same side stream. A step that cannot be captured raises
  ``CaptureError``: nothing runs the step eagerly instead;
* on the CPU (only where the caller asked for it), the same step run
  eagerly over the same buffers.

``program(params, opt_state, batch)`` copies ``batch`` into the static
buffers, replays the graph (or runs the step) and returns the program's
state and the step's metrics (static tensors on CUDA, rewritten by each
replay). ``params`` and ``opt_state`` must be the program's own.

Launch accounting: a replay runs no wrapper, so the program records the
launches its capture made (per kernel and per rmsnorm backward route) and
credits them at each replay; the warm-up's launches and the capture's are
taken back from the counters (``kernels.counter_snapshot``), so the
counters stay counts of the launches of the run's steps.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import torch

from repro_torch.dist.context import is_dtensor


class CaptureError(RuntimeError):
    """The training step could not be captured as a CUDA graph."""


def _local(t: torch.Tensor) -> torch.Tensor:
    """The plain tensor that holds ``t``'s bytes on this rank (no grad)."""
    return (t.to_local() if is_dtensor(t) else t).detach()


def state_leaves(params: dict, opt_state: dict) -> dict:
    """Every tensor of the state a step trains in place, by name: the
    params, ``m/<name>``, ``v/<name>`` and ``step``."""
    return {**params, **{f"m/{n}": t for n, t in opt_state["m"].items()},
            **{f"v/{n}": t for n, t in opt_state["v"].items()}, "step": opt_state["step"]}


def state_tensors(params: dict, opt_state: dict) -> list:
    """``state_leaves``' tensors as the plain tensors that hold each one's
    bytes on this rank."""
    return [_local(t) for t in state_leaves(params, opt_state).values()]


class LoweredStep:
    """``step_fn(params, opt_state, batch) -> (params, opt_state, metrics)``,
    which updates the state in place, lowered over that state and static
    buffers copied from ``batch``. ``image`` is the device image whose
    arena holds the state (None where each rank holds copies of its
    shards); a restart loads into it."""

    def __init__(self, step_fn: Callable, params: dict, opt_state: dict, batch: dict,
                 *, device, image=None):
        self.step_fn = step_fn
        self.params, self.opt_state = params, opt_state
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.image = image
        self.batch = {k: v.to(self.device, copy=True) for k, v in batch.items()}

    def compile(self) -> "StepProgram":
        if self.device.type == "cuda":
            return _capture(self)
        return StepProgram(self, graph=None, metrics=None)


class StepProgram:
    """A compiled step (``LoweredStep.compile``): call it as the step."""

    def __init__(self, lowered: LoweredStep, *, graph, metrics: Optional[dict],
                 credit: Optional[dict] = None, stats: Optional[dict] = None,
                 stream=None, scratch: Optional[tuple] = None):
        self.step_fn = lowered.step_fn
        self.params, self.opt_state = lowered.params, lowered.opt_state
        self.batch, self.image, self.device = lowered.batch, lowered.image, lowered.device
        self.graph, self.metrics = graph, metrics
        self.compiled_as = "eager" if graph is None else "cuda_graph"
        self.credit = credit or {}          # launches a replay makes
        self.stats = {"compiled_as": self.compiled_as, **(stats or {})}
        self.replays = 0
        # the capture's stream, and the rmsnorm tma backward's (ticket,
        # partials) for it: the graph reads their addresses, so the program
        # keeps them alive; the ticket is 0 between replays
        self.stream, self.scratch = stream, scratch

    def __call__(self, params: dict, opt_state: dict, batch: dict):
        if params is not self.params or opt_state is not self.opt_state:
            raise ValueError("a compiled step trains its own state: pass the program's "
                             "params and opt_state")
        for k, buf in self.batch.items():
            buf.copy_(batch[k])
        if self.graph is None:
            _, _, metrics = self.step_fn(self.params, self.opt_state, self.batch)
            return self.params, self.opt_state, metrics
        from repro_torch.kernels import credit_launches

        self.graph.replay()
        credit_launches(self.credit)
        self.replays += 1
        return self.params, self.opt_state, self.metrics

    def load_state(self, params: dict, opt_state: dict) -> None:
        """Copy a loaded state (whole tensors, the same on every rank) into
        the program's: each leaf's local shard at its placements. A
        restart on a mesh larger than one device does this; one on a
        single device loads into ``image`` instead."""
        from torch.distributed.tensor import distribute_tensor

        mine, new = state_leaves(self.params, self.opt_state), state_leaves(params, opt_state)
        if mine.keys() != new.keys():
            raise ValueError("the loaded state's names differ from the program's")
        with torch.no_grad():
            for n, dst in mine.items():
                src = new[n].detach()
                if is_dtensor(dst):
                    src = distribute_tensor(src, dst.device_mesh, dst.placements,
                                            src_data_rank=None).to_local()
                _local(dst).copy_(src.reshape(_local(dst).shape))


def _capture(lowered: LoweredStep) -> StepProgram:
    """Warm up on a snapshot, then capture one step (module docstring)."""
    from repro_torch.kernels import counter_snapshot, set_counters
    from repro_torch.kernels.rmsnorm import ops as rn

    dev = lowered.device
    args = (lowered.params, lowered.opt_state, lowered.batch)
    before = counter_snapshot()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    t0 = time.perf_counter()
    state = state_tensors(lowered.params, lowered.opt_state)
    with torch.cuda.stream(side):
        with torch.no_grad():
            saved = [t.clone() for t in state]
        lowered.step_fn(*args)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
    side.synchronize()
    del saved
    set_counters(before)
    warmup_s = time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()              # the warm-up's blocks, before the pool
    reserved = torch.cuda.memory_reserved(dev)
    graph = torch.cuda.CUDAGraph()
    t1 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, stream=side):
            _, _, metrics = lowered.step_fn(*args)
    except Exception as e:                # capture refused an op of the step
        set_counters(before)
        raise CaptureError(f"the training step cannot be captured as a CUDA graph: "
                           f"{type(e).__name__}: {e}") from e
    torch.cuda.current_stream(dev).wait_stream(side)
    capture_s = time.perf_counter() - t1
    after = counter_snapshot()
    set_counters(before)
    credit = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    stats = {"warmup_s": warmup_s, "capture_s": capture_s,
             "pool_bytes": torch.cuda.memory_reserved(dev) - reserved,
             "launches_a_replay": {"/".join(str(p) for p in k if p is not None): n
                                   for k, n in credit.items()}}
    return StepProgram(lowered, graph=graph, metrics=metrics, credit=credit, stats=stats,
                       stream=side,
                       scratch=rn._bwd_scratch_by.get((dev.index, side.cuda_stream)))

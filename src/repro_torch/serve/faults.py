"""Fault-injection hooks for the serving stack (the chaos tier's knobs).

Production code calls two narrow hooks — ``on_adopt_reload()`` at the
start of every epoch reload and ``on_decode_step(k)`` before every batched
decode dispatch — and both are no-ops unless a test or benchmark installed
a :class:`FaultPlan` in this process first. The plan travels to fleet
workers as a plain dict through the spawn args (``run_traffic(...,
faults={...})``), so the spawn context never has to pickle anything
fancier than what ``dataclasses.asdict`` emits.

Three faults cover the failure modes the rollover-hardening tier must
survive:

* ``wedge_adopt_s`` — the reload inside ``engine.adopt_epoch`` hangs for
  this many seconds. Paired with ``adopt_epoch(deadline_s=...)`` it is
  the wedged-flip scenario: the deadline fires, the engine auto-rolls
  back, and admission resumes on the still-live generation.
* ``slow_reload_s`` — every epoch reload takes this much longer, without
  wedging. Exercises the deadline margin rather than the rollback path.
* ``die_at_step`` — the process SIGKILLs *itself* at the Nth decode
  dispatch (1-based). No atexit, no cleanup, no goodbye frame: exactly
  what a kernel OOM-kill looks like to the dispatcher, which must notice
  via the response ring's dead owner pid and respawn.
* ``dup_stream_every`` — every Nth streamed PARTIAL frame is pushed
  twice (``on_stream_frame``), forcing the dispatcher's seq-keyed
  reassembly to prove it is idempotent under at-least-once delivery.

``worker`` restricts a plan to one fleet worker index (``-1`` = any), so
a chaos run can kill worker 0 while workers 1..N-1 prove the re-route
path. Respawned workers are handed no plan — they must survive.

:class:`StoreFaultPlan` is the network-side analogue for the
served arena store (``repro_torch.launch.store``). It is consumed server-side
by the store's request handler rather than through the process-global
hooks above, so a chaos test can break the wire while the fetching
process under test runs entirely fault-free code.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import asdict, dataclass


@dataclass
class FaultPlan:
    """What to break, and where."""

    wedge_adopt_s: float = 0.0   # hang the adopt-epoch reload this long
    slow_reload_s: float = 0.0   # slow every epoch reload by this much
    die_at_step: int = 0         # SIGKILL self at decode dispatch N (0=off)
    dup_stream_every: int = 0    # re-push every Nth PARTIAL frame (0=off)
    worker: int = -1             # fleet worker index this applies to (-1=any)

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class StoreFaultPlan:
    """Network faults for the served arena store (the store chaos tier).

    Consumed by ``repro_torch.launch.store.StoreServer``: the handler consults
    the plan per request and mutates the wire, never the bytes on disk —
    the store's own content is always intact, which is exactly why the
    client-side verification has to be what protects the fleet.

    * ``refuse_n`` — drop the first N connections without an HTTP
      response (reader sees a reset: the refused-connect mode).
    * ``flap_every`` — refuse every k-th request forever (flapping
      server; retries must converge anyway).
    * ``truncate_at``/``truncate_n`` — close the stream after byte k of
      the payload, for the first N blob requests (mid-stream truncation;
      the client must RESUME via a range read, not restart).
    * ``flip_at``/``flip_n`` — flip one payload byte at offset k for the
      first N blob requests (corruption in transit; the client must
      quarantine, never admit).
    * ``stall_s``/``stall_n`` — sleep this long mid-stream for the first
      N blob requests (slow-loris; the client's read timeout must fire).
    * ``down_after`` — serve N requests, then refuse everything (the
      store dies mid-warmup; warmup must degrade, not wedge). -1 = never.
    """

    refuse_n: int = 0
    flap_every: int = 0
    truncate_at: int = -1
    truncate_n: int = 0
    flip_at: int = -1
    flip_n: int = 0
    stall_s: float = 0.0
    stall_n: int = 0
    down_after: int = -1

    def to_dict(self) -> dict:
        return asdict(self)


_ACTIVE: FaultPlan | None = None


def install(plan: "FaultPlan | dict | None") -> FaultPlan | None:
    """Arm ``plan`` for this process (dicts are coerced; None disarms)."""
    global _ACTIVE
    if plan is None:
        _ACTIVE = None
    elif isinstance(plan, FaultPlan):
        _ACTIVE = plan
    else:
        _ACTIVE = FaultPlan(**dict(plan))
    return _ACTIVE


def install_for_worker(plan: "dict | FaultPlan | None", widx: int):
    """Arm ``plan`` only if it targets fleet worker ``widx`` (or any)."""
    if plan is None:
        return None
    p = plan if isinstance(plan, FaultPlan) else FaultPlan(**dict(plan))
    if p.worker not in (-1, widx):
        return None
    return install(p)


def active() -> FaultPlan | None:
    return _ACTIVE


def clear() -> None:
    install(None)


# ------------------------------------------------------------------ hooks
def on_adopt_reload() -> None:
    """Called at the start of every normal adopt-epoch reload (the abort
    path bypasses this hook deliberately).

    The wedge is ONE-SHOT: after firing it disarms itself. A rollback
    lands as a new generation, which the serve loop adopts through this
    same path — a wedge that re-fired there would deadline the rollback's
    own adoption and livelock the fleet in a rollback loop. One-shot
    models the transient wedge the deadline machinery exists to survive;
    ``slow_reload_s`` stays armed (a persistently slow reload is a
    different, steady-state fault).
    """
    p = _ACTIVE
    if p is None:
        return
    if p.wedge_adopt_s > 0:
        wedge, p.wedge_adopt_s = p.wedge_adopt_s, 0.0
        time.sleep(wedge)
    if p.slow_reload_s > 0:
        time.sleep(p.slow_reload_s)


def on_stream_frame(frame_index: int) -> bool:
    """Called per PARTIAL frame a worker pushes (1-based). True = push the
    frame AGAIN — duplicate delivery, which the dispatcher's seq-keyed
    reassembly must absorb idempotently (at-least-once is the honest
    delivery contract once re-routes can replay a request's stream)."""
    p = _ACTIVE
    if p is None or not p.dup_stream_every:
        return False
    return frame_index % p.dup_stream_every == 0


def on_decode_step(step_index: int) -> None:
    """Called before batched decode dispatch ``step_index`` (1-based).

    ``die_at_step`` uses SIGKILL on purpose: a worker that gets to run
    cleanup is not the failure mode the supervisor has to handle.
    """
    p = _ACTIVE
    if p is None or not p.die_at_step:
        return
    if step_index >= p.die_at_step:
        os.kill(os.getpid(), signal.SIGKILL)

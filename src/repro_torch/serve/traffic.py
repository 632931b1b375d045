"""The traffic plane: Poisson load over shm rings into a serving fleet.

The port of the reference's ``serve/traffic.py``. Topology: one front-end
dispatcher process and N workers, each worker owning a private ring pair
(``repro_torch.core.shm_ring``) —

    dispatcher --- <session>/req/<i> --->  worker i   (dispatcher-owned)
    dispatcher <-- <session>/rsp/<i> ----  worker i   (worker-owned)

so every shared cursor has exactly one writer and the whole request path is
two fixed-slot shm copies, no pipes, no pickling on the hot path. Ring
ownership is split deliberately: a SIGKILLed dispatcher leaves request
rings with a dead owner pid, a SIGKILLed worker leaves its response ring
with a dead owner pid — either way the next ``ws.gc()`` reclaims the
segment (``core.shm_arena.gc_segments``).

Each worker loads the app through the stable-linking epoch path (default
``stable-shm``: one physical arena copy machine-wide, copied to the device;
``stable`` builds the arena on the device with the ``paged_reloc_copy``
kernel), builds a ``ServeEngine`` on ``device`` (``"cuda"`` unless the
caller asks for the CPU; no fallback), and runs ``engine.serve_loop`` —
the continuous-batching scheduler — with its rings as source and sink. The
dispatcher drives Poisson arrivals (draining the response rings while it
waits to send; the reference sleeps through each gap, ROADMAP Queue C),
round-robins requests across workers (ring-full = backpressure, surfaced
as a routing decision and counted in ``stalls``), and measures sustained
req/s, tok/s and p50/p99 end-to-end latency on the *dispatcher's* clock
(the enqueue time rides the wire and comes back in the completion;
``time.monotonic()`` is system-wide).

Wire format, byte for byte the reference's (fixed little-endian structs +
int32 token payloads):

    request    <qiiddi> rid, max_new, n_tokens, enqueued_ts, deadline_s,
               priority + tokens (deadline_s: seconds from enqueue; 0 =
               none; enqueued_ts: the dispatcher's time.monotonic() stamp,
               NaN = no dispatcher clock)
    completion <qiiddd> rid, status, n_tokens, admitted, finished,
               enqueued + tokens (status: 0 ok, 1 DEADLINE — expired, with
               its partial row; 2 PARTIAL — a streamed token span whose
               ``admitted`` field carries the span's starting seq)
    rid sentinels: -1 STOP (drain and exit), -2 worker READY (payload =
    spin-up seconds), -3 worker ERROR (payload = utf-8 traceback excerpt),
    -4 worker ADOPTED (blue/green flip complete; payload = JSON {worker,
    epoch_gen, digest}, digest = ``tensors_digest`` of what the worker now
    serves, the reference's blake2b-16 over the raw bytes).

**Streaming** (``stream=True``): every decoded token leaves as a PARTIAL
frame the step it is sampled (the prefill token as seq 0). The dispatcher
reassembles spans by seq (idempotent under duplicate delivery), records
time-to-first-token, and checks the reassembly against the completion
frame's row (``stream_gaps``, ``stream_dup_frames``,
``stream_mismatches``).

**MPMC rings** (``mpmc=True``): request rings in ``shm_ring``'s
multi-producer mode (bakery-locked claim cursor) instead of SPSC.

**Supervision** (``supervise=True``): a worker that dies — SIGKILL
included — is detected through its response ring's owner record; its
in-flight requests are re-routed to survivors (the retained frame carries
the ORIGINAL enqueue time) and it is respawned with capped exponential
backoff onto the SAME request ring. Completions are deduped by rid.
Respawned workers get no fault plan. A supervised drive sends its STOP
frames only after the last completion: the reference sends them right
after the last request, so a request re-routed in the tail can queue
behind a STOP and never be served (ROADMAP Queue C).

**Blue/green rollover under load** (``rollover_at``/``rollover_fn``):
after request ``rollover_at`` is sent, the dispatcher runs ``rollover_fn``
synchronously (a commit of generation N+1; the dispatcher drains nothing
meanwhile, so latencies in the flip window include the commit's wall
time). Each worker notices the commit via ``ws.epoch_watch()``, lets
in-flight slots finish, flips via ``engine.adopt_epoch`` at the empty
request boundary and pushes its ADOPTED frame.

**Worker statistics** (port only; the wire stays the reference's): at a
clean exit each worker writes ``worker-<index>-<pid>.json`` into
``<ws.root>/traffic/<session>/`` — its kernel launch counts
(``repro_torch.kernels.launch_counts``), its ``ServeLoopReport.summary()``,
its spin-up time, the process's CPU seconds inside the serve loop, each
flip's reload and digest seconds, the generation that served each rid
(``served_gen``) and its peak device memory. The dispatcher reads them
after ``join`` into ``TrafficReport.worker_stats`` and removes the
directory. A killed worker leaves none.

**Token ids**: prompts are drawn from ``[0, min(32000, vocab_size))``; the
reference draws from ``[0, 32000)`` whatever the vocabulary. A worker
refuses an out-of-range id on the host (``ValueError`` from the
scheduler's admission), which comes back as an ERROR frame.
"""

from __future__ import annotations

import json
import math
import multiprocessing as mp
import shutil
import struct
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.shm_arena import tensors_digest
from repro_torch.core.shm_ring import ShmRing, ShmRingError, ring_owner_alive

# rid, max_new, n_toks, enqueued (NaN = no clock), deadline, priority
_REQ_HDR = struct.Struct("<qiiddi")
_RSP_HDR = struct.Struct("<qiiddd")  # rid, status, n_toks, admitted, fin, enq
_ST_OK = 0
_ST_DEADLINE = 1
_ST_PARTIAL = 2                      # streamed span; `admitted` carries seq
_STATUS_NAMES = {_ST_OK: "ok", _ST_DEADLINE: "deadline",
                 _ST_PARTIAL: "partial"}
_STATUS_CODES = {v: k for k, v in _STATUS_NAMES.items()}
_RID_STOP = -1
_RID_READY = -2
_RID_ERROR = -3
_RID_ADOPTED = -4                        # worker flipped to a new epoch_gen
_RID_WARM = 1 << 40                      # rids >= this are warmup traffic

RING_SLOTS = 64                          # per ring; queue depth per worker
PROMPT_VOCAB_CAP = 32000                 # the reference's prompt draw bound


# ------------------------------------------------------------------- wire
def encode_request(rid: int, prompt: np.ndarray, max_new: int,
                   enqueued_ts: float | None, deadline_s: float = 0.0,
                   priority: int = 0) -> bytes:
    toks = np.ascontiguousarray(prompt, dtype="<i4")
    enq = math.nan if enqueued_ts is None else enqueued_ts
    return (
        _REQ_HDR.pack(rid, max_new, toks.size, enq, deadline_s, priority)
        + toks.tobytes()
    )


def decode_request(data: bytes):
    rid, max_new, n, enq, deadline, priority = _REQ_HDR.unpack_from(data)
    if rid == _RID_STOP:
        return rid, None, 0, None, 0.0, 0
    toks = np.frombuffer(data, dtype="<i4", count=n, offset=_REQ_HDR.size)
    enq = None if math.isnan(enq) else enq
    return rid, toks.astype(np.int32), max_new, enq, deadline, priority


def encode_completion(rid: int, tokens: np.ndarray, admitted: float,
                      finished: float, enqueued: float | None,
                      status: str = "ok") -> bytes:
    toks = np.ascontiguousarray(tokens, dtype="<i4")
    enq = math.nan if enqueued is None else enqueued
    return (
        _RSP_HDR.pack(
            rid, _STATUS_CODES.get(status, _ST_OK), toks.size,
            admitted, finished, enq,
        )
        + toks.tobytes()
    )


def encode_partial(rid: int, seq: int, tokens, ts: float = 0.0) -> bytes:
    """One streamed span: tokens at positions seq..seq+len-1 of rid's
    continuation. The seq rides the `admitted` field (exact for any seq a
    ring could carry), the worker's push stamp rides `finished`."""
    toks = np.ascontiguousarray(tokens, dtype="<i4")
    return (
        _RSP_HDR.pack(rid, _ST_PARTIAL, toks.size, float(seq), ts, math.nan)
        + toks.tobytes()
    )


def _encode_blob(rid: int, blob: bytes, value: float = 0.0) -> bytes:
    return _RSP_HDR.pack(rid, _ST_OK, len(blob), value, 0.0, 0.0) + blob


def decode_completion(data: bytes):
    rid, status, n, admitted, finished, enq = _RSP_HDR.unpack_from(data)
    if rid < 0:
        blob = data[_RSP_HDR.size:_RSP_HDR.size + n]
        return rid, blob, admitted, 0.0, 0.0, "ok"
    toks = np.frombuffer(data, dtype="<i4", count=n, offset=_RSP_HDR.size)
    name = _STATUS_NAMES.get(status, "ok")
    enq = None if math.isnan(enq) else enq
    return rid, toks.astype(np.int32), admitted, finished, enq, name


def _push_blocking(ring: ShmRing, data: bytes, *, timeout: float) -> None:
    deadline = time.monotonic() + timeout
    while not ring.push(data):
        if time.monotonic() >= deadline:
            raise ShmRingError(
                f"ring {ring.name} stayed full for {timeout:.0f}s"
            )
        time.sleep(0.0005)


def req_channel(session: str, widx: int) -> str:
    return f"{session}/req/{widx}"


def rsp_channel(session: str, widx: int) -> str:
    return f"{session}/rsp/{widx}"


def ring_slot_bytes(prompt_len: int, max_new: int) -> int:
    """One slot must hold the largest frame either direction carries."""
    return max(
        _REQ_HDR.size + 4 * prompt_len,
        _RSP_HDR.size + 4 * max_new,
        _RSP_HDR.size + 2048,            # error tracebacks
    )


# ----------------------------------------------------------------- worker
def _traffic_worker(
    root,
    app_name: str,
    arch: str,
    strategy: str,
    session: str,
    widx: int,
    cache_len: int,
    max_batch: int,
    max_new_cap: int,
    slot_bytes: int,
    stats_dir: str,
    fault_plan: dict | None = None,
    adopt_deadline_s: float = 0.0,
    stream: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    sampling_seed: int = 0,
    device: str = "cuda",
    smoke: bool = True,
) -> None:
    """One serving worker: epoch-path engine + serve_loop over the rings.

    Module-level so the spawn context can pickle it. The response ring is
    created FIRST (before the expensive engine build) so the dispatcher's
    attach never races the engine's start; READY (with the spin-up time as
    payload) is pushed only after the engine exists. Any failure — a
    missing card for ``device="cuda"`` included — is pushed as an ERROR
    frame before re-raising, so the dispatcher learns the traceback the
    moment the process dies instead of at join timeout.

    ``fault_plan`` is a ``faults.FaultPlan`` as a dict (spawn-picklable);
    it arms only if its ``worker`` field matches ``widx`` (or is -1).
    ``adopt_deadline_s > 0`` bounds every blue/green flip. ``stats_dir``
    receives this worker's statistics file at a clean exit, with the
    generation that served each request (``served_gen``).
    """
    import os
    import traceback as _tb

    from repro_torch.kernels import launch_counts
    from repro_torch.link import Workspace

    from . import faults
    from .engine import ServeEngine
    from .scheduler import STOP, Request

    started = time.monotonic()
    faults.install_for_worker(fault_plan, widx)
    ws = Workspace.open(root)
    rsp = ShmRing.create(
        ws.registry, rsp_channel(session, widx),
        slots=RING_SLOTS, slot_bytes=slot_bytes,
    )
    try:
        t0 = time.monotonic()
        cfg = get_config(arch, smoke=smoke)
        engine = ServeEngine.from_workspace(
            cfg, ws, app_name, strategy=strategy, cache_len=cache_len,
            device=device,
        )
        req = ShmRing.attach(
            ws.registry, req_channel(session, widx), timeout=60.0
        )
        ready_s = time.monotonic() - t0
        _push_blocking(
            rsp, _encode_blob(_RID_READY, b"", ready_s), timeout=30.0,
        )

        def source():
            data = req.pop()
            if data is None:
                return None
            rid, toks, max_new, enq, deadline, priority = decode_request(data)
            if rid == _RID_STOP:
                return STOP
            return Request(
                rid=rid, prompt=toks, max_new_tokens=max_new,
                enqueued_ts=enq, deadline_s=deadline, priority=priority,
            )

        # the generation this engine serves, and the one each rid was
        # served on (a flip waits for an empty boundary, so a request
        # never spans two)
        gen = [ws.epoch_gen]
        served_gen: dict[int, int] = {}

        def sink(comp):
            served_gen[comp.rid] = gen[0]
            _push_blocking(
                rsp,
                encode_completion(
                    comp.rid, comp.tokens, comp.admitted_ts,
                    comp.finished_ts, comp.enqueued_ts,
                    status=getattr(comp, "status", "ok"),
                ),
                timeout=60.0,
            )

        on_delta = None
        if stream:
            frames_out = 0

            def on_delta(d):
                # every decoded token leaves the moment it is sampled: a
                # PARTIAL frame (rid + seq + span) ahead of the final
                # authoritative completion frame on the same SPSC ring
                nonlocal frames_out
                frames_out += 1
                frame = encode_partial(
                    d.rid, d.seq, list(d.tokens), time.monotonic()
                )
                _push_blocking(rsp, frame, timeout=60.0)
                if faults.on_stream_frame(frames_out):
                    _push_blocking(rsp, frame, timeout=60.0)

        # blue/green: notice sibling commits between requests; flip at an
        # empty request boundary and tell the dispatcher what we now serve
        watch = ws.epoch_watch()
        flips: list[dict] = []

        def on_epoch(change):
            t = time.monotonic()
            try:
                image = engine.adopt_epoch(
                    ws, app_name, strategy=strategy,
                    deadline_s=adopt_deadline_s,
                )
            finally:
                gen[0] = ws.epoch_gen     # a rolled-back flip re-adopts
            reload_s = time.monotonic() - t
            t = time.monotonic()
            digest = tensors_digest(getattr(image, "tensors", None) or {})
            flips.append({"epoch_gen": change.epoch_gen, "reload_s": reload_s,
                          "digest_s": time.monotonic() - t})
            blob = json.dumps(
                {"worker": widx, "epoch_gen": change.epoch_gen,
                 "digest": digest}
            ).encode()
            _push_blocking(rsp, _encode_blob(_RID_ADOPTED, blob), timeout=30.0)

        cpu0 = time.process_time()
        loop = engine.serve_loop(
            source, sink, max_batch=max_batch, max_new_cap=max_new_cap,
            epoch_watch=watch, on_epoch=on_epoch,
            temperature=temperature, top_k=top_k,
            sampling_seed=sampling_seed, on_delta=on_delta,
        )
        dev = engine.device
        stats = {
            "worker": widx,
            "pid": os.getpid(),
            "started_ts": started,
            "device": str(dev),
            "ready_s": ready_s,
            "launches": launch_counts(),
            "serve_loop": loop.summary(),
            "serve_cpu_s": time.process_time() - cpu0,
            "flips": flips,
            "served_gen": {str(r): g for r, g in served_gen.items()},
            "max_memory_allocated": (
                torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None
            ),
        }
        path = Path(stats_dir) / f"worker-{widx}-{os.getpid()}.json"
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(stats))
        os.replace(tmp, path)
        req.close()
        rsp.close()
    except BaseException as e:
        try:
            blob = f"{e!r}\n{_tb.format_exc()}"[-2000:].encode()
            rsp.push(_encode_blob(_RID_ERROR, blob))
            rsp.close()
        except Exception:
            pass
        raise


# ------------------------------------------------------------- dispatcher
@dataclass
class TrafficReport:
    """What one ``run_traffic`` drive actually measured."""

    workers: int
    strategy: str
    arch: str
    rate_hz: float
    sent: int = 0
    completed: int = 0
    tokens_out: int = 0
    stalls: int = 0                     # send attempts deferred (all rings full)
    wall_s: float = 0.0                 # first send -> last completion
    latencies_s: list = field(default_factory=list)
    ready_s: list = field(default_factory=list)   # per-worker spin-up
    worker_errors: list = field(default_factory=list)
    # blue/green rollover (populated when run_traffic rolled mid-load):
    rollover_at: int | None = None      # request index the roll started after
    adoptions: list = field(default_factory=list)  # ADOPTED frames, decoded
    rollover_wall_s: float = 0.0        # commit start -> last worker adopted
    rollover_latencies_s: list = field(default_factory=list)  # during the flip
    steady_latencies_s: list = field(default_factory=list)    # outside it
    # supervision (populated when supervise=True saw a worker die):
    restarts: int = 0                   # workers respawned after death
    rerouted_requests: int = 0          # in-flight requests re-sent elsewhere
    deadline_expired: int = 0           # completions that came back DEADLINE
    kill_latencies_s: list = field(default_factory=list)  # rerouted req e2e
    # streaming (populated when stream=True):
    partial_frames: int = 0             # PARTIAL frames received
    ttft_s: list = field(default_factory=list)   # enqueue -> first PARTIAL
    stream_gaps: int = 0                # seqs missing at completion time
    stream_dup_frames: int = 0          # duplicate spans absorbed (not errors)
    stream_mismatches: int = 0          # reassembly != completion frame row
    stream_tokens: dict = field(default_factory=dict)  # rid -> reassembled
    # port only: each cleanly exited worker's statistics file, in the order
    # of (worker index, start); a killed worker leaves none
    worker_stats: list = field(default_factory=list)
    # port only: seconds each ok completion waited between its worker's
    # finish stamp and the dispatcher's read (the part of a latency that
    # is the dispatcher's, not the fleet's)
    ring_wait_s: list = field(default_factory=list)

    @property
    def failed(self) -> int:
        return len(self.worker_errors)

    def ttft_quantile(self, q: float) -> float:
        if not self.ttft_s:
            return 0.0
        return float(np.percentile(np.asarray(self.ttft_s), q))

    @property
    def ttft_p50_s(self) -> float:
        """Median enqueue -> first streamed token (0.0 off-stream)."""
        return self.ttft_quantile(50.0)

    @property
    def ttft_p99_s(self) -> float:
        """p99 time-to-first-token (a client starts reading at the prefill
        token, not at the last decode step)."""
        return self.ttft_quantile(99.0)

    @property
    def req_per_s(self) -> float:
        return self.completed / self.wall_s if self.wall_s else 0.0

    @property
    def tok_per_s(self) -> float:
        return self.tokens_out / self.wall_s if self.wall_s else 0.0

    def latency_quantile(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_s), q))

    @property
    def p50_s(self) -> float:
        return self.latency_quantile(50.0)

    @property
    def p99_s(self) -> float:
        return self.latency_quantile(99.0)

    def _rollover_quantile(self, q: float) -> float:
        if not self.rollover_latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.rollover_latencies_s), q))

    def steady_quantile(self, q: float) -> float:
        """Latency quantile excluding the rollover window (equals the
        overall quantile when no roll happened)."""
        lats = self.steady_latencies_s or self.latencies_s
        if not lats:
            return 0.0
        return float(np.percentile(np.asarray(lats), q))

    @property
    def steady_p50_s(self) -> float:
        return self.steady_quantile(50.0)

    @property
    def steady_p99_s(self) -> float:
        return self.steady_quantile(99.0)

    @property
    def rollover_p50_s(self) -> float:
        """p50 of completions received while the generation flip was in
        progress (commit issued -> every worker adopted)."""
        return self._rollover_quantile(50.0)

    @property
    def rollover_p99_s(self) -> float:
        """p99 during the flip (commit included: ``rollover_fn`` runs on
        the dispatcher, which drains nothing meanwhile)."""
        return self._rollover_quantile(99.0)

    @property
    def kill_p99_s(self) -> float:
        """p99 end-to-end latency of the requests a worker died holding,
        from the ORIGINAL enqueue (the re-routed frame carries it). 0.0
        when nothing was ever re-routed."""
        if not self.kill_latencies_s:
            return 0.0
        return float(np.percentile(np.asarray(self.kill_latencies_s), 99.0))

    @staticmethod
    def _q(xs: list, q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    def summary(self) -> dict:
        return {
            "workers": self.workers,
            "strategy": self.strategy,
            "arch": self.arch,
            "rate_hz": self.rate_hz,
            "sent": self.sent,
            "completed": self.completed,
            "tokens_out": self.tokens_out,
            "stalls": self.stalls,
            "failed_workers": self.failed,
            "worker_errors": self.worker_errors,
            "wall_s": round(self.wall_s, 4),
            "req_per_s": round(self.req_per_s, 2),
            "tok_per_s": round(self.tok_per_s, 1),
            "p50_latency_s": round(self.p50_s, 4),
            "p99_latency_s": round(self.p99_s, 4),
            "ready_s": [round(r, 3) for r in self.ready_s],
            "rollover_at": self.rollover_at,
            "adoptions": self.adoptions,
            "rollover_wall_s": round(self.rollover_wall_s, 4),
            "rollover_completions": len(self.rollover_latencies_s),
            "rollover_p50_latency_s": round(self.rollover_p50_s, 4),
            "rollover_p99_latency_s": round(self.rollover_p99_s, 4),
            # supervision counters are honest zeros when nothing died
            "restarts": self.restarts,
            "rerouted_requests": self.rerouted_requests,
            "deadline_expired": self.deadline_expired,
            "kill_completions": len(self.kill_latencies_s),
            "kill_p99_latency_s": round(self.kill_p99_s, 4),
            # streaming counters are honest zeros when stream=False
            "partial_frames": self.partial_frames,
            "ttft_p50_s": round(self.ttft_p50_s, 4),
            "ttft_p99_s": round(self.ttft_p99_s, 4),
            "stream_gaps": self.stream_gaps,
            "stream_dup_frames": self.stream_dup_frames,
            "stream_mismatches": self.stream_mismatches,
            "ring_wait_p50_s": round(self._q(self.ring_wait_s, 50.0), 4),
            "ring_wait_max_s": round(max(self.ring_wait_s, default=0.0), 4),
            "worker_stats": self.worker_stats,
        }


def draw_prompts(vocab_size: int, n_requests: int, prompt_len: int,
                 rate_hz: float, seed: int):
    """The dispatcher's draw from ``seed``: prompts with ids in ``[0,
    min(32000, vocab_size))``, then the Poisson inter-arrival gaps."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(
        0, min(PROMPT_VOCAB_CAP, vocab_size), (n_requests, prompt_len),
        dtype=np.int32,
    )
    gaps = rng.exponential(1.0 / max(rate_hz, 1e-9), n_requests)
    return prompts, gaps


def _read_worker_stats(stats_dir: Path) -> list[dict]:
    out = [json.loads(p.read_text()) for p in stats_dir.glob("worker-*.json")]
    return sorted(out, key=lambda s: (s["worker"], s["started_ts"]))


def run_traffic(
    ws,
    app_name: str,
    *,
    arch: str,
    workers: int = 2,
    n_requests: int = 16,
    rate_hz: float = 50.0,
    prompt_len: int = 12,
    max_new_tokens: int = 8,
    max_batch: int = 2,
    strategy: str = "stable-shm",
    cache_len: int = 0,
    seed: int = 0,
    timeout: float = 180.0,
    warmup_per_worker: int = 1,
    session: str | None = None,
    rollover_at: int | None = None,
    rollover_fn=None,
    request_deadline_s: float = 0.0,
    adopt_deadline_s: float = 0.0,
    supervise: bool = False,
    faults: dict | None = None,
    stream: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    sampling_seed: int = 0,
    priorities=None,
    mpmc: bool = False,
    device="cuda",
    smoke: bool = True,
) -> TrafficReport:
    """Drive a Poisson request load through a spawned serving fleet.

    Spawns ``workers`` real processes (spawn context: a CUDA context is
    never inherited), each serving ``engine.serve_loop`` on ``device`` over
    its ring pair with ``get_config(arch, smoke=smoke)`` and the
    hand-written kernels, and
    sends ``n_requests`` with exponential inter-arrival times at
    ``rate_hz``. Requests round-robin across workers; a full request ring
    routes to the next worker, and a fully-backpressured fleet defers the
    send (counted in ``stalls``). Returns a ``TrafficReport`` with
    sustained req/s, tok/s, p50/p99 end-to-end latency and each cleanly
    exited worker's statistics; worker crashes surface as structured
    ``worker_errors`` records (exit code + traceback excerpt).

    ``warmup_per_worker`` requests are pushed to every worker and drained
    BEFORE the measured phase, so first-call costs (kernel library loads,
    cuBLAS handles) happen off the clock.

    All ring segments are unlinked before returning — and if this process
    is SIGKILLed first, their records name a dead owner pid, so the next
    ``ws.gc()`` reclaims them.

    ``rollover_at``/``rollover_fn``: after request index ``rollover_at``
    is sent, ``rollover_fn()`` runs on the dispatcher — a management commit
    landing generation N+1 while the fleet serves N. Completions received
    between the commit and the last worker's ADOPTED frame land in
    ``report.rollover_latencies_s``; each adoption's digest lands in
    ``report.adoptions``.

    Hardening knobs: ``request_deadline_s`` (expired requests come back as
    DEADLINE completions), ``adopt_deadline_s`` (bounds each flip; a
    wedged reload rolls back), ``supervise`` (respawn dead workers and
    re-route their in-flight requests), ``faults`` (a ``FaultPlan`` as a
    dict for the targeted worker). Serving knobs: ``stream``,
    ``temperature``/``top_k``/``sampling_seed`` (token i of rid r is a pure
    function of (seed, r, i)), ``priorities`` (per-request admission
    classes) and ``mpmc`` (multi-producer request rings).
    """
    cache_len = cache_len or (prompt_len + max_new_tokens + 4)
    session = session or f"traffic-{uuid.uuid4().hex[:8]}"
    slot_bytes = ring_slot_bytes(prompt_len, max_new_tokens)
    vocab = get_config(arch, smoke=smoke).vocab_size
    report = TrafficReport(
        workers=workers, strategy=strategy, arch=arch, rate_hz=rate_hz
    )
    stats_dir = Path(ws.root) / "traffic" / session
    stats_dir.mkdir(parents=True, exist_ok=True)

    ctx = mp.get_context("spawn")
    req_rings = [
        ShmRing.create(
            ws.registry, req_channel(session, i),
            slots=RING_SLOTS, slot_bytes=slot_bytes,
            # mpmc: this dispatcher takes seat 0; additional dispatchers
            # would attach with their own producer seats
            producers=1 if mpmc else 0,
            producer_id=0 if mpmc else None,
        )
        for i in range(workers)
    ]

    def _worker_args(i: int, plan: dict | None):
        return (
            ws.root, app_name, arch, strategy, session, i,
            cache_len, max_batch, max_new_tokens, slot_bytes, str(stats_dir),
            plan, adopt_deadline_s,
            stream, temperature, top_k, sampling_seed,
            str(device), smoke,
        )

    procs = [
        ctx.Process(
            target=_traffic_worker,
            args=_worker_args(i, faults),
            daemon=True,
        )
        for i in range(workers)
    ]
    for p in procs:
        p.start()
    rsp_rings = [
        ShmRing.attach(ws.registry, rsp_channel(session, i), timeout=60.0)
        for i in range(workers)
    ]

    prompts, gaps = draw_prompts(vocab, n_requests, prompt_len, rate_hz, seed)
    alive = [True] * workers
    deadline = time.monotonic() + timeout
    first_send = last_recv = 0.0
    # supervision bookkeeping: every sent frame is retained by rid so a
    # dead worker's in-flight requests can be re-routed verbatim (original
    # enqueue time included), and completions are deduped by rid because a
    # frame can come back twice (ring replay by the respawn + re-route).
    sent_frames: dict[int, bytes] = {}
    owner: dict[int, int] = {}           # rid -> worker currently holding it
    done_rids: set[int] = set()
    rerouted_rids: set[int] = set()
    restarts_per = [0] * workers
    # streaming reassembly: per-rid spans keyed by seq (idempotent under
    # duplicate delivery), plus the dispatcher-side send stamp for TTFT
    send_ts: dict[int, float] = {}
    spans: dict[int, dict[int, np.ndarray]] = {}
    ttft_seen: set[int] = set()

    def _reap(i: int, blob: bytes | None) -> None:
        """Record worker i's death as a structured error, once."""
        if not alive[i]:
            return
        alive[i] = False
        report.worker_errors.append(
            {
                "worker": i,
                "pid": procs[i].pid,
                "exit_code": procs[i].exitcode,
                "error": (blob or b"").decode(errors="replace")[-2000:],
            }
        )

    warmed = 0
    roll_active = False      # commit issued, not every worker adopted yet
    roll_t0 = 0.0

    def _respawn(i: int) -> None:
        """Supervisor: worker ``i`` died. Confirm through the rsp-ring
        owner record (the dead pid sits in shm — no waitpid race), bring a
        replacement up with capped exponential backoff, and re-route every
        request the corpse was holding to surviving workers. The request
        ring is dispatcher-owned and its pop cursor lives in the shared
        header, so frames the corpse never popped are consumed by the
        replacement as-is; only popped-but-unanswered frames need the
        re-route, and rid dedup absorbs any overlap between the two."""
        if ring_owner_alive(ws.registry, rsp_channel(session, i)) is True:
            return               # record says the owner is alive: not dead
        alive[i] = False
        report.restarts += 1
        restarts_per[i] += 1
        victims = sorted(
            rid for rid, w in owner.items() if w == i and rid not in done_rids
        )
        try:                     # replacement re-creates the rsp ring
            rsp_rings[i].close()
            rsp_rings[i].unlink(ws.registry)
        except Exception:
            pass
        time.sleep(min(0.05 * (2 ** (restarts_per[i] - 1)), 1.0))
        p = ctx.Process(
            target=_traffic_worker, args=_worker_args(i, None), daemon=True
        )
        p.start()
        procs[i] = p
        rsp_rings[i] = ShmRing.attach(
            ws.registry, rsp_channel(session, i), timeout=60.0
        )
        alive[i] = True
        targets = [j for j in range(workers) if alive[j] and j != i] or [i]
        for n, rid in enumerate(victims):
            t = targets[n % len(targets)]
            _push_blocking(req_rings[t], sent_frames[rid], timeout=30.0)
            owner[rid] = t
            rerouted_rids.add(rid)
            report.rerouted_requests += 1
            # the survivor replays the request's WHOLE stream from seq 0
            # (rid-derived sampling keys make it byte-identical); drop the
            # corpse's partial spans so reassembly sees one clean pass
            spans.pop(rid, None)

    def _verify_stream(rid: int, final_row: np.ndarray) -> None:
        """At completion, check the reassembled stream against the
        completion frame's authoritative row: every seq present exactly
        once (gaps/dups counted separately) and byte-identical tokens."""
        sp = spans.pop(rid, {})
        flat: dict[int, int] = {}
        for s, arr in sp.items():
            for off, tok in enumerate(np.asarray(arr).tolist()):
                flat.setdefault(s + off, tok)
        want = int(final_row.size)
        missing = [i for i in range(want) if i not in flat]
        if missing:
            report.stream_gaps += len(missing)
            return
        rec = np.asarray([flat[i] for i in range(want)], np.int32)
        report.stream_tokens[rid] = rec
        if not np.array_equal(rec, np.asarray(final_row, np.int32)):
            report.stream_mismatches += 1

    def _drain() -> None:
        nonlocal last_recv, warmed, roll_active
        for i, ring in enumerate(rsp_rings):
            while True:
                data = ring.pop()
                if data is None:
                    break
                rid, payload, a, f, enq, status = decode_completion(data)
                if rid == _RID_READY:
                    report.ready_s.append(a)
                elif rid == _RID_ADOPTED:
                    report.adoptions.append(
                        json.loads(payload.decode(errors="replace"))
                    )
                    if roll_active and len(report.adoptions) >= sum(alive):
                        # every surviving worker now serves generation N+1
                        report.rollover_wall_s = time.monotonic() - roll_t0
                        roll_active = False
                elif rid == _RID_ERROR:
                    _reap(i, payload)
                elif status == "partial":
                    # streamed span: reassemble by seq. Late frames for a
                    # completed rid and duplicate seqs (re-route replay,
                    # dup-delivery faults) are absorbed idempotently.
                    if rid >= _RID_WARM or rid in done_rids:
                        continue
                    report.partial_frames += 1
                    seq = int(a)
                    sp = spans.setdefault(rid, {})
                    if seq in sp:
                        report.stream_dup_frames += 1
                    else:
                        sp[seq] = payload
                    if rid not in ttft_seen:
                        ttft_seen.add(rid)
                        st = send_ts.get(rid)
                        if st is not None:
                            report.ttft_s.append(time.monotonic() - st)
                elif rid >= _RID_WARM:
                    if rid not in done_rids:
                        done_rids.add(rid)
                        warmed += 1
                else:
                    if rid in done_rids:
                        continue     # duplicate: replayed AND re-routed
                    done_rids.add(rid)
                    owner.pop(rid, None)
                    now = time.monotonic()
                    last_recv = max(last_recv, now)
                    report.completed += 1
                    if status == "deadline":
                        # structured DEADLINE frame: answered, not served
                        report.deadline_expired += 1
                        spans.pop(rid, None)  # partial stream: unverifiable
                    else:
                        report.tokens_out += int(payload.size)
                        if math.isfinite(f):
                            report.ring_wait_s.append(now - f)
                        if enq is not None:
                            report.latencies_s.append(now - enq)
                            if roll_active:
                                report.rollover_latencies_s.append(now - enq)
                            else:
                                report.steady_latencies_s.append(now - enq)
                        if stream:
                            _verify_stream(rid, payload)
                    if rid in rerouted_rids and enq is not None:
                        report.kill_latencies_s.append(now - enq)
            if alive[i] and not procs[i].is_alive() and procs[i].exitcode:
                if supervise:
                    _respawn(i)
                else:
                    _reap(i, None)

    try:
        # ---- warmup phase: first calls of every worker off the clock
        warm_expect = 0
        for w in range(workers):
            for j in range(warmup_per_worker):
                wrid = _RID_WARM + w * warmup_per_worker + j
                frame = encode_request(
                    wrid, prompts[(w + j) % n_requests], max_new_tokens, None,
                )
                _push_blocking(req_rings[w], frame, timeout=30.0)
                sent_frames[wrid] = frame
                owner[wrid] = w
                warm_expect += 1
        while warmed < warm_expect:
            _drain()
            if not any(alive):
                raise ShmRingError(
                    f"every worker died during warmup: {report.worker_errors}"
                )
            if time.monotonic() >= deadline:
                raise ShmRingError("fleet never finished warmup")
            time.sleep(0.002)

        # ---- send phase: Poisson arrivals, round-robin with backpressure
        nxt = 0
        for k in range(n_requests):
            if rollover_fn is not None and rollover_at is not None and k == rollover_at:
                # roll the world under live load: the commit lands here,
                # on the dispatcher, while workers keep serving gen N
                report.rollover_at = rollover_at
                roll_t0 = time.monotonic()
                roll_active = True
                rollover_fn()
            # wait out the inter-arrival gap draining the response rings:
            # the reference sleeps here, so an answer that lands meanwhile
            # waits in its ring and the wait counts in its latency and TTFT
            # (ROADMAP Queue C)
            send_at = time.monotonic() + gaps[k]
            while True:
                _drain()
                left = send_at - time.monotonic()
                if left <= 0:
                    break
                time.sleep(min(left, 0.001))
            while True:
                _drain()
                targets = [
                    (nxt + d) % workers for d in range(workers)
                    if alive[(nxt + d) % workers]
                ]
                if not targets:
                    raise ShmRingError(
                        f"every worker died before request {k}: "
                        f"{report.worker_errors}"
                    )
                sent = False
                for t in targets:
                    stamp = time.monotonic()
                    frame = encode_request(
                        k, prompts[k], max_new_tokens, stamp,
                        request_deadline_s,
                        0 if priorities is None else int(priorities[k]),
                    )
                    if req_rings[t].push(frame):
                        sent_frames[k] = frame
                        send_ts[k] = stamp
                        owner[k] = t
                        nxt = (t + 1) % workers
                        sent = True
                        break
                if sent:
                    break
                report.stalls += 1
                if time.monotonic() >= deadline:
                    raise ShmRingError("fleet stayed backpressured past timeout")
                time.sleep(0.001)
            report.sent += 1
            if first_send == 0.0:
                first_send = time.monotonic()

        # ---- drain phase: STOP each worker, collect the tail. A
        # supervised fleet sends its STOPs only after the last answer: a
        # worker that dies in the tail has its requests re-routed, and a
        # frame queued behind a STOP is never read (nor does a replacement
        # whose corpse took the STOP ever get one).
        def _send_stops() -> None:
            stop_frame = _REQ_HDR.pack(_RID_STOP, 0, 0, 0.0, 0.0, 0)
            for i, ring in enumerate(req_rings):
                if not alive[i]:
                    continue
                while not ring.push(stop_frame):   # backlogged: drain first
                    _drain()
                    if not alive[i] or time.monotonic() >= deadline:
                        break
                    time.sleep(0.001)

        if not supervise:
            _send_stops()
        expect = report.sent
        while report.completed < expect and time.monotonic() < deadline:
            _drain()
            if report.completed >= expect:
                break
            if all(not p.is_alive() for p in procs):
                _drain()   # final sweep: workers are gone, rings may not be
                break
            time.sleep(0.001)
        if supervise:
            _send_stops()
        for i, p in enumerate(procs):
            p.join(timeout=max(0.0, deadline - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            elif p.exitcode:
                _reap(i, None)
        report.worker_stats = _read_worker_stats(stats_dir)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for ring in req_rings:
            ring.close()
            ring.unlink(ws.registry)
        for ring in rsp_rings:
            ring.close()
            ring.unlink(ws.registry)
        shutil.rmtree(stats_dir, ignore_errors=True)

    report.wall_s = max(last_recv - first_send, 1e-9) if first_send else 0.0
    return report

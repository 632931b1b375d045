"""Continuous batching: admit requests into open decode slots mid-flight.

The port of the reference's ``serve/scheduler.py``. ``ServeEngine.generate``
runs a *static* batch; this module runs a fixed pool of ``max_batch`` decode
slots, each holding one request's private KV cache row, admitted and
retired independently at every decode step.

The slot state is ``(cache, toks, out_buf, steps, keys)`` as batched
tensors on the engine's device. Every tensor leaf of a B=1 prefill's cache
gets one row per slot on axis 1: ``k``/``v`` ``(L, slots, S, KV, hd)`` for
a transformer, ``conv``/``ssm`` ``(L, slots, ...)`` for mamba2, all four
for the hybrid (whose ``k``/``v`` are per shared-block invocation).
``cache["pos"]`` is a tuple of per-slot positions kept on the host (the
host issued every step, so it knows them). An encoder-decoder's slots
also hold the cross keys and values ``cache["xk"]``/``["xv"]``, padded to
the same ``S`` rows, with ``cache["xpos"]`` the last valid row of each
(its prompt's length - 1):
the reference sizes its slot template to the first admission's prompt and
cannot serve mixed prompt lengths (ROADMAP Queue C). The reference vmaps a
B=1 ``decode_step`` over slots; ``torch.func.vmap`` cannot pass through the
ctypes-bound kernels, so one batched ``decode_step`` with per-row
positions advances every slot instead (``models/transformer.py``). Each step decodes EVERY slot and masks
the inactive ones, as the reference's ``jnp.where(active, nxt, 0)`` does,
so the kernel launch counts do not depend on occupancy. Admission prefills
B=1 with the engine's ``impl`` and writes the row into its slot in place.

Host/device contract, as the reference's: the decode loop never syncs per
step (the host mirrors the step counters), and pays one device sync per
*completed* request — fetching that request's finished ``out_buf`` row.
Per-step uploads (the ``active`` mask, positions) go up from pinned memory
without waiting for the stream.

Sampling: torch cannot reproduce JAX's threefry bits, so the port keeps the
property that matters instead — token ``i`` of request ``rid`` is a pure
function of ``(sampling_seed, rid, i)``. A splitmix64 hash of those three
and of the vocabulary index, in integer torch ops (the same bits on the CPU
and on the card), gives a uniform per (row, token) that feeds Gumbel-max
over the temperature-scaled, top-k-masked logits. Continuations are then
independent of batch composition, stream mode and re-routing. Greedy
(``temperature <= 0``) is argmax, as the reference's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch import models
from repro_torch.core.errors import EpochAdoptError
from repro_torch.device import torch_dtype
from repro_torch.models.common import host_ints

from . import faults

#: Source sentinel: no more requests will ever arrive; drain and return.
STOP = object()

#: An encoder-decoder's cross K/V: padded to the self K/V's rows in a slot.
_CROSS = ("xk", "xv")


@dataclass(frozen=True)
class Request:
    """One unit of traffic: a prompt and how far to decode it.

    ``enqueued_ts`` is the dispatcher's ``time.monotonic()`` stamp —
    ``None`` (not ``0.0``: zero is a representable clock reading) means no
    dispatcher clock exists and the serve loop rebases the deadline to its
    own acceptance time. ``priority`` is an admission class: higher admits
    first, FIFO within a class, and waiting requests age upward so a low
    class is starvation-bounded rather than starved.
    """

    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int
    enqueued_ts: float | None = None  # dispatcher clock; None = no clock
    deadline_s: float = 0.0          # seconds after enqueue; 0 = no deadline
    priority: int = 0                # admission class; higher admits first

    def expired(self, now: float) -> bool:
        """Past its deadline, measured from enqueue on ``time.monotonic()``."""
        return (
            self.deadline_s > 0.0
            and self.enqueued_ts is not None
            and now - self.enqueued_ts > self.deadline_s
        )


@dataclass(frozen=True)
class TokenDelta:
    """One streamed decode increment: ``tokens`` are sequence positions
    ``seq .. seq + len(tokens) - 1`` of request ``rid``'s continuation."""

    rid: int
    seq: int
    tokens: tuple                    # ints; a span, usually length 1


@dataclass
class Completion:
    """A finished request: its continuation + latency breakdown."""

    rid: int
    tokens: np.ndarray               # (max_new_tokens,) int32
    admitted_ts: float
    finished_ts: float
    enqueued_ts: float | None = None
    status: str = "ok"               # "ok" | "deadline" (expired, partial)

    @property
    def latency_s(self) -> float:
        """Queue-to-finish when the enqueue time is known, else
        admit-to-finish."""
        start = (
            self.enqueued_ts if self.enqueued_ts is not None
            else self.admitted_ts
        )
        return self.finished_ts - start


@dataclass
class ServeLoopReport:
    """What one ``serve_loop`` invocation did."""

    completed: int = 0
    admitted: int = 0
    steps: int = 0                   # batched decode dispatches
    tokens_out: int = 0
    peak_active: int = 0
    peak_queue: int = 0
    rejected: int = 0                # source offers refused (queue full)
    wall_s: float = 0.0
    rollovers: int = 0               # epoch flips taken at a request boundary
    rollover_stall_s: float = 0.0    # commit noticed -> flip complete, summed
    coalesced_rollovers: int = 0     # commits superseded before their flip
    rollover_aborts: int = 0         # flips that deadlined and rolled back
    deadline_expired: int = 0        # requests retired with a DEADLINE frame
    admitted_by_priority: dict = field(default_factory=dict)  # class -> count
    priority_aged: int = 0           # admissions that out-ranked a higher class
    deltas_out: int = 0              # streamed TokenDelta frames emitted

    def summary(self) -> dict:
        return {
            "completed": self.completed,
            "admitted": self.admitted,
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            "peak_active": self.peak_active,
            "peak_queue": self.peak_queue,
            "rejected": self.rejected,
            "wall_s": self.wall_s,
            "rollovers": self.rollovers,
            "rollover_stall_s": self.rollover_stall_s,
            "coalesced_rollovers": self.coalesced_rollovers,
            "rollover_aborts": self.rollover_aborts,
            "deadline_expired": self.deadline_expired,
            "admitted_by_priority": dict(self.admitted_by_priority),
            "priority_aged": self.priority_aged,
            "deltas_out": self.deltas_out,
        }


@dataclass
class _Slot:
    """Host-side mirror of one device slot (the scheduler's bookkeeping)."""

    request: Request
    admitted_ts: float
    steps_done: int                  # tokens already in out_buf for this slot
    first_token: int = -1            # prefill's token, host-side iff streaming


# ------------------------------------------------------------- sampling
_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _i64(u: int) -> int:
    """An unsigned 64-bit value as the signed int64 with the same bits."""
    u &= _MASK64
    return u - (1 << 64) if u >> 63 else u


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's ``>>`` is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's output function on int64 tensors (wrapping products)."""
    x = (x ^ _shr(x, 30)) * _i64(_MIX1)
    x = (x ^ _shr(x, 27)) * _i64(_MIX2)
    return x ^ _shr(x, 31)


def _fmix_host(x: int) -> int:
    """``_fmix`` on a Python int (unsigned arithmetic mod 2**64)."""
    x &= _MASK64
    x = ((x ^ (x >> 30)) * _MIX1) & _MASK64
    x = ((x ^ (x >> 27)) * _MIX2) & _MASK64
    return x ^ (x >> 31)


def request_key(seed: int, rid: int) -> int:
    """The per-request stream key, a pure function of (seed, rid); rid is
    taken as 64 bits, so warm-up rids above 2**32 keep their high half."""
    k = _fmix_host(_fmix_host(seed + _GOLDEN) ^ (rid & _MASK64))
    return _i64(k)


def uniforms(keys: torch.Tensor, counters: torch.Tensor, vocab: int) -> torch.Tensor:
    """(B, vocab) float64 uniforms in (0, 1): entry ``[b, v]`` is the
    ``v``-th splitmix64 output of the stream seeded by ``(keys[b],
    counters[b])`` — integer ops only, so CPU and card give the same bits."""
    row = _fmix(keys + (counters + 1) * _i64(_GOLDEN))
    v = torch.arange(1, vocab + 1, dtype=torch.int64, device=keys.device)
    h = _fmix(row[:, None] + v[None, :] * _i64(_GOLDEN))
    return (_shr(h, 11).double() + 0.5) * 2.0**-53


def pick_tokens(logits, keys, counters, *, temperature: float, top_k: int):
    """Next token per row from ``logits`` (B, V): argmax when greedy, else
    Gumbel-max over ``logits / temperature`` with everything below the
    ``top_k``-th value masked out. Returns (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, float("-inf")), lg)
    u = uniforms(keys, counters, lg.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(lg.double() + gumbel, dim=-1).to(torch.int32)


def check_token_ids(tokens, vocab_size: int, what: str = "prompt") -> None:
    """Refuse a token id outside ``[0, vocab_size)`` on the host, before
    anything is launched: the embedding gather would index out of range,
    which is an ``IndexError`` on the CPU and a device-side assert on the
    card (it poisons the process's CUDA context). The reference's
    ``jnp.take`` fills such rows with NaN instead (ROADMAP Queue C)."""
    arr = np.asarray(tokens)
    if arr.size == 0:
        return
    lo, hi = int(arr.min()), int(arr.max())
    if lo < 0 or hi >= vocab_size:
        bad = lo if lo < 0 else hi
        raise ValueError(
            f"{what} holds token id {bad}, outside the vocabulary "
            f"[0, {vocab_size})"
        )


def stub_frames(cfg, batch: int, seq: int, device) -> torch.Tensor:
    """The encoder-decoder's modality stub, as the reference's engine and
    scheduler draw it: ``default_rng(0).standard_normal((batch, seq,
    d_model))`` cast to the config's dtype (numpy, so that both packages see
    the same frames)."""
    frames = np.random.default_rng(0).standard_normal((batch, seq, cfg.d_model))
    return torch.from_numpy(frames).to(device=device, dtype=torch_dtype(cfg.dtype))


class SlotScheduler:
    """The device half of continuous batching for one ``ServeEngine``.

    Owns the batched slot state (caches, next-token feeds, ``out_buf``,
    per-slot step counters and sampling keys) and the two operations that
    change it: ``step`` (advance every slot one token) and ``admit``
    (prefill one request and write its cache row into a free slot). The
    state is built at the first admission, shaped after that prefill's
    cache.

    Sampling: ``temperature > 0`` replaces greedy argmax with temperature
    (optionally top-k) sampling; token ``i`` of request ``rid`` is drawn
    from the stream ``(request_key(sampling_seed, rid), i)``, so a slot
    admitted mid-flight never shares a sibling's stream and a re-routed
    request replays the identical continuation.
    """

    def __init__(
        self,
        engine,
        *,
        max_batch: int,
        max_new_cap: int = 0,
        temperature: float = 0.0,
        top_k: int = 0,
        sampling_seed: int = 0,
        stream: bool = False,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.slots = max_batch
        self.max_new_cap = max_new_cap   # out_buf width; 0 = first admit's
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.sampling_seed = int(sampling_seed)
        self.stream = stream
        self._state = None           # (cache, toks, out_buf, steps, keys)
        self.active = np.zeros(max_batch, dtype=bool)
        self.slot_meta: list[_Slot | None] = [None] * max_batch

    def _pick(self, logits, keys, counters):
        return pick_tokens(logits, keys, counters,
                           temperature=self.temperature, top_k=self.top_k)

    # --------------------------------------------------------------- state
    @property
    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if not self.active[i]]

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def _init_state(self, row_cache, max_new_cap: int) -> None:
        self.max_new_cap = max_new_cap
        dev = self.engine.device
        cache = {}
        for name, t in row_cache.items():
            if not isinstance(t, torch.Tensor):
                continue
            # a leaf's rows lie on axis 1; cross K/V get the self K/V's rows
            like = row_cache["k"] if name in _CROSS else t
            shape = (t.shape[0], self.slots) + tuple(like.shape[2:])
            cache[name] = torch.zeros(shape, dtype=t.dtype, device=dev)
        cache["pos"] = (0,) * self.slots
        if "xk" in row_cache:
            cache["xpos"] = (0,) * self.slots
        self._state = (
            cache,
            torch.zeros((self.slots, 1), dtype=torch.int32, device=dev),
            torch.zeros((self.slots, max_new_cap), dtype=torch.int32, device=dev),
            torch.zeros((self.slots,), dtype=torch.int64, device=dev),
            torch.zeros((self.slots,), dtype=torch.int64, device=dev),
        )

    # ------------------------------------------------------------ protocol
    @torch.inference_mode()
    def admit(self, req: Request, now: float) -> int:
        """Prefill ``req`` (B=1, the engine's ``impl``) and write its cache
        row into a free slot. Returns the slot index. A prompt holding a
        token id outside the vocabulary, or longer than the engine's
        ``cache_len`` (a cache with a sequence axis), raises ``ValueError``
        first."""
        free = self.free_slots
        if not free:
            raise RuntimeError("admit called with no free slot")
        idx = free[0]
        eng = self.engine
        check_token_ids(req.prompt, eng.cfg.vocab_size, f"request {req.rid}")
        n = len(req.prompt)
        if eng.cache_len and n > eng.cache_len and eng.cfg.family != "ssm":
            raise ValueError(
                f"request {req.rid}: a prompt of {n} tokens does not fit the "
                f"engine's cache_len of {eng.cache_len}")
        prompt = host_ints(np.asarray(req.prompt).tolist(), eng.device)
        batch = {"tokens": prompt.to(torch.int32)[None]}
        if eng.cfg.is_encdec:
            batch["frames"] = stub_frames(eng.cfg, 1, n, eng.device)
        logits, row_cache = models.prefill(
            eng.cfg, eng.params, batch, impl=eng.impl,
            cache_len=eng.cache_len or None,
        )
        row_key = request_key(self.sampling_seed, req.rid)
        key = torch.full((1,), row_key, dtype=torch.int64, device=eng.device)
        tok0 = self._pick(logits[:, -1], key, torch.zeros_like(key))  # (1,)
        if self._state is None:
            self._init_state(
                row_cache, self.max_new_cap or max(req.max_new_tokens, 8)
            )
        if req.max_new_tokens > self.max_new_cap:
            raise ValueError(
                f"request {req.rid} wants {req.max_new_tokens} tokens but "
                f"this loop's out_buf holds {self.max_new_cap}; admit the "
                "longest request first or pass max_new_cap to serve_loop"
            )
        cache, toks, out_buf, steps, keys = self._state
        for name, t in row_cache.items():
            if not isinstance(t, torch.Tensor):
                continue
            if name in _CROSS:        # cross K/V padded with zeros to S rows
                cache[name][:, idx, :t.shape[2]] = t[:, 0]
                cache[name][:, idx, t.shape[2]:] = 0
            else:
                cache[name][:, idx] = t[:, 0]
        pos = list(cache["pos"])
        pos[idx] = int(row_cache["pos"])
        cache["pos"] = tuple(pos)
        if "xk" in cache:
            s_enc = row_cache["xk"].shape[2]
            xpos = list(cache["xpos"])
            xpos[idx] = s_enc - 1
            cache["xpos"] = tuple(xpos)
        out_buf[idx] = 0
        out_buf[idx, 0] = tok0[0]
        steps[idx] = 1
        toks[idx, 0] = tok0[0]
        keys[idx] = row_key
        self.active[idx] = True
        meta = _Slot(request=req, admitted_ts=now, steps_done=1)
        if self.stream:
            # streaming pays one scalar sync per ADMIT (not per step) so
            # the prefill token can ride the first PARTIAL frame
            meta.first_token = int(tok0[0])
        self.slot_meta[idx] = meta
        return idx

    @torch.inference_mode()
    def step(self) -> list[TokenDelta] | None:
        """Advance every slot one token (one batched ``decode_step``);
        inactive slots decode too, and their results are masked.

        Returns the per-slot token deltas when streaming (one host sync of
        the (slots,) next-token feed), else None (no sync; tokens stay on
        the device until ``pop_finished``)."""
        eng = self.engine
        cache, toks, out_buf, steps, keys = self._state
        active = host_ints(self.active.tolist(), eng.device).bool()
        logits, cache = models.decode_step(eng.cfg, eng.params, cache, toks)
        nxt = self._pick(logits[:, -1], keys, steps)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        row = torch.arange(self.slots, device=eng.device)
        idx = torch.clamp(steps, 0, out_buf.shape[1] - 1)
        out_buf[row, idx] = torch.where(active, nxt, out_buf[row, idx])
        steps += active
        toks = nxt[:, None]
        self._state = (cache, toks, out_buf, steps, keys)
        deltas: list[TokenDelta] | None = None
        if self.stream:
            feed = toks.cpu().numpy()        # (slots, 1): just-sampled
            deltas = [
                TokenDelta(
                    rid=meta.request.rid,
                    seq=meta.steps_done,     # tokens already out = position
                    tokens=(int(feed[i, 0]),),
                )
                for i, meta in enumerate(self.slot_meta)
                if meta is not None
            ]
        for meta in self.slot_meta:
            if meta is not None:
                meta.steps_done += 1
        return deltas

    def pop_finished(self, now: float) -> list[Completion]:
        """Retire every slot whose host-mirrored step count hit its target.

        The ONE host sync per request happens here: fetching the finished
        ``out_buf`` row."""
        done: list[Completion] = []
        out_buf = self._state[2] if self._state is not None else None
        for idx, meta in enumerate(self.slot_meta):
            if meta is None:
                continue
            want = meta.request.max_new_tokens
            if meta.steps_done >= want:
                row = out_buf[idx, :want].to("cpu", copy=True).numpy()
                done.append(
                    Completion(
                        rid=meta.request.rid,
                        tokens=row,
                        admitted_ts=meta.admitted_ts,
                        finished_ts=now,
                        enqueued_ts=meta.request.enqueued_ts,
                    )
                )
                self.active[idx] = False
                self.slot_meta[idx] = None
        return done

    def expire(self, now: float) -> list[Completion]:
        """Retire every in-flight slot whose request blew its deadline: the
        partial row comes back in a ``status="deadline"`` completion and
        the slot frees at once."""
        done: list[Completion] = []
        out_buf = self._state[2] if self._state is not None else None
        for idx, meta in enumerate(self.slot_meta):
            if meta is None or not meta.request.expired(now):
                continue
            got = min(meta.steps_done, self.max_new_cap)
            row = (
                out_buf[idx, :got].to("cpu", copy=True).numpy()
                if out_buf is not None
                else np.zeros((0,), np.int32)
            )
            done.append(
                Completion(
                    rid=meta.request.rid,
                    tokens=row,
                    admitted_ts=meta.admitted_ts,
                    finished_ts=now,
                    enqueued_ts=meta.request.enqueued_ts,
                    status="deadline",
                )
            )
            self.active[idx] = False
            self.slot_meta[idx] = None
        return done


def run_serve_loop(
    engine,
    source,
    sink,
    *,
    max_batch: int = 4,
    max_queue: int = 16,
    max_new_cap: int = 0,
    idle_sleep_s: float = 0.0005,
    epoch_watch=None,
    on_epoch=None,
    watch_interval_s: float = 0.02,
    temperature: float = 0.0,
    top_k: int = 0,
    sampling_seed: int = 0,
    on_delta=None,
    priority_aging_s: float = 0.05,
) -> ServeLoopReport:
    """Drive continuous batching until the source signals ``STOP``.

    ``source()`` is polled for ``Request | None | STOP`` whenever the
    accepted queue has room (None = nothing right now; the loop keeps
    decoding). Each ``Completion`` is handed to ``sink`` the step its
    request finishes. ``max_queue`` bounds requests accepted but not yet
    admitted.

    **Blue/green rollover** (``epoch_watch`` + ``on_epoch``): between
    decode steps the loop polls ``epoch_watch.poll()``. When a commit lands
    generation N+1, the loop stops *admitting* — traffic keeps being
    accepted into the queue — and lets every in-flight slot finish on
    generation N. At the first empty request boundary it calls
    ``on_epoch(change)`` (typically ``engine.adopt_epoch``), then resumes
    admission on N+1. Back-to-back commits coalesce into one flip to the
    newest generation (``coalesced_rollovers``); an ``on_epoch`` that
    raises ``EpochAdoptError`` (a deadlined, rolled-back flip) counts a
    ``rollover_abort`` and admission resumes on the weights the engine
    already re-adopted.

    **Deadlines**: an expired request, queued or in flight, is retired with
    a ``status="deadline"`` completion carrying its partial row.

    **Priority admission**: higher class first, FIFO within a class; a
    request's effective class gains one per ``priority_aging_s`` waited.

    **Streaming** (``on_delta``): every token is surfaced as a
    ``TokenDelta`` the step it is sampled (the prefill token as seq 0).

    **Sampling**: ``temperature``/``top_k``/``sampling_seed``; see
    ``SlotScheduler``. All timestamps are ``time.monotonic()``.
    """
    report = ServeLoopReport()
    sched = SlotScheduler(
        engine, max_batch=max_batch, max_new_cap=max_new_cap,
        temperature=temperature, top_k=top_k, sampling_seed=sampling_seed,
        stream=on_delta is not None,
    )
    queue: list[tuple[Request, int, float]] = []  # (req, arrival, accepted_ts)
    arrivals = 0
    draining = False
    pending_epoch = None             # EpochChange waiting for the boundary
    next_watch = 0.0
    stall_t0 = 0.0
    t0 = time.monotonic()

    def _pick_next(now: float) -> Request:
        """Priority-then-FIFO with aging: highest effective class wins,
        oldest arrival breaks ties within a class."""
        best = None
        for entry in queue:
            req, arrival, accepted = entry
            eff = req.priority
            if priority_aging_s > 0:
                eff += int((now - accepted) / priority_aging_s)
            key = (eff, -arrival)
            if best is None or key > best[0]:
                best = (key, entry)
        _, entry = best
        queue.remove(entry)
        req = entry[0]
        if any(q.priority > req.priority for q, _, _ in queue):
            report.priority_aged += 1
        by = report.admitted_by_priority
        by[req.priority] = by.get(req.priority, 0) + 1
        return req

    while True:
        # 0) rollover handshake: notice a landed commit (throttled), flip
        # at a request boundary — never mid-decode for any in-flight slot.
        # Polling continues while a flip is pending, so back-to-back
        # commits coalesce to the newest generation.
        now = time.monotonic()
        if epoch_watch is not None and now >= next_watch:
            next_watch = now + watch_interval_s
            change = epoch_watch.poll()
            if change is not None:
                if pending_epoch is None:
                    stall_t0 = now
                else:
                    report.coalesced_rollovers += 1
                pending_epoch = change
        if pending_epoch is not None and sched.n_active == 0:
            if on_epoch is not None:
                try:
                    on_epoch(pending_epoch)
                except EpochAdoptError:
                    # the engine already rolled back to the still-live
                    # generation: resume admission on the weights we have
                    report.rollover_aborts += 1
            report.rollovers += 1
            report.rollover_stall_s += time.monotonic() - stall_t0
            pending_epoch = None

        # 1) accept traffic while there is queue room (rollover included)
        while not draining and len(queue) < max_queue:
            got = source()
            if got is None:
                break
            if got is STOP:
                draining = True
                break
            now = time.monotonic()
            if got.deadline_s > 0 and got.enqueued_ts is None:
                # no dispatcher clock: the deadline counts from acceptance
                got = replace(got, enqueued_ts=now)
            queue.append((got, arrivals, now))
            arrivals += 1
        report.peak_queue = max(report.peak_queue, len(queue))

        # 1b) deadline sweep: queued requests first (they expire without a
        # prefill), then in-flight slots (freed with their partial row)
        now = time.monotonic()
        if queue:
            still = []
            for entry in queue:
                req = entry[0]
                if req.expired(now):
                    report.deadline_expired += 1
                    sink(
                        Completion(
                            rid=req.rid,
                            tokens=np.zeros((0,), np.int32),
                            admitted_ts=now,
                            finished_ts=now,
                            enqueued_ts=req.enqueued_ts,
                            status="deadline",
                        )
                    )
                else:
                    still.append(entry)
            queue = still
        for comp in sched.expire(now):
            report.deadline_expired += 1
            sink(comp)

        # 2) admit into free slots; held back while a flip waits
        now = time.monotonic()
        while pending_epoch is None and queue and sched.free_slots:
            req = _pick_next(now)
            idx = sched.admit(req, now)
            report.admitted += 1
            if on_delta is not None:
                meta = sched.slot_meta[idx]
                on_delta(
                    TokenDelta(rid=req.rid, seq=0,
                               tokens=(meta.first_token,))
                )
                report.deltas_out += 1
        report.peak_active = max(report.peak_active, sched.n_active)

        # 3) advance every slot one token
        if sched.n_active:
            faults.on_decode_step(report.steps + 1)
            deltas = sched.step()
            report.steps += 1
            if on_delta is not None and deltas:
                for d in deltas:
                    on_delta(d)
                report.deltas_out += len(deltas)

            # 4) retire finished requests (one host sync each)
            for comp in sched.pop_finished(time.monotonic()):
                report.completed += 1
                report.tokens_out += comp.tokens.shape[0]
                sink(comp)
        elif queue:
            continue
        elif draining:
            break
        else:
            time.sleep(idle_sleep_s)

    report.wall_s = time.monotonic() - t0
    return report

"""Shared-memory request/response rings: the serving fleet's data plane.

``core/shm_arena.py`` proved the control-plane half of the paper's epoch
argument across processes: the epoch's *weights* are immutable, so N
workers attach one physical copy. This module is the matching data plane —
the bytes that DO move during an epoch (requests in, completions out)
travel through fixed-slot rings in named POSIX shm segments, so a
dispatcher process hands a worker a request without a pipe write, a pickle,
or a kernel round-trip on the hot path.

Protocol (single-producer / single-consumer per ring)
=====================================================

A ring is a page-sized header plus ``slots`` fixed-size slots. The header
carries seqlock-style cursors: ``head`` (next sequence the producer will
publish) and ``tail`` (next sequence the consumer will take). Each slot
carries a **generation counter**: the sequence number *plus one* of the
publication occupying it (zero = never written — a fresh segment is
zero-filled, so emptiness needs no initialization pass).

* ``push``: read both cursors; ``head - tail >= slots`` means full (the
  producer can never lap the consumer, which is what makes torn reads
  impossible in steady state). Write length + payload into slot
  ``head % slots``, THEN set the slot generation to ``head + 1`` (the
  publication barrier — a reader trusts nothing before it), THEN advance
  ``head``.
* ``pop``: read ``tail``; the slot's generation must equal ``tail + 1`` —
  anything else means "nothing new" (a stale generation from ``slots``
  sequences ago, or a crashed producer's half-written slot, reads as
  *absence*, never as data). Copy the payload out, re-check the generation
  (paranoia against a protocol-violating writer), THEN advance ``tail``.

Every field the two sides share is an aligned 8-byte (or 4-byte) slot in
the mapping written with a single ``struct.pack_into`` — one memcpy on
CPython — and ordered so that the *marker* (generation, cursor) lands only
after the bytes it guards.

Crash discipline mirrors the arena module: the creator writes a record
under ``<root>/shm/<name>.json`` (``kind: "ring"``, owner pid) *before*
the segment becomes attachable, so ``ws.gc()`` can census rings machine-
wide and unlink any whose owner died — a SIGKILLed dispatcher (or a worker
holding a ring) cannot leak a segment past the next gc. A producer that
dies between publishing a slot and advancing ``head`` is healed by
``reconcile()`` on re-attach: a slot generation of ``head + 1`` proves the
publication completed, so the cursor is rolled forward instead of
re-publishing (which would duplicate) or stalling (which would lose it).

MPMC mode (multiple producers, one consumer)
============================================

``create(..., producers=N)`` flips the ring into MPMC mode so several
dispatchers can feed one request ring. The publication discipline is the
same seqlock; what changes is *who owns the next sequence*. A ``claim``
cursor replaces ``head`` as the producer-side authority, and a push
becomes reserve -> write -> publish:

* **reserve** — under a Lamport-bakery lock (the only mutual exclusion
  expressible with aligned single-word loads/stores, which is all CPython
  gives us), read ``claim``, check ``claim - tail < slots``, stamp the
  claimant's pid into the slot header, and advance ``claim``. The critical
  section is three one-word writes.
* **write / publish** — outside the lock, exactly as SPSC: payload bytes,
  THEN the generation word. Publishes may land out of claim order; the
  consumer waits at ``tail`` for each generation in sequence, so claim
  order IS delivery order and a lagging writer reads as absence.

Each producer holds a bakery seat (``producer_id`` in ``[0, N)``) whose
pid is registered in the header, so both the lock's spin loops and
``reconcile()`` can recognize a dead peer: a seat whose pid is gone is
cleared in place, and a *claimed but never published* slot whose claimant
pid is dead is healed with a zero-length tombstone publication — the
consumer skips it silently instead of stalling forever at that sequence.
Torn writes still read as absence (the generation word never landed), and
the crashed producer's reservation costs one tombstoned slot, never a
torn or duplicated frame.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import time
from pathlib import Path

from .errors import StableLinkingError
from .objects import PAGE_BYTES, align_up
from .shm_arena import (
    _require_posixshmem,
    _SegmentNotReady,
    _ShmHandle,
    _shm_unlink,
    shm_records_dir,
)

RING_PREFIX = "repro-ring-"

# Header layout (one page): magic | ready | mode | pad | slots u32 |
# slot_bytes u32 | producers u32 | head u64 | tail u64 | claim u64.
# Cursors are 8-aligned so each read/write is one aligned memcpy. MPMC
# adds the bakery-lock arrays at fixed offsets further into the page.
RING_HEADER_BYTES = PAGE_BYTES
_MAGIC = b"RPRRING1"
_READY_OFF = 8
_MODE_OFF = 9                      # 0 = SPSC, 1 = MPMC
_SLOTS_OFF = 12
_SLOT_BYTES_OFF = 16
_NPROD_OFF = 20
_HEAD_OFF = 24
_TAIL_OFF = 32
_CLAIM_OFF = 40                    # MPMC: next sequence a producer reserves
_CHOOSING_OFF = 64                 # bakery: u8 per seat
_NUMBER_OFF = 128                  # bakery: u64 ticket per seat
_SEAT_PID_OFF = 512                # registered producer pid per seat
MAX_PRODUCERS = 32                 # bakery arrays sized for the header page

# Per-slot layout: generation u64 | payload length u32 | pad u32 |
# claimant pid u64 (MPMC reserve stamp; zero in SPSC mode) | payload.
_SLOT_HDR = 24

# MPMC: a reserved slot whose claimant died before publishing is healed
# by publishing this length — the consumer skips it instead of stalling.
_TOMBSTONE = 0xFFFFFFFF


class ShmRingError(StableLinkingError):
    """A shared-memory ring could not be created, attached, or used."""


def ring_name(root, channel: str) -> str:
    """Content-addressed segment name for one (root, channel) ring."""
    h = hashlib.blake2b(digest_size=16)
    for part in (os.fspath(Path(root).resolve()), channel):
        h.update(part.encode())
        h.update(b"\x00")
    return RING_PREFIX + h.hexdigest()


def _write_ring_record(registry, name: str, channel: str, size: int) -> None:
    d = shm_records_dir(registry)
    d.mkdir(parents=True, exist_ok=True)
    rec = {
        "name": name,
        "kind": "ring",
        "channel": channel,
        "size": size,
        "owner_pid": os.getpid(),
        "created_ts": time.time(),
    }
    tmp = d / f"{name}.json.tmp"
    tmp.write_text(json.dumps(rec, sort_keys=True))
    os.replace(tmp, d / f"{name}.json")


class ShmRing:
    """One ring over a named shm segment: SPSC by default, MPMC on request.

    In SPSC mode exactly one process should ``push`` and exactly one should
    ``pop``; the dispatcher gets a lock-light zero-copy path by giving
    every worker its own request ring and response ring. ``create(...,
    producers=N)`` switches the ring to MPMC: up to N producers (each bound
    to a bakery seat via ``producer_id``) reserve sequences through a
    claim counter and publish independently — see the module docstring for
    the reserve -> write -> publish discipline and its crash healing.
    """

    def __init__(
        self,
        shm: _ShmHandle,
        name: str,
        slots: int,
        slot_bytes: int,
        producers: int = 0,
        producer_id: int | None = None,
    ):
        self.shm = shm
        self.name = name
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.producers = producers          # 0 = SPSC mode
        self._stride = _SLOT_HDR + align_up(slot_bytes, 8)
        self._producer_id: int | None = None
        if producer_id is not None:
            self.bind_producer(producer_id)

    @property
    def mpmc(self) -> bool:
        return self.producers > 0

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def create(
        cls,
        registry,
        channel: str,
        *,
        slots: int,
        slot_bytes: int,
        producers: int = 0,
        producer_id: int | None = None,
    ) -> "ShmRing":
        """Create (and own) the ring for ``channel`` under this root.

        The record is written before the segment turns ready, so a creator
        SIGKILLed at any point leaves either nothing or a husk the next
        ``ws.gc()`` reclaims by its dead owner pid. A leftover segment of
        the same name (a previous crashed run of this channel) is unlinked
        and replaced — rings are owned, never shared-filled like arenas.

        ``producers > 0`` creates the ring in MPMC mode with that many
        bakery seats; pass ``producer_id`` to bind the creator to a seat
        immediately (required before it may ``push``).
        """
        _require_posixshmem()
        if slots < 1 or slot_bytes < 1:
            raise ShmRingError("ring needs slots >= 1 and slot_bytes >= 1")
        if producers < 0 or producers > MAX_PRODUCERS:
            raise ShmRingError(
                f"MPMC ring supports 1..{MAX_PRODUCERS} producers, "
                f"got {producers}"
            )
        name = ring_name(registry.root, channel)
        stride = _SLOT_HDR + align_up(slot_bytes, 8)
        size = RING_HEADER_BYTES + align_up(slots * stride, PAGE_BYTES)
        _write_ring_record(registry, name, channel, size)
        for attempt in range(3):
            try:
                shm = _ShmHandle(name, create=True, size=size)
                break
            except FileExistsError:
                _shm_unlink(name)  # stale ring from a crashed prior owner
        else:  # pragma: no cover - somebody keeps racing this name
            raise ShmRingError(f"ring {name} kept reappearing during create")
        mv = shm.buf
        mv[:RING_HEADER_BYTES] = b"\x00" * RING_HEADER_BYTES
        struct.pack_into("<II", mv, _SLOTS_OFF, slots, slot_bytes)
        struct.pack_into("<I", mv, _NPROD_OFF, producers)
        mv[_MODE_OFF] = 1 if producers else 0
        mv[:8] = _MAGIC
        mv[_READY_OFF] = 1  # attachers trust nothing before this byte
        return cls(shm, name, slots, slot_bytes, producers, producer_id)

    @classmethod
    def attach(
        cls,
        registry,
        channel: str,
        *,
        timeout: float = 30.0,
        producer_id: int | None = None,
    ) -> "ShmRing":
        """Attach the ring for ``channel``, polling until its creator has
        flipped the ready byte (bounded by ``timeout``). On an MPMC ring,
        ``producer_id`` binds this process to its bakery seat — required
        before it may ``push``."""
        _require_posixshmem()
        name = ring_name(registry.root, channel)
        deadline = time.monotonic() + timeout
        while True:
            try:
                shm = _ShmHandle(name)
            except (FileNotFoundError, _SegmentNotReady):
                shm = None
            if shm is not None:
                hdr = bytes(shm.buf[:_NPROD_OFF + 4])
                if hdr[:8] == _MAGIC and hdr[_READY_OFF] == 1:
                    slots, slot_bytes, nprod = struct.unpack_from(
                        "<III", hdr, _SLOTS_OFF
                    )
                    return cls(shm, name, slots, slot_bytes, nprod, producer_id)
                shm.close()
            if time.monotonic() >= deadline:
                raise ShmRingError(
                    f"ring {name} (channel {channel!r}) never became ready "
                    f"within {timeout:.0f}s"
                )
            time.sleep(0.002)

    def bind_producer(self, producer_id: int) -> None:
        """Take bakery seat ``producer_id`` for this process.

        Seats are assigned by the caller's topology (dispatcher i takes
        seat i) — two live producers must never share a seat; the seat's
        registered pid is how lock spins and ``reconcile()`` recognize a
        dead peer and clear its stale state in place."""
        if not self.mpmc:
            raise ShmRingError("bind_producer on an SPSC ring")
        if not 0 <= producer_id < self.producers:
            raise ShmRingError(
                f"producer_id {producer_id} out of range "
                f"[0, {self.producers})"
            )
        self._set_u64(_SEAT_PID_OFF + 8 * producer_id, os.getpid())
        self._producer_id = producer_id

    def close(self) -> None:
        self.shm.close()

    def unlink(self, registry=None) -> bool:
        """Remove the segment machine-wide (and its record, if a registry
        is given). Mappings survive per POSIX unlink semantics."""
        found = _shm_unlink(self.name)
        if registry is not None:
            (shm_records_dir(registry) / f"{self.name}.json").unlink(
                missing_ok=True
            )
        return found

    # ------------------------------------------------------------- internals
    def _u64(self, off: int) -> int:
        return struct.unpack_from("<Q", self.shm.buf, off)[0]

    def _set_u64(self, off: int, v: int) -> None:
        struct.pack_into("<Q", self.shm.buf, off, v)

    def _slot_off(self, seq: int) -> int:
        return RING_HEADER_BYTES + (seq % self.slots) * self._stride

    def _write_payload(self, seq: int, data: bytes) -> None:
        base = self._slot_off(seq)
        mv = self.shm.buf
        struct.pack_into("<I", mv, base + 8, len(data))
        mv[base + _SLOT_HDR : base + _SLOT_HDR + len(data)] = data

    def _publish(self, seq: int) -> None:
        # generation = seq + 1: distinguishes "this sequence, complete"
        # from both a zeroed fresh slot and the slot's previous occupant
        # (whose generation is exactly `slots` smaller)
        self._set_u64(self._slot_off(seq), seq + 1)

    def _advance_head(self, seq: int) -> None:
        self._set_u64(_HEAD_OFF, seq + 1)

    # ------------------------------------------------------- MPMC internals
    def _seat_pid(self, seat: int) -> int:
        return self._u64(_SEAT_PID_OFF + 8 * seat)

    def _clear_seat(self, seat: int) -> None:
        """Erase a dead peer's bakery state in place (ticket first: a
        cleared ticket is what unblocks waiters, the rest is hygiene)."""
        self._set_u64(_NUMBER_OFF + 8 * seat, 0)
        self.shm.buf[_CHOOSING_OFF + seat] = 0
        self._set_u64(_SEAT_PID_OFF + 8 * seat, 0)

    def _bakery_acquire(self, me: int, pid_alive, timeout: float) -> None:
        """Lamport's bakery over header words: the only mutual exclusion
        buildable from aligned one-word loads/stores. A peer seat whose
        registered pid is dead is cleared in place, so a producer killed
        inside the (three-write) critical section cannot wedge the ring."""
        mv = self.shm.buf
        mv[_CHOOSING_OFF + me] = 1
        ticket = 1 + max(
            self._u64(_NUMBER_OFF + 8 * j) for j in range(self.producers)
        )
        self._set_u64(_NUMBER_OFF + 8 * me, ticket)
        mv[_CHOOSING_OFF + me] = 0
        deadline = time.monotonic() + timeout
        for j in range(self.producers):
            if j == me:
                continue
            while mv[_CHOOSING_OFF + j]:
                self._heal_or_wait(me, j, pid_alive, deadline)
            while True:
                nj = self._u64(_NUMBER_OFF + 8 * j)
                if nj == 0 or (nj, j) > (ticket, me):
                    break
                self._heal_or_wait(me, j, pid_alive, deadline)

    def _heal_or_wait(self, me: int, seat: int, pid_alive, deadline) -> None:
        pid = self._seat_pid(seat)
        if pid and not pid_alive(pid):
            self._clear_seat(seat)
            return
        if time.monotonic() >= deadline:  # pragma: no cover - live wedge
            self._set_u64(_NUMBER_OFF + 8 * me, 0)
            raise ShmRingError(
                f"ring {self.name}: bakery seat {seat} (pid {pid}) held "
                "the reserve lock past the acquire timeout"
            )
        time.sleep(0.0002)

    def _bakery_release(self, me: int) -> None:
        self._set_u64(_NUMBER_OFF + 8 * me, 0)

    def _reserve(self, pid_alive=None, timeout: float = 10.0) -> int | None:
        """MPMC reserve: take the next sequence under the bakery lock and
        stamp this producer's pid into the slot header. Returns the
        sequence, or None when the ring is full. The caller owns writing
        + publishing the slot; dying in between costs a tombstone, never
        a torn frame."""
        if self._producer_id is None:
            raise ShmRingError(
                "push on an MPMC ring requires bind_producer(producer_id)"
            )
        if pid_alive is None:
            from .shm_arena import _pid_alive as pid_alive
        me = self._producer_id
        self._bakery_acquire(me, pid_alive, timeout)
        try:
            c = self._u64(_CLAIM_OFF)
            if c - self._u64(_TAIL_OFF) >= self.slots:
                return None
            struct.pack_into(
                "<Q", self.shm.buf, self._slot_off(c) + 16, os.getpid()
            )
            self._set_u64(_CLAIM_OFF, c + 1)
            return c
        finally:
            self._bakery_release(me)

    # -------------------------------------------------------------- protocol
    @property
    def capacity(self) -> int:
        return self.slots

    @property
    def pending(self) -> int:
        """Unconsumed slots (either side may read this). SPSC counts
        published frames; MPMC counts reservations — a claimed slot is
        committed capacity whether or not its payload has landed yet."""
        lead = _CLAIM_OFF if self.mpmc else _HEAD_OFF
        return max(0, self._u64(lead) - self._u64(_TAIL_OFF))

    def reconcile(self, *, pid_alive=None) -> int:
        """Producer-side crash healing; returns the number of slots healed.

        SPSC (call once when adopting the producer role on an existing
        ring): roll ``head`` forward over any slot whose generation proves
        a completed publication the dead producer never cursored.

        MPMC (any producer may call it): clear bakery seats whose pid is
        dead, then publish a zero-length tombstone into every reserved-
        but-unpublished slot whose claimant pid is dead — the consumer
        skips tombstones, so one crashed reservation costs one slot
        instead of stalling the ring at that sequence forever.
        """
        if pid_alive is None:
            from .shm_arena import _pid_alive as pid_alive
        if not self.mpmc:
            h = self._u64(_HEAD_OFF)
            adopted = 0
            for _ in range(self.slots):
                if self._u64(self._slot_off(h)) != h + 1:
                    break
                h += 1
                adopted += 1
            if adopted:
                self._set_u64(_HEAD_OFF, h)
            return adopted
        healed = 0
        for seat in range(self.producers):
            pid = self._seat_pid(seat)
            if pid and not pid_alive(pid):
                self._clear_seat(seat)
        for seq in range(self._u64(_TAIL_OFF), self._u64(_CLAIM_OFF)):
            base = self._slot_off(seq)
            if self._u64(base) == seq + 1:
                continue                   # published: nothing to heal
            claimant = self._u64(base + 16)
            if claimant and pid_alive(claimant):
                continue                   # in flight: leave the writer be
            struct.pack_into("<I", self.shm.buf, base + 8, _TOMBSTONE)
            self._set_u64(base, seq + 1)
            healed += 1
        return healed

    def push(self, data: bytes, *, pid_alive=None) -> bool:
        """Publish one payload; False when the ring is full (backpressure
        is the caller's policy — retry, route elsewhere, or queue)."""
        if len(data) > self.slot_bytes:
            raise ShmRingError(
                f"payload of {len(data)} bytes exceeds ring slot size "
                f"{self.slot_bytes}"
            )
        if self.mpmc:
            seq = self._reserve(pid_alive)
            if seq is None:
                return False
            self._write_payload(seq, data)
            self._publish(seq)
            return True
        h = self._u64(_HEAD_OFF)
        if h - self._u64(_TAIL_OFF) >= self.slots:
            return False
        self._write_payload(h, data)
        self._publish(h)
        self._advance_head(h)
        return True

    def pop(self) -> bytes | None:
        """Take the oldest published payload; None when nothing is ready.

        A half-written slot (producer died before its generation write)
        reads as None — absence, never torn bytes. MPMC tombstones (a
        reconciled dead reservation) are skipped silently."""
        while True:
            t = self._u64(_TAIL_OFF)
            base = self._slot_off(t)
            if self._u64(base) != t + 1:
                return None
            ln = struct.unpack_from("<I", self.shm.buf, base + 8)[0]
            if ln == _TOMBSTONE:
                self._set_u64(_TAIL_OFF, t + 1)
                continue
            if ln > self.slot_bytes:  # pragma: no cover - corrupt writer
                raise ShmRingError(f"slot {t % self.slots} claims {ln} bytes")
            data = bytes(self.shm.buf[base + _SLOT_HDR : base + _SLOT_HDR + ln])
            if self._u64(base) != t + 1:  # pragma: no cover - violator
                return None
            self._set_u64(_TAIL_OFF, t + 1)
            return data


def ring_record(registry, channel: str) -> dict | None:
    """The published record of ``channel``'s ring under this root (owner
    pid, size, creation time), or None when no record exists."""
    path = shm_records_dir(registry) / f"{ring_name(registry.root, channel)}.json"
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


def ring_owner_alive(registry, channel: str, *, pid_alive=None) -> bool | None:
    """Is the process that owns ``channel``'s ring still alive?

    The supervisor's dead-worker detector: a worker owns its response
    ring, so its record's ``owner_pid`` going dead is the authoritative
    signal that the worker is gone (it works even when the supervisor did
    not spawn the worker and has no ``Process`` handle to poll). Returns
    None when no record exists — the ring was never created, or a gc
    already reclaimed it."""
    rec = ring_record(registry, channel)
    if rec is None:
        return None
    if pid_alive is None:
        from .shm_arena import _pid_alive as pid_alive
    return bool(pid_alive(int(rec.get("owner_pid", 0))))


def gc_ring_record(rec: dict, *, pid_alive, segment_ready) -> bool:
    """Should this ``kind: "ring"`` record's segment be reclaimed?

    A ring lives exactly as long as its owner: rings are session-scoped
    conduits, not epoch-scoped caches, so a dead owner pid condemns the
    segment no matter what it contains (its peers can no longer make
    progress on it anyway). ``segment_ready`` is accepted for symmetry
    with the arena rules: a record whose segment is already gone is a
    record-only orphan the caller drops without unlinking."""
    owner = int(rec.get("owner_pid", 0))
    return not pid_alive(owner)

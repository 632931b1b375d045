"""Cross-process shared arenas: one physical copy of a baked arena per machine.

The ``EpochCache`` makes N same-*process* replicas share one read-only
arena mapping. This module extends the paper's "the epoch's relocation
mapping is immutable, so share it" argument across the process boundary:
each baked ``.arena`` image is published once into a named POSIX
shared-memory segment (``multiprocessing.shared_memory``), and every worker
process of a serving fleet *attaches* to that segment instead of paging the
file in privately — N processes, one physical copy, zero per-process fill.

Lifecycle / orphan-reclamation contract
=======================================

**Naming.** Segments are content-addressed: the name is a digest of
``(registry root, app hash, closure hash, generation)``. The *generation*
stamp is the digest of the arena's sidecar, so a re-baked arena (same
closure key, rewritten files) gets a fresh segment instead of silently
aliasing a stale one. Within one (root, app, closure, generation) the arena
bytes are deterministic, so any process may fill the segment and every
other process may trust it.

**Creation is exclusive, attach waits for ``ready``.** Exactly one process
wins the O_EXCL create; it writes a header (magic, generation, size), a
record file under ``<root>/shm/``, then the payload, and flips the header's
``ready`` byte *last*. Racing processes attach and poll ``ready`` (bounded
by ``fill_timeout``); a header whose generation or size disagrees is a
stale husk and is unlinked and re-created. A machine-checkable guarantee
rides on this: the ``ready`` byte asserts the segment is byte-identical to
the ``.arena`` image the resolver materialized (``tests/test_multiprocess``
verifies the identity from a second process).

**Segments deliberately outlive their creator.** Handles go through
``_posixshmem`` directly, bypassing the stdlib wrapper's resource tracker
(which would otherwise unlink the segment when the first registering
process exits — the opposite of a machine-wide cache — and whose
machine-shared cache races sibling processes' register/unregister pairs).
A segment therefore persists until explicitly unlinked; processes that
merely exit (or are SIGKILLed) leave the segment behind for the next
worker, exactly like the page cache keeps a mapped ELF warm.

**Reclamation is explicit and record-driven** (``Workspace.gc`` ->
``gc_segments``). Each creator writes ``<root>/shm/<segment>.json``
*before* filling (name, app/closure hashes, generation, size, creator
pid), so the garbage collector can census every segment this root ever
published, including half-filled husks of crashed creators. A segment is
unlinked when any of:

* its (app hash, closure hash) key is live in no world the caller honours
  (same liveness rule as ``Registry.gc_stores``), or
* its generation stamp no longer matches the on-disk sidecar (re-baked), or
* it never became ``ready`` and its creator pid is dead (crash mid-fill).

Live, ready segments are never touched — a fleet's warm state survives any
number of worker exits. ``shm_unlink`` only removes the name; a process
that still has the segment mapped (or died while mapped) keeps/loses its
mapping per normal POSIX semantics, so reclamation can never corrupt a
running reader — the unlinked-ELF analogy again.

**In-process handles are process-lifetime.** Attached segments are interned
in ``_LIVE_SEGMENTS`` so repeated loads (and epoch-cache refills after a
token bump) reuse one handle, and so no finalizer ever tries to unmap a
segment while numpy views over it are live. ``Workspace.close()`` on an
ephemeral root unlinks everything the root published.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import mmap
import os
import struct
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

import numpy as np

from .errors import StableLinkingError
from .objects import PAGE_BYTES, align_up

try:
    # The C primitive behind multiprocessing.shared_memory. Used directly
    # because the stdlib wrapper registers every handle (create AND attach)
    # with the multiprocessing resource tracker, which (a) unlinks tracked
    # segments when the first registering process exits — the opposite of a
    # machine-wide cache — and (b) keeps ONE tracker cache for all sibling
    # processes, so per-process balanced register/unregister pairs race and
    # spew KeyError noise. Segments here have an explicit, record-driven
    # lifecycle (see gc_segments); no tracker wanted.
    import _posixshmem
except ImportError:  # pragma: no cover - non-POSIX platform
    _posixshmem = None

SEGMENT_PREFIX = "repro-arena-"

# Header layout (one page, so the payload keeps the .arena file's page
# alignment): magic | ready byte | generation (16 raw bytes) | arena size.
HEADER_BYTES = PAGE_BYTES
_MAGIC = b"RPRARNA1"
_READY_OFF = 8
_GEN_OFF = 16
_SIZE_OFF = 32

# segment name -> SharedArenaSegment. Handles are interned for the life of
# the process (see module docstring); bounded by the number of distinct
# (app, closure, generation) arenas this process ever mapped.
_LIVE_SEGMENTS: dict[str, "SharedArenaSegment"] = {}
_LIVE_LOCK = threading.Lock()


class ShmArenaError(StableLinkingError):
    """A shared arena segment could not be published or attached."""


def generation_stamp(meta: dict) -> str:
    """The sidecar's content digest (32 hex chars / 16 raw bytes).

    Computed from the *parsed* sidecar re-serialized canonically, so every
    process derives the same stamp from the same file regardless of how it
    read it."""
    text = json.dumps(meta, sort_keys=True)
    return hashlib.blake2b(text.encode(), digest_size=16).hexdigest()


def segment_name(root, app_hash: str, closure_hash: str, generation: str) -> str:
    """Content-addressed segment name for one (root, app, closure, gen)."""
    h = hashlib.blake2b(digest_size=16)
    for part in (os.fspath(Path(root).resolve()), app_hash, closure_hash, generation):
        h.update(part.encode())
        h.update(b"\x00")
    return SEGMENT_PREFIX + h.hexdigest()


def shm_records_dir(registry) -> Path:
    """Where this root records the segments it published."""
    return registry.root / "shm"


def _require_posixshmem() -> None:
    if _posixshmem is None:  # pragma: no cover - non-POSIX platform
        raise ShmArenaError(
            "shared arena segments need POSIX shared memory "
            "(_posixshmem is unavailable on this platform)"
        )


class _SegmentNotReady(Exception):
    """Attached a segment its creator has not sized/filled yet (transient)."""


class _ShmHandle:
    """Minimal POSIX shared-memory handle (tracker-free by design).

    The stdlib ``SharedMemory`` minus the resource tracker (see the
    ``_posixshmem`` import note) and minus the noisy finalizer: ``close``
    tolerates live numpy exports by simply dropping its references — the
    mapping then lives exactly as long as the arrays over it, reclaimed by
    the C deallocators without a Python exception in sight."""

    __slots__ = ("name", "size", "_mmap", "_buf")

    def __init__(self, name: str, *, create: bool = False, size: int = 0):
        _require_posixshmem()
        flags = os.O_RDWR | (os.O_CREAT | os.O_EXCL if create else 0)
        fd = _posixshmem.shm_open("/" + name, flags, mode=0o600)
        try:
            if create and size:
                os.ftruncate(fd, size)
            self.size = os.fstat(fd).st_size
            if self.size == 0:
                # attach raced the creator between shm_open and ftruncate:
                # a zero-size file cannot be mapped — report it as the
                # transient it is, not a ValueError out of mmap
                raise _SegmentNotReady(name)
            self._mmap = mmap.mmap(fd, self.size)  # mmap keeps its own ref
        finally:
            os.close(fd)
        self._buf: Optional[memoryview] = memoryview(self._mmap)
        self.name = name

    @property
    def buf(self) -> memoryview:
        return self._buf

    def close(self) -> None:
        try:
            if self._buf is not None:
                self._buf.release()
            if self._mmap is not None:
                self._mmap.close()
        except BufferError:
            pass  # views still exported: mapping outlives this handle
        self._buf = None
        self._mmap = None


def _shm_unlink(name: str) -> bool:
    """Remove the name machine-wide (mappings survive, POSIX semantics)."""
    _require_posixshmem()
    try:
        _posixshmem.shm_unlink("/" + name)
    except FileNotFoundError:
        return False
    return True


@dataclass
class SharedArenaSegment:
    """One published arena segment, attached into this process.

    ``attached`` records whether this process found the segment already
    published (the fleet steady state) or had to create and fill it (the
    one fill the whole machine amortizes)."""

    shm: _ShmHandle
    name: str
    arena_size: int
    generation: str
    attached: bool

    def payload(self) -> np.ndarray:
        """Read-only uint8 view of the arena bytes (shared, zero-copy)."""
        if not self.arena_size:
            return np.empty(0, dtype=np.uint8)
        arr = np.frombuffer(
            self.shm.buf, dtype=np.uint8, count=self.arena_size,
            offset=HEADER_BYTES,
        )
        arr.flags.writeable = False
        return arr

    def close(self) -> None:
        """Best-effort unmap (process teardown only; see module docstring)."""
        with _LIVE_LOCK:
            _LIVE_SEGMENTS.pop(self.name, None)
        self.shm.close()


def _validate_header(
    shm: _ShmHandle, generation: str, arena_size: int
) -> str:
    """Classify an existing segment: 'ok' | 'filling' | 'stale'.

    The header writes in ``_fill`` (magic, then generation/size, then
    payload, then ready) are not atomic across processes, so generation
    and size are only judged once ``ready`` is set: before that, a
    mismatch just means we read mid-write — 'filling', never 'stale'
    (misclassifying would unlink a LIVE creator's segment and break the
    one-fill contract). Only a non-zero, non-magic prefix is immediately
    foreign/corrupt."""
    hdr = bytes(shm.buf[: _SIZE_OFF + 8])
    magic = hdr[:8]
    if magic == b"\x00" * 8:
        return "filling"  # creator won the race; header not written yet
    if magic != _MAGIC:
        return "stale"
    if hdr[_READY_OFF] != 1:
        return "filling"
    if (
        hdr[_GEN_OFF : _GEN_OFF + 16] != bytes.fromhex(generation)
        or struct.unpack("<Q", hdr[_SIZE_OFF : _SIZE_OFF + 8])[0] != arena_size
    ):
        return "stale"
    return "ok"


def _write_record(
    registry, name: str, app_hash: str, closure_hash: str,
    generation: str, size: int, arena_size: int, epoch_gen: int = -1,
) -> None:
    d = shm_records_dir(registry)
    d.mkdir(parents=True, exist_ok=True)
    rec = {
        "name": name,
        "app_hash": app_hash,
        "closure_hash": closure_hash,
        "generation": generation,
        "size": size,
        "arena_size": arena_size,
        "created_by_pid": os.getpid(),
        "created_ts": time.time(),
    }
    if epoch_gen >= 0:
        # observability only: which commit generation published this
        # segment (reclamation stays key/generation-stamp driven)
        rec["epoch_gen"] = epoch_gen
    tmp = d / f"{name}.json.tmp"
    tmp.write_text(json.dumps(rec, sort_keys=True))
    os.replace(tmp, d / f"{name}.json")


def _fill(
    shm: _ShmHandle, arena_path: Path,
    arena_size: int, generation: str,
) -> None:
    """Header (ready=0) -> payload -> ready=1. Readers trust ready alone."""
    mv = shm.buf
    mv[:HEADER_BYTES] = b"\x00" * HEADER_BYTES
    mv[:8] = _MAGIC
    mv[_GEN_OFF : _GEN_OFF + 16] = bytes.fromhex(generation)
    mv[_SIZE_OFF : _SIZE_OFF + 8] = struct.pack("<Q", arena_size)
    if arena_size:
        padded = align_up(arena_size, PAGE_BYTES)
        with open(arena_path, "rb") as f:
            f.readinto(memoryview(mv)[HEADER_BYTES : HEADER_BYTES + padded])
    mv[_READY_OFF] = 1


def _creator_alive(registry, name: str) -> bool:
    """Is the recorded creator of ``name`` still running?

    False when the record is missing or unreadable: a creator writes its
    record before filling, so a record-less segment past the fill deadline
    has no creator left to wait for."""
    try:
        rec = json.loads(
            (shm_records_dir(registry) / f"{name}.json").read_text()
        )
        return _pid_alive(int(rec.get("created_by_pid", 0)))
    except (OSError, ValueError):
        return False


def publish_or_attach(
    registry,
    app_hash: str,
    closure_hash: str,
    *,
    arena_path: Path,
    arena_size: int,
    generation: str,
    fill_timeout: float = 10.0,
    epoch_gen: int = -1,
) -> SharedArenaSegment:
    """The one entry point: return the machine-shared segment for this
    (app, closure, generation), publishing it if this process is first.

    Exactly one process can win the exclusive create; everyone else
    attaches and (if the creator is mid-fill) polls the ready byte. A husk
    that never becomes ready within ``fill_timeout`` — its creator died —
    is unlinked and re-created by whoever noticed."""
    name = segment_name(registry.root, app_hash, closure_hash, generation)
    with _LIVE_LOCK:
        live = _LIVE_SEGMENTS.get(name)
    if live is not None:
        return live
    total = HEADER_BYTES + align_up(arena_size, PAGE_BYTES)
    deadline = time.monotonic() + fill_timeout
    takeovers = 0
    # past-deadline creator-liveness probes are throttled: the record read
    # is a file open + json parse per call, and a legitimately slow
    # multi-GB fill would otherwise be probed ~500x/s by every waiter
    creator_alive, next_alive_probe = True, 0.0
    while True:
        try:
            shm = _ShmHandle(name, create=True, size=total)
        except FileExistsError:
            try:
                shm = _ShmHandle(name)
            except FileNotFoundError:
                continue  # raced an unlink between create and attach
            except _SegmentNotReady:
                shm = None  # creator between shm_open and ftruncate
            state = (
                _validate_header(shm, generation, arena_size)
                if shm is not None
                else "filling"
            )
            if state == "ok":
                seg = SharedArenaSegment(
                    shm=shm, name=name, arena_size=arena_size,
                    generation=generation, attached=True,
                )
                with _LIVE_LOCK:
                    _LIVE_SEGMENTS.setdefault(name, seg)
                    return _LIVE_SEGMENTS[name]
            now = time.monotonic()
            if state == "filling" and now >= deadline and now >= next_alive_probe:
                creator_alive = _creator_alive(registry, name)
                next_alive_probe = now + 0.5
            if state == "filling" and (now < deadline or creator_alive):
                # A creator is mid-fill: wait it out. Polls within the
                # deadline are expected (a multi-GB readinto legitimately
                # takes many of them); past the deadline we keep waiting as
                # long as the recorded creator pid is still alive — taking
                # over a LIVE creator's segment would break the
                # one-fill-per-machine contract and double the physical
                # copies. Only a dead creator's husk is taken over.
                if shm is not None:
                    shm.close()
                time.sleep(0.002)
                continue
            # stale/corrupt headers and dead-creator husks, by contrast,
            # should converge within a handful of unlink+recreate cycles
            takeovers += 1
            if takeovers > 8:
                raise ShmArenaError(
                    f"segment {name} kept reappearing stale/unready after "
                    f"{takeovers - 1} takeover attempts"
                )
            # stale generation/size, corrupt header, or a fill that never
            # completed (creator died): unlink the husk and take over
            _shm_unlink(name)
            if shm is not None:
                shm.close()
            continue
        # this process won the exclusive create: publish
        try:
            _write_record(
                registry, name, app_hash, closure_hash, generation,
                total, arena_size, epoch_gen,
            )
            _fill(shm, arena_path, arena_size, generation)
        except BaseException:
            _shm_unlink(name)
            shm.close()
            raise
        seg = SharedArenaSegment(
            shm=shm, name=name, arena_size=arena_size,
            generation=generation, attached=False,
        )
        with _LIVE_LOCK:
            _LIVE_SEGMENTS.setdefault(name, seg)
            return _LIVE_SEGMENTS[name]


@dataclass
class ShmArenaEntry:
    """Epoch-cache entry for one shared arena segment (section ``shm-arena``).

    The shm analogue of ``epoch_cache.ArenaEntry``: parsed sidecar +
    prebuilt read-only slot views, except the backing mapping is the
    machine-shared segment instead of a per-process file mapping. Pinned
    for the epoch (``cache_pinned``): the segment is mapped from creation,
    and evicting the entry would only drop the prebuilt views, not the
    machine-shared bytes."""

    segment: SharedArenaSegment
    meta: dict
    slot_items: list                 # (name, offset, nbytes, dtype, shape)
    arena_size: int
    kernels: dict
    sidecar_stat: tuple              # (mtime_ns, size) of the sidecar at fill
    ro_arena: Optional[np.ndarray] = None
    tensors: Optional[dict[str, np.ndarray]] = None
    _views_lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False
    )

    @property
    def cache_nbytes(self) -> int:
        return self.arena_size

    @property
    def cache_pinned(self) -> bool:
        return True

    def shared_views(self) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        tensors = self.tensors
        if tensors is not None:
            return self.ro_arena, tensors
        with self._views_lock:
            if self.tensors is not None:
                return self.ro_arena, self.tensors
            ro = self.segment.payload()
            self.ro_arena = ro
            self.tensors = {
                name: ro[off : off + nbytes].view(dt).reshape(shape)
                for name, off, nbytes, dt, shape in self.slot_items
            }
            return self.ro_arena, self.tensors


# ----------------------------------------------------------------- census/gc
def list_segments(registry) -> list[dict]:
    """Every segment record this root has published (census order)."""
    d = shm_records_dir(registry)
    out: list[dict] = []
    if not d.exists():
        return out
    for p in sorted(d.glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except (OSError, ValueError):
            continue
    return out


def segment_exists(name: str) -> bool:
    """Does the named segment exist on this machine right now?"""
    _require_posixshmem()
    try:
        fd = _posixshmem.shm_open("/" + name, os.O_RDONLY, mode=0o600)
    except FileNotFoundError:
        return False
    os.close(fd)
    return True


def _segment_ready(name: str) -> Optional[bool]:
    """Ready state of the named segment (None if it no longer exists)."""
    _require_posixshmem()
    try:
        fd = _posixshmem.shm_open("/" + name, os.O_RDONLY, mode=0o600)
    except FileNotFoundError:
        return None
    try:
        hdr = os.pread(fd, _READY_OFF + 1, 0)
        return len(hdr) > _READY_OFF and hdr[:8] == _MAGIC and hdr[_READY_OFF] == 1
    finally:
        os.close(fd)


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    return True


def unlink_segment(name: str) -> bool:
    """Remove the named segment machine-wide (idempotent).

    Processes that still have it mapped keep their mapping — POSIX unlink
    semantics, same as a running binary surviving its ELF being deleted."""
    with _LIVE_LOCK:
        live = _LIVE_SEGMENTS.pop(name, None)
    found = _shm_unlink(name)
    if live is not None:
        live.shm.close()  # tolerant of views still exported
    return found


def gc_segments(
    registry,
    live_keys: Iterable[tuple[str, str]],
    *,
    dry_run: bool = False,
) -> tuple[list[str], int]:
    """Reclaim dead segments of this root (see module docstring's contract).

    ``live_keys`` is the same (app hash, closure key) live set
    ``Registry.gc_stores`` consumes. Returns (removed names, bytes).
    ``dry_run=True`` reports the same condemned segments without unlinking
    anything (segments or records) — the operator preflight."""
    live = {(a[:16], k[:16]) for a, k in live_keys}
    removed: list[str] = []
    bytes_reclaimed = 0
    d = shm_records_dir(registry)
    if not d.exists():
        return removed, bytes_reclaimed
    for rec_path in sorted(d.glob("*.json")):
        try:
            rec = json.loads(rec_path.read_text())
            name = rec["name"]
        except (OSError, ValueError, KeyError):
            continue  # unknown shapes in shm/ are left untouched
        if rec.get("kind") == "ring":
            # Data-plane rings (core.shm_ring) are session conduits, not
            # epoch caches: they live exactly as long as the process that
            # owns them. A dead owner — SIGKILLed dispatcher or worker —
            # condemns the segment regardless of content.
            from . import shm_ring

            if shm_ring.gc_ring_record(
                rec, pid_alive=_pid_alive, segment_ready=_segment_ready
            ):
                if dry_run:
                    if segment_exists(name):
                        removed.append(name)
                        bytes_reclaimed += int(rec.get("size", 0))
                    continue
                if unlink_segment(name):
                    removed.append(name)
                    bytes_reclaimed += int(rec.get("size", 0))
                rec_path.unlink(missing_ok=True)
            continue
        try:
            key = (str(rec["app_hash"])[:16], str(rec["closure_hash"])[:16])
        except KeyError:
            continue  # unknown shapes in shm/ are left untouched
        keep = key in live
        if keep:
            # re-baked since publication: the record's generation no longer
            # matches the sidecar this key would map today
            mpath = registry.arena_meta_path(
                rec["app_hash"], rec["closure_hash"]
            )
            try:
                current_gen = generation_stamp(json.loads(mpath.read_text()))
                keep = current_gen == rec.get("generation")
            except (OSError, ValueError):
                keep = False  # sidecar gone: nothing can validate an attach
        if keep:
            # crash mid-fill: never became ready and its creator is dead
            ready = _segment_ready(name)
            if ready is False and not _pid_alive(int(rec.get("created_by_pid", 0))):
                keep = False
            elif ready is None:
                # segment already gone (another root's gc, reboot): the
                # record is the orphan — drop it without counting bytes
                if not dry_run:
                    rec_path.unlink(missing_ok=True)
                continue
        if keep:
            continue
        if dry_run:
            if segment_exists(name):
                removed.append(name)
                bytes_reclaimed += int(rec.get("size", 0))
            continue
        if unlink_segment(name):
            removed.append(name)
            bytes_reclaimed += int(rec.get("size", 0))
        # already-gone segments (reboot, a sibling root's gc) drop only
        # their record — counting them would inflate bytes_reclaimed
        rec_path.unlink(missing_ok=True)
    return removed, bytes_reclaimed


def unlink_root_segments(registry) -> int:
    """Unlink every segment this root ever recorded (ephemeral teardown)."""
    n = 0
    for rec in list_segments(registry):
        if unlink_segment(rec.get("name", "")):
            n += 1
        (shm_records_dir(registry) / f"{rec.get('name', '')}.json").unlink(
            missing_ok=True
        )
    return n


@atexit.register
def _close_live_segments() -> None:  # pragma: no cover - interpreter exit
    """Release our mappings cleanly before interpreter teardown gets
    nondeterministic; the segments themselves stay published."""
    with _LIVE_LOCK:
        segs = list(_LIVE_SEGMENTS.values())
        _LIVE_SEGMENTS.clear()
    for seg in segs:
        try:
            seg.shm.close()
        except Exception:
            pass


# ------------------------------------------------------------------- fleet
def tensors_digest(tensors) -> str:
    """blake2b-16 over each tensor's raw bytes in sorted name order: the
    reference's digest of what a worker serves. Takes numpy arrays (host
    images; bf16 as its 2-byte stand-in) and torch tensors on any device
    (device views; bf16 as ``torch.bfloat16``) — the same bytes give the
    same digest either way."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(tensors):
        t = tensors[name]
        if isinstance(t, np.ndarray):
            h.update(np.ascontiguousarray(t).reshape(-1).view(np.uint8))
        else:
            import torch

            raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
            h.update(raw.cpu().numpy())
    return h.hexdigest()


def _fleet_worker(root, app_name, strategy, arch, max_new, barrier, queue,
                  store_url=None, device="cuda", smoke=True):
    """Spawn-target for one fleet replica (module-level: picklable by name).

    Imports stay inside the function so a load-only probe never imports the
    serving stack; ``arch`` promotes the worker to a full ``ServeEngine``
    replica on ``device`` (``get_config(arch, smoke=smoke)``) that
    generates ``max_new`` tokens after attaching. Failures are REPORTED,
    not swallowed: the worker pushes a structured error record (exception
    repr + traceback excerpt) so the parent's ``FleetReport`` can name what
    died instead of timing out on silence."""
    import os as _os
    import time as _time

    try:
        from repro_torch.link import Workspace

        ws = Workspace.open(root)
        if store_url:
            # fleet warm-through-store: missing arenas are fetched
            # (verified, resumable, retried) before the shm publish
            ws.attach_store(store_url)
        barrier.wait(timeout=120)
        t0 = _time.perf_counter()
        image = ws.load(app_name, strategy=strategy)
        load_s = _time.perf_counter() - t0
        result = {
            "pid": _os.getpid(),
            "strategy": strategy,
            "load_s": load_s,
            "cache_hit": bool(image.stats.cache_hit),
            "shm_attached": bool(image.stats.shm_attached),
            "segment": image.stats.shm_segment,
            "tensors_digest": tensors_digest(image.tensors),
        }
        if arch is not None:
            from repro_torch.configs import get_config
            from repro_torch.serve import ServeEngine

            cfg = get_config(arch, smoke=smoke)
            engine = ServeEngine.from_workspace(
                cfg, ws, app_name, strategy=strategy, device=device
            )
            rng = np.random.default_rng(0)
            prompts = rng.integers(0, cfg.vocab_size, (2, 8), dtype=np.int32)
            out, stats = engine.generate(prompts, max_new or 4)
            result["tokens_out"] = int(stats.tokens_out)
            result["sample"] = out[0, :4].tolist()
        queue.put(result)
    except BaseException as e:
        import traceback as _tb

        queue.put(
            {
                "pid": _os.getpid(),
                "strategy": strategy,
                "failed": True,
                "error": repr(e),
                "traceback": _tb.format_exc()[-2000:],
            }
        )
        raise


def run_fleet(
    root,
    app_name: str,
    *,
    processes: int = 2,
    strategy: str = "stable-shm",
    arch: Optional[str] = None,
    max_new: int = 0,
    timeout: float = 180.0,
    store_url: Optional[str] = None,
    device="cuda",
    smoke: bool = True,
) -> list[dict]:
    """Spawn ``processes`` real OS worker processes that concurrently load
    ``app_name`` from the workspace at ``root`` and report back. With
    ``arch`` set, each also serves from the load on ``device``, built from
    ``get_config(arch, smoke=smoke)``.

    The exclusive-create protocol guarantees at most ONE worker fills the
    segment; everyone else attaches — the machine-wide analogue of the
    EpochCache's one-fill-per-key contract. Returns one result dict per
    worker: successes carry (pid, segment, shm_attached, load_s,
    tensors_digest, ...); failures carry structured error records
    (``failed``, ``error``, ``traceback``, ``exit_code``) instead of
    stalling the fleet until the timeout — a crashed worker is accounted
    for the moment its process dies (SIGKILL included, in which case the
    record is synthesized from the exit code since the worker never got to
    report its own traceback)."""
    import multiprocessing as mp

    if processes < 1:
        raise ValueError("processes must be >= 1")
    ctx = mp.get_context("spawn")  # never fork a CUDA-initialized parent
    queue = ctx.Queue()
    barrier = ctx.Barrier(processes)
    procs = [
        ctx.Process(
            target=_fleet_worker,
            args=(os.fspath(root), app_name, strategy, arch, max_new,
                  barrier, queue, store_url, str(device), smoke),
            daemon=True,
        )
        for _ in range(processes)
    ]
    import queue as _queue

    deadline = time.monotonic() + timeout
    for p in procs:
        p.start()
    results: list[dict] = []
    synthesized: set[int] = set()  # pids whose death we recorded ourselves

    def reported_pids() -> set:
        return {r.get("pid") for r in results}

    try:
        while len(results) < len(procs) and time.monotonic() < deadline:
            try:
                results.append(queue.get(timeout=0.25))
                continue
            except _queue.Empty:
                pass
            # A dead worker that never reported is a failure record, not a
            # reason to ride out the timeout. Drain once more first: the
            # worker may have pushed its (success or error) record in the
            # instant before exiting.
            dead = [
                p for p in procs
                if not p.is_alive()
                and p.pid not in reported_pids()
                and p.pid not in synthesized
            ]
            if dead:
                try:
                    while True:
                        results.append(queue.get(timeout=0.25))
                except _queue.Empty:
                    pass
                seen = reported_pids()
                for p in dead:
                    if p.pid in seen:
                        continue
                    synthesized.add(p.pid)
                    results.append(
                        {
                            "pid": p.pid,
                            "strategy": strategy,
                            "failed": True,
                            "exit_code": p.exitcode,
                            "error": f"worker exited with code {p.exitcode} "
                                     "before reporting",
                        }
                    )
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    # exit codes enrich the records of workers that DID report an error
    # before dying (their raise re-terminated the process non-zero)
    codes = {p.pid: p.exitcode for p in procs}
    for r in results:
        if r.get("failed") and "exit_code" not in r:
            r["exit_code"] = codes.get(r.get("pid"))
    if len(results) != len(procs):
        raise ShmArenaError(
            f"fleet: {len(results)}/{len(procs)} workers accounted for "
            f"(exit codes {[p.exitcode for p in procs]})"
        )
    return results

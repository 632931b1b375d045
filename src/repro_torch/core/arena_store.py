"""Tiered, content-addressed arena store: one machine bakes, a fleet fetches.

The paper's fleet-scale payoff (shared artifacts, not per-machine dynamic
linking) needs baked ``.arena`` images to move between machines. This
module chains three tiers under one call:

1. **tables/** — the machine already has the baked arena (the baker, or a
   previous fetch): nothing to do.
2. **local store cache** (``<root>/store/``) — a previously fetched and
   *verified* blob is decoded and installed without touching the network.
3. **remote store** — a minimal HTTP object store
   (``repro_torch.launch.store``) is asked for the blob; the fetch path is
   robustness-first (below).
4. **fallback bake** — the remote is unreachable past the retry budget
   and the machine has the payloads locally: bake instead of wedging, and
   surface ``degraded=True`` in the :class:`StoreReport`.

The fetch path treats the remote as untrusted and the network as flaky:

* per-request connect/read timeouts (:class:`FetchPolicy`);
* capped exponential backoff with full jitter and a total retry budget
  per blob;
* resumable downloads — a truncated transfer leaves ``partial/<digest>.part``
  and the next attempt continues with an HTTP ``Range: bytes=N-`` read
  (``fetch_resumed`` counts these) instead of starting over;
* **mandatory content verification**: the blob frame is decoded
  (:mod:`repro_torch.dist.compression`) and the raw bytes' blake2b digest must
  match the index entry before anything is admitted to the local tier.
  A mismatch (flipped bytes, short frame, bogus codec) moves the bytes to
  ``<root>/store/quarantine/`` with a structured JSON record — quarantined
  bytes are never resumed or re-served, and ``ws.gc()`` reclaims them;
* installation into ``tables/`` is atomic (unique temp file +
  ``os.replace``, arena before sidecar) so a crash mid-install can never
  leave an adoptable half-arena — the sidecar's presence is the commit.

Store-on-disk layout (identical for the serving and fetching side, so any
fetcher can later be promoted to a baker/server)::

    <root>/store/
      index.json            entries keyed "<app16>-<key16>" (see below)
      blobs/<digest>        framed blob (repro_torch.dist.compression frame)
      partial/<digest>.part in-flight downloads (fetcher only)
      quarantine/           rejected bytes + structured records (fetcher)
      remote-index.json     last verified remote index (fetcher)

An index entry carries everything install needs: the sidecar JSON inline
(small), the raw-byte digest, raw/encoded sizes, and the codec name.
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import shutil
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.client import HTTPException
from pathlib import Path
from typing import Optional

from repro_torch.dist.compression import CodecError, decode_bytes, encode_bytes

from .errors import StableLinkingError
from .registry import Registry


class ArenaStoreError(StableLinkingError):
    """The store tier could not produce a verified arena (budget exhausted,
    entry absent, or the fallback bake was impossible too)."""


def blob_digest(raw: bytes) -> str:
    """Content address of RAW (decoded) arena bytes — blake2b-128 like
    every other digest in the store."""
    return hashlib.blake2b(bytes(raw), digest_size=16).hexdigest()


def pair_key(app_hash: str, key: str) -> str:
    return f"{app_hash[:16]}-{key[:16]}"


@dataclass
class FetchPolicy:
    """Knobs of the robust fetch path. Defaults suit a LAN store; tests
    shrink everything so chaos runs stay fast."""

    connect_timeout_s: float = 2.0   # also the read timeout per request
    read_timeout_s: float = 5.0
    retry_budget: int = 5            # total retries per blob, all causes
    backoff_base_s: float = 0.05     # first backoff; doubles per retry
    backoff_max_s: float = 2.0       # cap on any single backoff
    jitter: float = 1.0              # 0..1: fraction of the backoff drawn
    chunk_bytes: int = 1 << 18       # stream granularity (256 KiB)


@dataclass
class StoreReport:
    """Counters of one store session (attach → warmup/loads → gc)."""

    degraded: bool = False        # at least one blob came from fallback bake
    fetch_attempts: int = 0       # HTTP requests issued (index + blobs)
    fetch_retries: int = 0        # attempts beyond the first, per blob/index
    fetch_resumed: int = 0        # range-read continuations of a partial
    quarantined: int = 0          # blobs rejected by verification
    fallback_bakes: int = 0       # arenas baked locally after fetch failure
    blobs_fetched: int = 0        # verified blobs admitted from the remote
    bytes_fetched: int = 0        # encoded bytes pulled off the wire
    raw_bytes: int = 0            # decoded bytes those blobs expanded to
    cache_hits: int = 0           # served from <root>/store/blobs
    tables_hits: int = 0          # arena already baked in tables/
    errors: list[str] = field(default_factory=list)

    def summary(self) -> dict:
        return {
            "degraded": self.degraded,
            "fetch_attempts": self.fetch_attempts,
            "fetch_retries": self.fetch_retries,
            "fetch_resumed": self.fetch_resumed,
            "quarantined": self.quarantined,
            "fallback_bakes": self.fallback_bakes,
            "blobs_fetched": self.blobs_fetched,
            "bytes_fetched": self.bytes_fetched,
            "raw_bytes": self.raw_bytes,
            "cache_hits": self.cache_hits,
            "tables_hits": self.tables_hits,
            "errors": list(self.errors),
        }


# ----------------------------------------------------------------- layout
def store_dir(registry: Registry) -> Path:
    return registry.root / "store"


def _index_path(registry: Registry) -> Path:
    return store_dir(registry) / "index.json"


class _CorruptBlob(Exception):
    """Verification failed — quarantine, never admit, never resume."""

    def __init__(self, reason: str, actual: str = ""):
        self.reason = reason
        self.actual = actual
        super().__init__(reason)


# retryable transport failures: refused/reset connections, timeouts,
# truncated responses, DNS blips. Everything content-shaped goes through
# verification instead and quarantines on mismatch.
_RETRYABLE = (urllib.error.URLError, HTTPException, ConnectionError,
              TimeoutError, OSError, EOFError)


# ----------------------------------------------------------------- export
def export_store(registry: Registry, *, codec: str = "zlib") -> dict:
    """Publish every fully baked (arena + sidecar) pair in ``tables/``
    into ``<root>/store/`` as content-addressed blobs + an index.

    Idempotent and incremental: blobs are content-addressed so re-export
    after a commit only encodes the new pairs. Returns a summary dict
    (entries, raw/encoded byte totals, codec)."""
    sdir = store_dir(registry)
    blobs = sdir / "blobs"
    blobs.mkdir(parents=True, exist_ok=True)
    entries: dict[str, dict] = {}
    raw_total = encoded_total = 0
    tables = registry.root / "tables"
    for mpath in sorted(tables.glob("*.arena.json")) if tables.exists() else []:
        apath = mpath.with_suffix("")  # strip .json -> .arena
        if not apath.exists():
            continue  # half-baked pair: never served
        sidecar = json.loads(mpath.read_text())
        raw = apath.read_bytes()
        digest = blob_digest(raw)
        frame = encode_bytes(raw, codec)
        bpath = blobs / digest
        if not bpath.exists():
            tmp = bpath.with_name(f".{digest}.{os.getpid()}.tmp")
            tmp.write_bytes(frame)
            os.replace(tmp, bpath)
        pair = apath.name[: -len(".arena")]
        entries[pair] = {
            "app": sidecar.get("app", ""),
            "app_hash": sidecar.get("app_hash", ""),
            "closure_hash": sidecar.get("closure_hash", ""),
            "digest": digest,
            "raw_bytes": len(raw),
            "blob_bytes": len(frame),
            "codec": codec,
            "sidecar": sidecar,
        }
        raw_total += len(raw)
        encoded_total += len(frame)
    index = {"schema": 1, "codec": codec, "entries": entries}
    tmp = _index_path(registry).with_suffix(".tmp")
    tmp.write_text(json.dumps(index, indent=1, sort_keys=True))
    os.replace(tmp, _index_path(registry))
    return {
        "entries": len(entries),
        "raw_bytes": raw_total,
        "blob_bytes": encoded_total,
        "codec": codec,
        "path": str(sdir),
    }


# --------------------------------------------------------------- local tier
class LocalStoreCache:
    """The verified half of ``<root>/store/`` on a fetching machine."""

    def __init__(self, sdir: Path):
        self.dir = Path(sdir)
        self.blobs = self.dir / "blobs"
        self.partial = self.dir / "partial"
        self.quarantine_dir = self.dir / "quarantine"

    def blob_path(self, digest: str) -> Path:
        return self.blobs / digest

    def has_blob(self, digest: str) -> bool:
        return self.blob_path(digest).exists()

    def partial_path(self, digest: str) -> Path:
        # per-pid: two fleet processes sharing one root must never
        # interleave appends into the same resume buffer. A crash orphans
        # the file; gc_store_dirs reclaims it.
        return self.partial / f"{digest}.{os.getpid()}.part"

    def admit(self, part: Path, digest: str) -> Path:
        """Atomically promote a VERIFIED partial file into blobs/."""
        self.blobs.mkdir(parents=True, exist_ok=True)
        dest = self.blob_path(digest)
        os.replace(part, dest)
        return dest

    def quarantine(
        self, part: Path, *, digest: str, reason: str,
        actual: str = "", url: str = "",
    ) -> Path:
        """Move rejected bytes out of the fetch path, with a record.

        The ``.bad`` file keeps the evidence for debugging; the ``.json``
        record is the structured audit entry. Nothing under quarantine/
        is ever read back by the fetch path — a fresh attempt restarts
        from byte zero."""
        self.quarantine_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        while True:
            base = self.quarantine_dir / f"{digest}-{n}"
            if not base.with_suffix(".bad").exists():
                break
            n += 1
        bad = base.with_suffix(".bad")
        size = 0
        if part.exists():
            size = part.stat().st_size
            os.replace(part, bad)
        else:  # pragma: no cover - defensive: record even without bytes
            bad.write_bytes(b"")
        record = {
            "digest_expected": digest,
            "digest_actual": actual,
            "reason": reason,
            "bytes": size,
            "url": url,
            "ts": time.time(),
            "pid": os.getpid(),
        }
        base.with_suffix(".json").write_text(
            json.dumps(record, indent=1, sort_keys=True)
        )
        return bad


def gc_store_dirs(registry: Registry, *, dry_run: bool = False) -> tuple[list[str], int]:
    """Reclaim the disposable halves of ``<root>/store/``: quarantine
    records and stale partial downloads. Returns (names, bytes).

    Verified blobs and the cached remote index are the warm tier and are
    deliberately kept. Callable whether or not a store was ever attached
    (``Workspace.gc`` always runs it)."""
    removed: list[str] = []
    nbytes = 0
    sdir = store_dir(registry)
    for sub in ("quarantine", "partial"):
        d = sdir / sub
        if not d.exists():
            continue
        for p in sorted(d.iterdir()):
            if not p.is_file():
                continue
            nbytes += p.stat().st_size
            removed.append(f"store/{sub}/{p.name}")
            if not dry_run:
                p.unlink()
    return removed, nbytes


# -------------------------------------------------------------- remote tier
class RemoteStoreClient:
    """Robust HTTP reads against a served store (index + range-read blobs)."""

    def __init__(self, url: str, policy: FetchPolicy, report: StoreReport):
        self.url = url.rstrip("/")
        self.policy = policy
        self.report = report

    # ------------------------------------------------------------- plumbing
    def _open(self, path: str, *, range_start: int = 0):
        req = urllib.request.Request(f"{self.url}{path}")
        if range_start:
            req.add_header("Range", f"bytes={range_start}-")
        self.report.fetch_attempts += 1
        return urllib.request.urlopen(
            req, timeout=max(self.policy.connect_timeout_s,
                             self.policy.read_timeout_s)
        )

    def _backoff(self, attempt: int) -> None:
        p = self.policy
        span = min(p.backoff_base_s * (2 ** attempt), p.backoff_max_s)
        if p.jitter:
            span = span * (1.0 - p.jitter) + random.uniform(0, span * p.jitter)
        time.sleep(span)

    # ---------------------------------------------------------------- index
    def fetch_index(self) -> dict:
        last: Exception | None = None
        for attempt in range(self.policy.retry_budget + 1):
            if attempt:
                self.report.fetch_retries += 1
                self._backoff(attempt - 1)
            try:
                with self._open("/index.json") as resp:
                    return json.loads(resp.read().decode())
            except (json.JSONDecodeError, *_RETRYABLE) as e:
                last = e
        raise ArenaStoreError(
            f"store index unreachable after {self.policy.retry_budget} "
            f"retries: {self.url}/index.json ({last!r})"
        )

    # ---------------------------------------------------------------- blobs
    def fetch_blob(self, entry: dict, cache: LocalStoreCache) -> bytes:
        """Fetch + verify one blob; returns the RAW (decoded) bytes.

        Resumes partial downloads, quarantines anything that fails
        verification, and raises :class:`ArenaStoreError` once the retry
        budget is spent."""
        digest = entry["digest"]
        blob_bytes = int(entry["blob_bytes"])
        url = f"{self.url}/blobs/{digest}"
        part = cache.partial_path(digest)
        last: Exception | None = None
        for attempt in range(self.policy.retry_budget + 1):
            if attempt:
                self.report.fetch_retries += 1
                self._backoff(attempt - 1)
            try:
                self._download_once(url, digest, part, blob_bytes)
                frame = part.read_bytes()
                try:
                    raw = decode_bytes(frame)
                except CodecError as e:
                    raise _CorruptBlob(f"frame does not decode: {e}") from e
                actual = blob_digest(raw)
                if actual != digest:
                    raise _CorruptBlob("content digest mismatch", actual)
                cache.admit(part, digest)
                self.report.blobs_fetched += 1
                self.report.bytes_fetched += len(frame)
                self.report.raw_bytes += len(raw)
                return raw
            except _CorruptBlob as e:
                # bytes leave the fetch path entirely; next attempt
                # restarts from zero (never resume quarantined bytes)
                cache.quarantine(
                    part, digest=digest, reason=e.reason,
                    actual=e.actual, url=url,
                )
                self.report.quarantined += 1
                last = e
            except _RETRYABLE as e:
                last = e  # partial (if any) is kept for a range resume
        raise ArenaStoreError(
            f"blob {digest} unfetchable after {self.policy.retry_budget} "
            f"retries from {url} (last: {last!r})"
        )

    def _download_once(
        self, url_path: str, digest: str, part: Path, blob_bytes: int
    ) -> None:
        """One transfer attempt into ``part``; raises a retryable error on
        truncation (leaving the partial for resume) or :class:`_CorruptBlob`
        on overrun."""
        part.parent.mkdir(parents=True, exist_ok=True)
        have = part.stat().st_size if part.exists() else 0
        if have > blob_bytes:
            raise _CorruptBlob(
                f"partial larger than advertised blob ({have} > {blob_bytes})"
            )
        mode = "ab"
        if have and have < blob_bytes:
            self.report.fetch_resumed += 1
        if have == blob_bytes:
            return  # complete; verification decides its fate
        with self._open(f"/blobs/{digest}", range_start=have) as resp:
            if have and resp.status == 200:
                # server ignored the Range header: restart the file
                have, mode = 0, "wb"
            with open(part, mode) as f:
                while True:
                    chunk = resp.read(self.policy.chunk_bytes)
                    if not chunk:
                        break
                    f.write(chunk)
                    have += len(chunk)
        if have < blob_bytes:
            raise EOFError(
                f"short transfer: {have}/{blob_bytes} bytes (will resume)"
            )
        if have > blob_bytes:
            raise _CorruptBlob(
                f"overlong transfer: {have}/{blob_bytes} bytes"
            )


# ---------------------------------------------------------------- the tiers
class TieredStore:
    """shm → tables/ → local store cache → remote → fallback bake.

    One instance is attached per :class:`~repro_torch.link.workspace.Workspace`
    (``ws.attach_store``); ``ensure_arena`` is what the ``stable-remote``
    strategy calls when the baked arena is missing locally. Thread-safe:
    concurrent warmup workers asking for the same pair serialize on a
    per-pair lock, distinct pairs proceed in parallel."""

    def __init__(
        self,
        registry: Registry,
        url: Optional[str] = None,
        *,
        policy: Optional[FetchPolicy] = None,
        codec: str = "zlib",
    ):
        self.registry = registry
        self.url = url.rstrip("/") if url else None
        self.policy = policy or FetchPolicy()
        self.codec = codec
        self.report = StoreReport()
        self.cache = LocalStoreCache(store_dir(registry))
        self.client = (
            RemoteStoreClient(self.url, self.policy, self.report)
            if self.url
            else None
        )
        self._index: Optional[dict] = None
        self._index_error: Optional[ArenaStoreError] = None
        # Held across the whole index fetch: a warmup's worker threads must
        # not each pay the retry budget against a dead store — one thread
        # pays, the rest observe the memoized result (or memoized failure).
        self._index_lock = threading.Lock()
        self._lock = threading.Lock()
        self._pair_locks: dict[str, threading.Lock] = {}

    # ------------------------------------------------------------- plumbing
    def _pair_lock(self, pair: str) -> threading.Lock:
        with self._lock:
            lock = self._pair_locks.get(pair)
            if lock is None:
                lock = self._pair_locks[pair] = threading.Lock()
            return lock

    @property
    def _remote_index_path(self) -> Path:
        return store_dir(self.registry) / "remote-index.json"

    def _load_index(self) -> dict:
        """The remote's index: memoized, then the on-disk copy from a
        previous session, then the network (cached to disk on success)."""
        with self._index_lock:
            if self._index is not None:
                return self._index
            if self._index_error is not None:
                # the index already exhausted its budget this session:
                # fail fast so a dead store costs one budget per warmup,
                # not one per app (close() re-arms)
                raise self._index_error
            if self.client is not None:
                try:
                    index = self.client.fetch_index()
                    p = self._remote_index_path
                    p.parent.mkdir(parents=True, exist_ok=True)
                    tmp = p.with_suffix(f".{os.getpid()}.tmp")
                    tmp.write_text(json.dumps(index, sort_keys=True))
                    os.replace(tmp, p)
                except ArenaStoreError as e:
                    index = self._disk_index()
                    if index is None:
                        self._index_error = e
                        raise
            else:
                index = self._disk_index()
                if index is None:
                    raise ArenaStoreError(
                        "no remote URL and no cached store index "
                        f"under {store_dir(self.registry)}"
                    )
            self._index = index
            return index

    def _disk_index(self) -> Optional[dict]:
        for p in (self._remote_index_path, _index_path(self.registry)):
            if p.exists():
                try:
                    return json.loads(p.read_text())
                except (OSError, json.JSONDecodeError):
                    continue
        return None

    # ------------------------------------------------------------ main path
    def ensure_arena(self, executor, app, world, key: str) -> str:
        """Make ``tables/`` hold the baked arena for (app, key); returns
        the tier that produced it: ``"tables"``, ``"cache"``, ``"remote"``
        or ``"bake"`` (the degraded fallback)."""
        pair = pair_key(app.content_hash, key)
        with self._pair_lock(pair):
            apath = self.registry.arena_path(app.content_hash, key)
            mpath = self.registry.arena_meta_path(app.content_hash, key)
            if apath.exists() and mpath.exists():
                self.report.tables_hits += 1
                return "tables"
            try:
                entry = self._index_entry(pair, app, key)
                if entry is not None and self.cache.has_blob(entry["digest"]):
                    raw = self._verified_cached_blob(entry)
                    if raw is not None:
                        self._install(entry, raw, apath, mpath)
                        self.report.cache_hits += 1
                        return "cache"
                if entry is not None and self.client is not None:
                    raw = self.client.fetch_blob(entry, self.cache)
                    self._install(entry, raw, apath, mpath)
                    return "remote"
                raise ArenaStoreError(
                    f"pair {pair} not available from the store"
                    + ("" if entry is None else " (no remote client)")
                )
            except ArenaStoreError as e:
                self.report.errors.append(str(e))
                return self._fallback_bake(executor, app, world, key, e)

    def _index_entry(self, pair: str, app, key: str) -> Optional[dict]:
        entry = self._load_index().get("entries", {}).get(pair)
        if entry is None:
            return None
        # an index lying about whose arena this is must not install bytes
        # under the wrong key — treat like corruption, not like a miss
        if (
            entry.get("app_hash") != app.content_hash
            or entry.get("closure_hash") != key
        ):
            raise ArenaStoreError(
                f"store index entry {pair} names a different (app, closure)"
            )
        return entry

    def _verified_cached_blob(self, entry: dict) -> Optional[bytes]:
        """Re-verify a locally cached blob before every install: a corrupt
        byte on the local disk must not become epoch-visible either."""
        bpath = self.cache.blob_path(entry["digest"])
        try:
            raw = decode_bytes(bpath.read_bytes())
            if blob_digest(raw) == entry["digest"]:
                return raw
            reason = "cached blob digest mismatch"
        except CodecError as e:
            reason = f"cached blob does not decode: {e}"
        except OSError:
            return None
        self.cache.quarantine(
            bpath, digest=entry["digest"], reason=reason,
            url=str(bpath),
        )
        self.report.quarantined += 1
        return None

    def _install(self, entry: dict, raw: bytes, apath: Path, mpath: Path) -> None:
        """Atomically land verified bytes as tables/<pair>.arena(.json).

        Arena first, sidecar last: every reader treats the sidecar's
        presence as the commit point (materialize_all's reuse check,
        _build_arena_entry), so a crash between the two renames leaves a
        harmless orphan, never an adoptable half-arena."""
        sidecar = entry["sidecar"]
        if int(sidecar.get("arena_size", 0)) > len(raw):
            raise ArenaStoreError(
                f"blob {entry['digest']}: sidecar arena_size "
                f"{sidecar.get('arena_size')} exceeds blob ({len(raw)} bytes)"
            )
        pid = os.getpid()
        atmp = apath.with_name(f".{apath.name}.{pid}.fetch")
        atmp.write_bytes(raw)
        os.replace(atmp, apath)
        mtmp = mpath.with_name(f".{mpath.name}.{pid}.fetch")
        mtmp.write_text(json.dumps(sidecar, sort_keys=True))
        os.replace(mtmp, mpath)

    def _fallback_bake(self, executor, app, world, key, cause) -> str:
        if executor is None:
            raise cause
        try:
            executor.materialize(app, world, executor.manager.epoch, key=key)
        except Exception as bake_err:
            raise ArenaStoreError(
                f"store fetch failed ({cause}) and local bake failed too "
                f"({bake_err!r})"
            ) from cause
        self.report.fallback_bakes += 1
        self.report.degraded = True
        return "bake"

    # ------------------------------------------------------------ utilities
    def close(self) -> None:
        """Drop the memoized index and any memoized index failure (tests
        flip servers mid-session; a recovered store gets a fresh chance)."""
        with self._index_lock:
            self._index = None
            self._index_error = None


def reset_store_dir(registry: Registry) -> None:
    """Testing helper: wipe ``<root>/store/`` entirely."""
    shutil.rmtree(store_dir(registry), ignore_errors=True)

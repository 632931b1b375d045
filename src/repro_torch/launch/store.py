"""A minimal served arena store: the remote tier of ``repro_torch.core.arena_store``.

``StoreServer`` serves one ``<root>/store/`` directory over HTTP:

* ``GET /index.json`` — the export index (pair key -> entry);
* ``GET /blobs/<digest>`` — one framed blob, with single-range
  ``Range: bytes=N-`` support (``206 Partial Content`` + ``Content-Range``)
  so truncated fetches can RESUME instead of restarting.

That is the whole protocol — a stand-in for any dumb object store
(S3-alike, nginx in front of a disk). Deliberately no auth, no uploads:
the baker writes the directory locally (``ws.export_store()``) and this
process only ever reads it.

For the chaos tier the server takes a
:class:`~repro_torch.serve.faults.StoreFaultPlan` and injects network faults on
the WIRE (refused connects, mid-stream truncation, flipped payload bytes,
slow-loris stalls, flapping, dying after N requests) while the on-disk
bytes stay pristine — proving that client-side verification alone keeps
corrupt bytes out of the fleet.

Run standalone on a baking machine::

    python -m repro_torch.launch.store --root /path/to/ws-root --port 8742

or in-process (tests, vignettes)::

    with StoreServer(store_dir, faults=StoreFaultPlan(flip_n=1)) as srv:
        ws.warmup(store=srv.url)
"""

from __future__ import annotations

import argparse
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

from repro_torch.serve.faults import StoreFaultPlan


class StoreFaultState:
    """Thread-safe per-server fault bookkeeping over a StoreFaultPlan."""

    def __init__(self, plan: Optional[StoreFaultPlan]):
        self.plan = plan
        self.lock = threading.Lock()
        self.requests = 0      # requests admitted a verdict (refused or not)
        self.refused = 0
        self.truncated = 0
        self.flipped = 0
        self.stalled = 0
        self._blob_requests = 0

    def verdict(self) -> str:
        """'refuse' drops the connection before any response bytes."""
        p = self.plan
        with self.lock:
            n = self.requests
            self.requests += 1
            if p is None:
                return "ok"
            if p.down_after >= 0 and n >= p.down_after:
                self.refused += 1
                return "refuse"
            if n < p.refuse_n:
                self.refused += 1
                return "refuse"
            if p.flap_every > 0 and (n + 1) % p.flap_every == 0:
                self.refused += 1
                return "refuse"
            return "ok"

    def blob_mutation(self) -> dict:
        """Per-blob-request wire mutations: {} means serve honestly."""
        p = self.plan
        if p is None:
            return {}
        out: dict = {}
        with self.lock:
            self._blob_requests += 1
            if p.truncate_n > 0 and p.truncate_at >= 0:
                p.truncate_n -= 1
                self.truncated += 1
                out["truncate_at"] = p.truncate_at
            if p.flip_n > 0 and p.flip_at >= 0:
                p.flip_n -= 1
                self.flipped += 1
                out["flip_at"] = p.flip_at
            if p.stall_n > 0 and p.stall_s > 0:
                p.stall_n -= 1
                self.stalled += 1
                out["stall_s"] = p.stall_s
        return out

    def counters(self) -> dict:
        with self.lock:
            return {
                "requests": self.requests,
                "refused": self.refused,
                "truncated": self.truncated,
                "flipped": self.flipped,
                "stalled": self.stalled,
            }


class _Handler(BaseHTTPRequestHandler):
    server_version = "ReproArenaStore/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 - quiet by default
        if getattr(self.server, "verbose", False):  # pragma: no cover
            super().log_message(fmt, *args)

    def _refuse(self) -> None:
        # no status line, no headers: the client sees a reset/empty reply,
        # indistinguishable from a dead or refusing endpoint
        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:  # pragma: no cover
            pass

    def do_GET(self):  # noqa: N802 - http.server API
        state: StoreFaultState = self.server.fault_state
        if state.verdict() == "refuse":
            self._refuse()
            return
        sdir: Path = self.server.store_dir
        if self.path == "/index.json":
            self._send_file(sdir / "index.json", mutate={})
        elif self.path.startswith("/blobs/"):
            name = self.path[len("/blobs/"):]
            if "/" in name or name.startswith("."):
                self.send_error(404)
                return
            self._send_file(sdir / "blobs" / name, mutate=state.blob_mutation())
        else:
            self.send_error(404)

    def _range_start(self, total: int) -> Optional[int]:
        """Parse a single open-ended 'bytes=N-' range; None = no/bad range."""
        header = self.headers.get("Range", "")
        if not header.startswith("bytes="):
            return None
        spec = header[len("bytes="):]
        if "," in spec or not spec.endswith("-"):
            return None
        try:
            start = int(spec[:-1])
        except ValueError:
            return None
        if 0 <= start < total:
            return start
        return None

    def _send_file(self, path: Path, *, mutate: dict) -> None:
        try:
            data = path.read_bytes()
        except OSError:
            self.send_error(404)
            return
        total = len(data)
        start = self._range_start(total)
        if start is None:
            body = data
            self.send_response(200)
        else:
            body = data[start:]
            self.send_response(206)
            self.send_header(
                "Content-Range", f"bytes {start}-{total - 1}/{total}"
            )
        body = bytearray(body)
        # faults are expressed in WHOLE-BLOB offsets so a resumed range
        # read does not get re-corrupted at its own relative offset
        off = start or 0
        flip_at = mutate.get("flip_at", -1)
        if 0 <= flip_at - off < len(body):
            body[flip_at - off] ^= 0xFF
        truncate_at = mutate.get("truncate_at", -1)
        truncated = False
        if truncate_at >= 0 and truncate_at - off < len(body):
            body = body[: max(0, truncate_at - off)]
            truncated = True
        self.send_header("Content-Type", "application/octet-stream")
        # advertise the HONEST length: a truncated stream must look like a
        # network failure (short read), not like a smaller resource
        self.send_header(
            "Content-Length", str(total - off if start is not None else total)
        )
        self.send_header("Accept-Ranges", "bytes")
        self.end_headers()
        stall_s = mutate.get("stall_s", 0.0)
        try:
            half = len(body) // 2
            self.wfile.write(bytes(body[:half]))
            if stall_s:
                self.wfile.flush()
                time.sleep(stall_s)
            self.wfile.write(bytes(body[half:]))
            if truncated:
                # drop the link without the remaining advertised bytes:
                # the client sees a short/aborted read mid-stream
                self.close_connection = True
                self.wfile.flush()
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:  # pragma: no cover
                    pass
        except (BrokenPipeError, ConnectionResetError, ValueError):
            # client hung up first (its read timeout beat our stall)
            self.close_connection = True


class StoreServer:
    """Background-thread HTTP server over one exported store directory."""

    def __init__(
        self,
        store_dir: str | Path,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        faults: Optional[StoreFaultPlan] = None,
        verbose: bool = False,
    ):
        self.store_dir = Path(store_dir)
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.store_dir = self.store_dir
        self.httpd.fault_state = StoreFaultState(faults)
        self.httpd.verbose = verbose
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    @property
    def fault_state(self) -> StoreFaultState:
        return self.httpd.fault_state

    def start(self) -> "StoreServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever,
            kwargs={"poll_interval": 0.05},
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "StoreServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="serve a baked arena store")
    ap.add_argument("--root", required=True, help="workspace root (serves <root>/store)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8742)
    ap.add_argument(
        "--export", action="store_true",
        help="export <root>/tables into <root>/store before serving",
    )
    args = ap.parse_args(argv)
    root = Path(args.root)
    if args.export:
        from repro_torch.core.arena_store import export_store
        from repro_torch.core.registry import Registry

        summary = export_store(Registry(root))
        print(f"exported {summary['entries']} blobs "
              f"({summary['raw_bytes']} -> {summary['blob_bytes']} bytes)")
    sdir = root / "store"
    if not (sdir / "index.json").exists():
        print(f"no index at {sdir}/index.json — run with --export on a baked root")
        return 1
    srv = StoreServer(sdir, host=args.host, port=args.port, verbose=True)
    print(f"serving {sdir} at {srv.url} (ctrl-c to stop)")
    try:
        srv.httpd.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        srv.httpd.server_close()
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

"""The port's tiered arena store under network faults, its store launcher,
and the wire between the port and the reference.

The chaos cases are those of ``tests/test_store_chaos.py`` run on the
port's ``Workspace``, ``TieredStore``, ``FetchPolicy``, ``StoreServer``
and ``StoreFaultPlan``: whatever the wire does — truncate, flip bytes,
stall, refuse, die — a load through ``stable-remote`` serves bytes
identical to the baker's ``.arena`` or degrades to a local bake, within
bounded time. The wire cases hold the port's launcher and client against
the reference's on one deterministic world; the CLI cases run
``python -m repro_torch.launch.store`` in a subprocess.
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from urllib.parse import urlparse

import numpy as np
import pytest

pytest.importorskip("_posixshmem")  # stable-remote publishes to POSIX shm

from repro_torch.core import (
    PAGE_BYTES,
    EpochCache,
    ObjectKind,
    SymbolDef,
    SymbolRef,
    align_up,
    make_object,
    shm_arena,
)
from repro_torch.core.arena_store import FetchPolicy, TieredStore, export_store
from repro_torch.launch.store import StoreServer
from repro_torch.link import Workspace
from repro_torch.serve.faults import StoreFaultPlan

SRC = Path(__file__).resolve().parents[1] / "src"

# Tight budgets: every fault mode must converge (or give up) fast enough
# for a test tier. A wedge shows up as a test timeout, which is the bug.
POLICY = FetchPolicy(
    connect_timeout_s=1.0,
    read_timeout_s=1.0,
    retry_budget=6,
    backoff_base_s=0.01,
    backoff_max_s=0.1,
    chunk_bytes=1 << 14,
)
BOUND_S = 30.0  # generous wall bound; typical faulted fetches take < 2s


def _build_bundle(name: str, tensors: dict, version="1"):
    """Page-aligned bundle from named numpy tensors (the port's twin of the
    reference conftest's ``build_bundle``: the same bytes and hashes)."""
    payload = bytearray()
    syms = []
    for tname in sorted(tensors):
        arr = np.ascontiguousarray(tensors[tname])
        off = len(payload)
        payload.extend(arr.tobytes())
        payload.extend(b"\x00" * (align_up(len(payload), PAGE_BYTES) - len(payload)))
        syms.append(SymbolDef(tname, tuple(arr.shape), str(arr.dtype), off, arr.nbytes))
    return make_object(name=name, version=version, kind=ObjectKind.BUNDLE,
                       symbols=syms, payload=bytes(payload))


def _build_app(name: str, refs, needed):
    app, _ = make_object(name=name, version="1", kind=ObjectKind.APPLICATION,
                         refs=refs, needed=needed)
    return app


def _make_world(ws, *, apps=1, value=3.0, bundle=_build_bundle, app=_build_app,
                ref=SymbolRef):
    """Deterministic world: same (value, apps) -> same hashes everywhere,
    whichever package's objects build it."""
    names = []
    with ws.management() as tx:
        for i in range(apps):
            tensors = {
                "w": np.full((96, 64), value + i, np.float32),
                "b": np.arange(512, dtype=np.float32) * (value + i),
            }
            tx.publish(*bundle(f"lib{i}", tensors))
            tx.publish(app(
                f"app{i}",
                [ref("w", (96, 64), "float32"), ref("b", (512,), "float32")],
                [f"lib{i}"],
            ))
            names.append(f"app{i}")
    return names


def _strip_bakes(ws) -> int:
    """The fresh-machine simulation: objects present, tables/ empty."""
    n = 0
    for p in Path(ws.root).glob("tables/*"):
        p.unlink()
        n += 1
    assert n, "nothing to strip — world was never baked?"
    return n


def _arena_bytes(ws, name: str) -> bytes:
    world = ws.world()
    app = world.resolve(name)
    key = ws.executor.closure_key(app, world)
    return ws.registry.arena_path(app.content_hash, key).read_bytes()


@pytest.fixture()
def baker(tmp_path):
    ws = Workspace.open(tmp_path / "baker", epoch_cache=EpochCache())
    try:
        yield ws
    finally:
        shm_arena.unlink_root_segments(ws.registry)


@pytest.fixture()
def fetcher(tmp_path):
    ws = Workspace.open(tmp_path / "fetcher", epoch_cache=EpochCache())
    try:
        yield ws
    finally:
        shm_arena.unlink_root_segments(ws.registry)


def _serve(baker, faults=None) -> StoreServer:
    baker.export_store()
    return StoreServer(Path(baker.root) / "store", faults=faults).start()


def _attach(fetcher, url) -> TieredStore:
    return fetcher.attach_store(url, policy=POLICY)


def _blob_len(baker) -> int:
    summary = baker.export_store()
    assert summary["entries"] >= 1
    return summary["blob_bytes"] // summary["entries"]


# ---------------------------------------------------------------- happy path
def test_cold_fetch_is_byte_identical_and_publishes_shm(baker, fetcher):
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    srv = _serve(baker)
    try:
        _attach(fetcher, srv.url)
        img = fetcher.load(names[0], strategy="stable-remote")
    finally:
        srv.stop()
    assert img.stats.store_source == "remote"
    assert img.stats.shm_segment          # download-then-publish-to-shm
    np.testing.assert_array_equal(img["w"], np.full((96, 64), 3.0, np.float32))
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])
    report = fetcher.store_report()
    assert report.blobs_fetched == 1 and not report.degraded
    assert 0 < report.bytes_fetched < report.raw_bytes


def test_warm_load_skips_the_store_entirely(baker, fetcher):
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    srv = _serve(baker)
    try:
        _attach(fetcher, srv.url)
        fetcher.load(names[0], strategy="stable-remote")
        attempts = fetcher.store_report().fetch_attempts
        img = fetcher.load(names[0], strategy="stable-remote")
    finally:
        srv.stop()
    assert img.stats.cache_hit            # EpochCache, no tier walk
    assert img.stats.store_source == "tables"
    assert fetcher.store_report().fetch_attempts == attempts


def test_local_store_cache_serves_without_a_server(baker, fetcher):
    """A verified blob in <root>/store survives a dead remote AND a
    re-stripped tables/: the next install needs no network at all."""
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    srv = _serve(baker)
    try:
        _attach(fetcher, srv.url)
        fetcher.load(names[0], strategy="stable-remote")
    finally:
        srv.stop()                        # remote is now gone
    _strip_bakes(fetcher)
    ws2 = Workspace.open(fetcher.root, epoch_cache=EpochCache())
    ws2.attach_store(srv.url, policy=POLICY)  # dead URL on purpose
    img = ws2.load(names[0], strategy="stable-remote")
    assert img.stats.store_source == "cache"
    assert not ws2.store_report().degraded
    assert _arena_bytes(ws2, names[0]) == _arena_bytes(baker, names[0])


# ------------------------------------------------------------- fault modes
def test_truncated_fetch_resumes_not_restarts(baker, fetcher):
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    blob_len = _blob_len(baker)
    srv = _serve(baker, StoreFaultPlan(truncate_at=blob_len // 2, truncate_n=1))
    try:
        _attach(fetcher, srv.url)
        t0 = time.monotonic()
        fetcher.load(names[0], strategy="stable-remote")
        wall = time.monotonic() - t0
    finally:
        srv.stop()
    report = fetcher.store_report()
    assert report.fetch_resumed >= 1      # range read, not a restart
    assert report.fetch_retries >= 1
    assert report.quarantined == 0        # truncation is a transport fault
    assert not report.degraded
    assert wall < BOUND_S
    assert srv.fault_state.counters()["truncated"] == 1
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])


def test_flipped_byte_quarantines_and_never_admits(baker, fetcher):
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    blob_len = _blob_len(baker)
    srv = _serve(baker, StoreFaultPlan(flip_at=blob_len // 3, flip_n=1))
    try:
        _attach(fetcher, srv.url)
        fetcher.load(names[0], strategy="stable-remote")
    finally:
        srv.stop()
    report = fetcher.store_report()
    assert report.quarantined == 1
    assert report.blobs_fetched == 1      # the clean retry made it
    assert not report.degraded
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])
    qdir = Path(fetcher.root) / "store" / "quarantine"
    records = sorted(qdir.glob("*.json"))
    assert len(records) == 1
    rec = json.loads(records[0].read_text())
    assert rec["reason"]
    assert rec["digest_expected"]
    assert rec["bytes"] >= 0
    assert sorted(qdir.glob("*.bad")), "quarantine kept no evidence bytes"
    blobs = list((Path(fetcher.root) / "store" / "blobs").glob("*"))
    assert len(blobs) == 1                # only the VERIFIED blob landed
    g = fetcher.gc()
    assert g.store_files_removed == 2     # .bad + .json
    assert not list(qdir.glob("*"))
    assert list((Path(fetcher.root) / "store" / "blobs").glob("*"))


def test_refused_connects_retry_within_budget(baker, fetcher):
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    srv = _serve(baker, StoreFaultPlan(refuse_n=2))
    try:
        _attach(fetcher, srv.url)
        fetcher.load(names[0], strategy="stable-remote")
    finally:
        srv.stop()
    report = fetcher.store_report()
    assert report.fetch_retries >= 2
    assert not report.degraded
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])


def test_flapping_server_converges_bounded(baker, fetcher):
    names = _make_world(baker, apps=2)
    _make_world(fetcher, apps=2)
    _strip_bakes(fetcher)
    srv = _serve(baker, StoreFaultPlan(flap_every=2))  # every 2nd req refused
    try:
        _attach(fetcher, srv.url)
        t0 = time.monotonic()
        report = fetcher.warmup(names, store=None)  # store already attached
        wall = time.monotonic() - t0
    finally:
        srv.stop()
    assert report.strategy == "stable-remote"
    assert not report.degraded
    assert wall < BOUND_S
    sr = fetcher.store_report()
    assert sr.blobs_fetched == 2 and sr.fetch_retries >= 1
    for n in names:
        assert _arena_bytes(fetcher, n) == _arena_bytes(baker, n)


def test_slow_loris_stall_times_out_and_recovers(baker, fetcher):
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    # stall far beyond the read timeout: the client must cut the cord
    srv = _serve(baker, StoreFaultPlan(stall_s=8.0, stall_n=1))
    try:
        _attach(fetcher, srv.url)
        t0 = time.monotonic()
        fetcher.load(names[0], strategy="stable-remote")
        wall = time.monotonic() - t0
    finally:
        srv.stop()
    report = fetcher.store_report()
    assert report.fetch_retries >= 1
    assert not report.degraded
    assert wall < 8.0                     # did NOT sit out the full stall
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])


def test_always_corrupt_store_exhausts_budget_then_bakes(baker, fetcher):
    """A store that flips a byte on EVERY transfer can never get a blob
    admitted: the budget exhausts, quarantine fills, and the load still
    serves correct bytes via the local fallback bake."""
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    blob_len = _blob_len(baker)
    srv = _serve(baker, StoreFaultPlan(flip_at=blob_len // 2, flip_n=10_000))
    try:
        _attach(fetcher, srv.url)
        img = fetcher.load(names[0], strategy="stable-remote")
    finally:
        srv.stop()
    report = fetcher.store_report()
    assert img.stats.store_source == "bake"
    assert report.degraded and report.fallback_bakes == 1
    assert report.quarantined >= 1
    assert report.blobs_fetched == 0      # nothing corrupt was EVER admitted
    assert not list((Path(fetcher.root) / "store" / "blobs").glob("*"))
    assert report.errors
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])


def test_dead_store_degrades_warmup_with_fallback_bakes(baker, fetcher):
    names = _make_world(baker, apps=2)
    _make_world(fetcher, apps=2)
    _strip_bakes(fetcher)
    t0 = time.monotonic()
    report = fetcher.warmup(names, store="http://127.0.0.1:9", policy=POLICY)
    wall = time.monotonic() - t0
    assert report.degraded
    assert report.store["fallback_bakes"] == 2
    assert wall < BOUND_S                 # degrade, don't wedge
    # the index failure was paid ONCE, not once per app
    assert fetcher.store_report().fetch_attempts <= POLICY.retry_budget + 1
    for n in names:
        np.testing.assert_array_equal(
            report.images[n]["w"], baker.load(n, strategy="stable-shm")["w"])


def test_store_dies_mid_warmup_degrades_not_wedges(baker, fetcher):
    """The store serves the index + the first blob, then drops dead:
    warmup completes with a mix of fetched and fallback-baked arenas, all
    byte-identical to the baker's."""
    names = _make_world(baker, apps=3)
    _make_world(fetcher, apps=3)
    _strip_bakes(fetcher)
    srv = _serve(baker, StoreFaultPlan(down_after=2))
    try:
        _attach(fetcher, srv.url)
        t0 = time.monotonic()
        report = fetcher.warmup(names, workers=1)  # deterministic order
        wall = time.monotonic() - t0
    finally:
        srv.stop()
    assert report.strategy == "stable-remote"
    assert report.degraded
    sr = fetcher.store_report()
    assert sr.blobs_fetched >= 1          # the store was really used...
    assert sr.fallback_bakes >= 1         # ...and really died mid-warmup
    assert sr.blobs_fetched + sr.fallback_bakes == 3
    assert wall < BOUND_S
    for n in names:
        assert _arena_bytes(fetcher, n) == _arena_bytes(baker, n)


def test_fleet_warm_through_store(baker, fetcher):
    """One bake, N processes: workers with only the store URL
    download-then-publish-to-shm and share one segment."""
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    srv = _serve(baker)
    try:
        workers = shm_arena.run_fleet(
            fetcher.root, names[0], processes=3,
            strategy="stable-remote", timeout=120.0, store_url=srv.url,
        )
    finally:
        srv.stop()
    assert len(workers) == 3
    assert not any(w.get("failed") for w in workers), workers
    assert len({w["segment"] for w in workers}) == 1
    assert len({w["tensors_digest"] for w in workers}) == 1
    assert len([w for w in workers if not w["shm_attached"]]) == 1
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])


def test_bogus_index_entry_is_rejected_not_installed(baker, fetcher):
    """An index that names the wrong (app, closure) for a pair must not
    get its bytes installed under our key — fallback bake instead."""
    names = _make_world(baker)
    _make_world(fetcher)
    _strip_bakes(fetcher)
    baker.export_store()
    idx_path = Path(baker.root) / "store" / "index.json"
    idx = json.loads(idx_path.read_text())
    for entry in idx["entries"].values():
        entry["closure_hash"] = "0" * 32   # lie about the closure
    idx_path.write_text(json.dumps(idx))
    srv = StoreServer(Path(baker.root) / "store").start()
    try:
        _attach(fetcher, srv.url)
        img = fetcher.load(names[0], strategy="stable-remote")
    finally:
        srv.stop()
    assert img.stats.store_source == "bake"
    report = fetcher.store_report()
    assert report.degraded and report.errors
    assert _arena_bytes(fetcher, names[0]) == _arena_bytes(baker, names[0])


# ------------------------------------------------ the wire, port and reference
def _ref():
    """The reference's store tier and a world builder on its objects."""
    from conftest import build_app, build_bundle
    from repro.core import EpochCache as RefEpochCache
    from repro.core import SymbolRef as RefSymbolRef
    from repro.core.arena_store import FetchPolicy as RefFetchPolicy
    from repro.launch.store import StoreServer as RefStoreServer
    from repro.link import Workspace as RefWorkspace

    policy = RefFetchPolicy(**{k: getattr(POLICY, k) for k in (
        "connect_timeout_s", "read_timeout_s", "retry_budget", "backoff_base_s",
        "backoff_max_s", "chunk_bytes")})

    def workspace(root):
        return RefWorkspace.open(root, epoch_cache=RefEpochCache())

    def world(ws, apps):
        return _make_world(ws, apps=apps, bundle=build_bundle, app=build_app,
                           ref=RefSymbolRef)

    return workspace, world, RefStoreServer, policy


def _port_side():
    def workspace(root):
        return Workspace.open(root, epoch_cache=EpochCache())

    def world(ws, apps):
        return _make_world(ws, apps=apps)

    return workspace, world, StoreServer, POLICY


def _side(which):
    return _port_side() if which == "port" else _ref()


@pytest.mark.parametrize("server", ["port", "reference"])
def test_wire_both_clients_fetch_from_either_server(tmp_path, server):
    """Each package's ``TieredStore`` fetches a 3-app world from the other
    package's server (and from its own): the installed arenas are the
    baker's bytes, and the two clients count the same ``StoreReport``."""
    b_ws, b_world, Server, _ = _side(server)
    baker = b_ws(tmp_path / "baker")
    names = b_world(baker, 3)
    baker.export_store()
    summaries = {}
    with Server(Path(baker.root) / "store") as srv:
        for client in ("port", "reference"):
            c_ws, c_world, _, policy = _side(client)
            ws = c_ws(tmp_path / f"fetch-{client}")
            try:
                assert c_world(ws, 3) == names
                _strip_bakes(ws)
                ws.attach_store(srv.url, policy=policy)
                report = ws.warmup(names, workers=1)
                assert report.strategy == "stable-remote" and not report.degraded
                for n in names:
                    assert _arena_bytes(ws, n) == _arena_bytes(baker, n), (client, n)
                summaries[client] = ws.store_report().summary()
            finally:
                shm_arena.unlink_root_segments(ws.registry)
    assert summaries["port"] == summaries["reference"]
    assert summaries["port"]["blobs_fetched"] == 3


def _get(url: str, path: str, headers=None):
    u = urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Range"), resp.read()
    finally:
        conn.close()


def test_wire_both_servers_send_the_same_bytes(tmp_path):
    """``GET /index.json``, a ``Range: bytes=N-`` read of one blob (206 and
    the same ``Content-Range``), a whole blob and a 404 are the same
    bytes from either package's server over one exported store."""
    baker = Workspace.open(tmp_path / "baker", epoch_cache=EpochCache())
    _make_world(baker, apps=2)
    baker.export_store()
    sdir = Path(baker.root) / "store"
    digest = sorted(p.name for p in (sdir / "blobs").iterdir())[0]
    start = (sdir / "blobs" / digest).stat().st_size // 3
    _, _, RefServer, _ = _ref()
    got = {}
    for name, Server in (("port", StoreServer), ("reference", RefServer)):
        with Server(sdir) as srv:
            got[name] = [
                _get(srv.url, "/index.json"),
                _get(srv.url, f"/blobs/{digest}", {"Range": f"bytes={start}-"}),
                _get(srv.url, f"/blobs/{digest}"),
                _get(srv.url, "/blobs/nope")[0],
            ]
    assert got["port"] == got["reference"]
    index, ranged, whole, missing = got["port"]
    assert index == (200, None, (sdir / "index.json").read_bytes())
    total = len(whole[2])
    assert ranged[0] == 206 and ranged[1] == f"bytes {start}-{total - 1}/{total}"
    assert ranged[2] == whole[2][start:]
    assert missing == 404


@pytest.mark.parametrize("codec", ["zlib", "none"])
def test_export_store_writes_the_same_bytes_as_the_reference(tmp_path, codec):
    from repro.core.arena_store import export_store as ref_export_store

    ws = Workspace.open(tmp_path / "port", epoch_cache=EpochCache())
    _make_world(ws, apps=2)
    r_ws, r_world, _, _ = _ref()
    ref = r_ws(tmp_path / "reference")
    r_world(ref, 2)
    ours = export_store(ws.registry, codec=codec)
    theirs = ref_export_store(ref.registry, codec=codec)
    assert {k: v for k, v in ours.items() if k != "path"} == \
        {k: v for k, v in theirs.items() if k != "path"}

    def tree(root):
        sdir = Path(root) / "store"
        return {str(p.relative_to(sdir)): p.read_bytes()
                for p in sorted(sdir.rglob("*")) if p.is_file()}

    assert tree(ws.root) == tree(ref.root)
    assert len(tree(ws.root)) == 3        # 2 blobs + index.json


# ------------------------------------------------------------------- the CLI
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(SRC), PYTHONUNBUFFERED="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.store", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_cli_exports_a_baked_root_and_serves_its_index(baker):
    _make_world(baker, apps=2)
    proc = _cli("--root", str(baker.root), "--port", "0", "--export")
    try:
        first = proc.stdout.readline()
        assert first.startswith("exported 2 blobs"), first + proc.stderr.read()
        line = proc.stdout.readline()
        assert line.startswith("serving "), line
        url = line.split(" at ")[1].split()[0]
        status, _, body = _get(url, "/index.json")
        assert status == 200
        assert body == (Path(baker.root) / "store" / "index.json").read_bytes()
        assert len(json.loads(body)["entries"]) == 2
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_cli_refuses_a_root_with_no_index(tmp_path):
    proc = _cli("--root", str(tmp_path), "--port", "0")
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 1
    assert "no index" in out


# ------------------------------------------------------- a served smoke fleet
def test_smoke_fleet_serves_through_the_store(tmp_path):
    """``spawn_fleet`` with only a store URL: gemma3-1b's smoke app is
    fetched (not baked) on a fresh root, published to shm once, and each
    worker decodes from it on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import publish_model
    from repro_torch.serve import ServeEngine

    cfg = get_config("gemma3-1b", smoke=True)
    roots = [Workspace.open(tmp_path / n, epoch_cache=EpochCache())
             for n in ("baker", "fetcher")]
    baker, fetcher = roots
    try:
        app = publish_model(baker, cfg, device="cpu")
        assert publish_model(fetcher, cfg, device="cpu") == app
        _strip_bakes(fetcher)
        srv = _serve(baker)
        try:
            fleet = ServeEngine.spawn_fleet(
                fetcher, app, processes=2, strategy="stable-remote",
                arch="gemma3-1b", max_new=2, store_url=srv.url, device="cpu",
                timeout=180)
        finally:
            srv.stop()
        assert fleet.failed == 0, fleet.errors
        assert fleet.fills == 1 and len(fleet.segments) == 1
        digests = {w["tensors_digest"] for w in fleet.workers}
        assert digests == {shm_arena.tensors_digest(
            baker.load(app, strategy="stable").tensors)}
        assert _arena_bytes(fetcher, app) == _arena_bytes(baker, app)
    finally:
        for ws in roots:
            shm_arena.unlink_root_segments(ws.registry)

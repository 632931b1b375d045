"""The port's fleet and its supervised traffic plane: ``spawn_fleet``
across worker processes (against the reference's digest of the same
generation), a worker SIGKILLed mid-stream under supervision, and the
launcher's ``--fleet``/``--traffic`` options.

Every drive here runs gemma3-1b's smoke config on the CPU (``device=
"cpu"``), at most 10 requests and 4 new tokens each."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import EpochCache as RefEpochCache
from repro.link import Workspace as RefWorkspace
from repro_torch.configs import get_config
from repro_torch.core import EpochCache, shm_arena
from repro_torch.launch import serve as launch_serve
from repro_torch.link import Workspace
from repro_torch.serve import ServeEngine, run_traffic

pytest.importorskip("_posixshmem")  # POSIX shared memory required

ARCH = "gemma3-1b"
PROMPT, NEW = 20, 4
JOIN_S = 90.0
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture()
def port_root(tmp_path):
    """(port workspace, app) on a root the port published; its shm
    leftovers are unlinked on teardown."""
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    app = launch_serve.publish_model(ws, get_config(ARCH, smoke=True), device="cpu")
    try:
        yield ws, app
    finally:
        shm_arena.unlink_root_segments(ws.registry)


def _ref_digest(root, app) -> str:
    """The reference's blake2b-16 over its own load of the generation."""
    img = RefWorkspace.open(root, epoch_cache=RefEpochCache()).load(
        app, strategy="stable-mmap-cached")
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(img.tensors):
        h.update(np.ascontiguousarray(img.tensors[name]).view(np.uint8).tobytes())
    return h.hexdigest()


# ----------------------------------------------------------- supervision
def test_sigkilled_worker_midstream_rerouted_stream_intact(port_root):
    """Worker 0 SIGKILLs itself at its 5th decode step: its warmup takes
    steps 1-3 (4 new tokens), and a step runs only with a request in a
    slot, so it dies holding a popped, unanswered request. The supervisor
    re-routes it, respawns the worker, and every stream reassembles whole
    and equal to its completion row."""
    ws, app = port_root
    n = 8
    rep = run_traffic(ws, app, arch=ARCH, workers=2, n_requests=n, rate_hz=100.0,
                      prompt_len=PROMPT, max_new_tokens=NEW, max_batch=2,
                      stream=True, temperature=0.7, top_k=8, sampling_seed=42,
                      supervise=True, faults={"die_at_step": 5, "worker": 0},
                      device="cpu", timeout=JOIN_S * 2)
    s = rep.summary()
    assert rep.sent == n and rep.completed == n, s          # zero lost
    assert rep.restarts >= 1 and rep.rerouted_requests >= 1, s
    assert rep.failed == 0, s                # a supervised death is no failure
    assert rep.stream_gaps == 0 and rep.stream_mismatches == 0, s
    assert set(rep.stream_tokens) == set(range(n)), s
    for toks in rep.stream_tokens.values():
        assert len(toks) == NEW
    assert rep.kill_p99_s > 0 and np.isfinite(rep.kill_p99_s), s
    assert len(rep.ready_s) == 2 + rep.restarts
    # the killed worker left no statistics file; its replacement did
    assert sorted(w["worker"] for w in rep.worker_stats) == [0, 1]


def test_mamba2_sigkilled_worker_respawned_zero_lost(tmp_path):
    """The reference's ``test_chaos.py::test_sigkilled_worker_respawned_zero_lost``
    on the port, with mamba2-370m (the reference's serving workhorse): 10
    requests at 100 Hz into 2 supervised workers, worker 0 SIGKILLed at its
    6th decode step (after its warmup's 3), streamed; 10 of 10 complete and
    every stream reassembles whole."""
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    arch = "mamba2-370m"
    app = launch_serve.publish_model(ws, get_config(arch, smoke=True), device="cpu")
    n = 10
    try:
        rep = run_traffic(ws, app, arch=arch, workers=2, n_requests=n, rate_hz=100.0,
                          prompt_len=10, max_new_tokens=NEW, max_batch=2, stream=True,
                          supervise=True, faults={"die_at_step": 6, "worker": 0},
                          device="cpu", timeout=JOIN_S * 2)
    finally:
        shm_arena.unlink_root_segments(ws.registry)
    s = rep.summary()
    assert rep.sent == n and rep.completed == n, s          # zero lost
    assert rep.restarts >= 1 and rep.rerouted_requests >= 1 and rep.failed == 0, s
    assert rep.stream_gaps == 0 and rep.stream_mismatches == 0, s
    assert set(rep.stream_tokens) == set(range(n)), s
    assert all(len(t) == NEW for t in rep.stream_tokens.values()), s
    assert rep.kill_p99_s > 0 and np.isfinite(rep.kill_p99_s), s


# ----------------------------------------------------------------- fleet
def test_fleet_shares_one_segment_with_the_references_bytes(tmp_path):
    """Two load-only stable-shm workers on a root the reference published:
    at most one fills the segment, both digest the same bytes, and those
    are the reference's bytes of the same generation."""
    from repro import models as ref_models
    from repro.ckpt import bundle_from_params as ref_bundle
    from repro.configs import get_config as ref_config
    from repro.core import ObjectKind, make_object

    ref = RefWorkspace.open(tmp_path / "store", epoch_cache=RefEpochCache())
    cfg = ref_config(ARCH, smoke=True)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(cfg, 0).items()}
    bundle, payload = ref_bundle(f"weights:{cfg.name}", "v1", params)
    app, _ = make_object(name=f"serve:{cfg.name}", version="1",
                         kind=ObjectKind.APPLICATION,
                         refs=ref_models.manifest_refs(cfg), needed=[bundle.name])
    with ref.management() as tx:
        tx.publish(bundle, payload)
        tx.publish(app)
    ws = Workspace.open(ref.root, epoch_cache=EpochCache())
    try:
        report = ServeEngine.spawn_fleet(ws, app.name, processes=2, timeout=JOIN_S)
        s = report.summary()
        assert report.failed == 0 and len(report.workers) == 2, s
        assert report.fills <= 1 and report.fills + report.attaches == 2, s
        assert len(report.segments) == 1, s
        digests = {w["tensors_digest"] for w in report.workers}
        assert digests == {_ref_digest(ref.root, app.name)}, s
    finally:
        shm_arena.unlink_root_segments(ws.registry)


def test_fleet_replicas_decode_on_the_requested_device(port_root):
    ws, app = port_root
    report = ServeEngine.spawn_fleet(ws, app, processes=2, arch=ARCH, max_new=4,
                                     device="cpu", timeout=JOIN_S)
    s = report.summary()
    assert report.failed == 0 and report.fills <= 1, s
    samples = [w["sample"] for w in report.workers]
    assert all(w["tokens_out"] == 2 * 4 for w in report.workers), s
    assert samples[0] == samples[1] and all(0 <= t < 256 for t in samples[0])


def test_fleet_worker_crash_is_structured_and_fast(port_root):
    """A worker that dies reports a structured error record with an exit
    code within seconds, not at the join timeout."""
    ws, _ = port_root
    t0 = time.monotonic()
    report = ServeEngine.spawn_fleet(ws, "no-such-app", processes=2, timeout=JOIN_S)
    assert time.monotonic() - t0 < JOIN_S / 2
    assert report.failed == 2 and report.fills == 0 and report.attaches == 0
    for err in report.summary()["errors"]:
        assert err["exit_code"] not in (None, 0)
        assert "no-such-app" in err["error"] or err["traceback"]


# -------------------------------------------------------------- launcher
def test_serve_with_fleet_and_traffic_options(port_root):
    ws, _ = port_root
    cfg = get_config(ARCH, smoke=True)
    run = launch_serve.serve(cfg, ws, batch=2, prompt_len=PROMPT, max_new=NEW,
                             device="cpu", fleet=2, traffic=2, requests=4,
                             rate_hz=100.0, stream=True)
    fleet, traffic = run.summary["fleet"], run.summary["traffic"]
    assert fleet["failed"] == 0 and fleet["fills"] <= 1 and fleet["processes"] == 2
    assert traffic["completed"] == 4 and traffic["failed_workers"] == 0, traffic
    assert traffic["partial_frames"] == 4 * NEW and traffic["stream_gaps"] == 0
    assert traffic["arch"] == ARCH and len(traffic["worker_stats"]) == 2
    json.dumps(run.summary)                       # the CLI prints it as JSON


def test_config_source_rebuilds_registry_configs_only():
    assert launch_serve.config_source(get_config(ARCH, smoke=True)) == (ARCH, True)
    assert launch_serve.config_source(get_config(ARCH)) == (ARCH, False)
    with pytest.raises(ValueError, match="rebuild their config"):
        launch_serve.config_source(get_config(ARCH, smoke=True).replace(num_layers=3))


def test_launcher_cli_prints_traffic_and_fleet_blocks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--traffic", "2", "--requests", "4", "--max-new", "4",
         "--stream", "--fleet", "2", "--batch", "2", "--prompt-len", str(PROMPT)],
        env=env, capture_output=True, text=True, timeout=240, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout)
    assert out["fleet"]["failed"] == 0 and out["traffic"]["completed"] == 4
    assert out["traffic"]["partial_frames"] == 16

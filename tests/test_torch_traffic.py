"""The port's traffic plane against the reference's: the bytes on the wire,
rings shared across the two packages, and a Poisson load through spawned
port workers whose tokens and adoption digests equal the reference's on
the same Workspace root.

Every drive here runs gemma3-1b's smoke config on the CPU (``device=
"cpu"``), two workers, at most 10 requests and 4 new tokens each."""

from __future__ import annotations

import hashlib
import json
import math
import multiprocessing as mp
import time

import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.core import EpochCache as RefEpochCache
from repro.core.shm_ring import ShmRing as RefShmRing
from repro.link import Workspace as RefWorkspace
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import traffic as ref_traffic
from repro_torch import models
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import get_config
from repro_torch.core import EpochCache, shm_arena
from repro_torch.core.shm_ring import ShmRing
from repro_torch.launch.serve import publish_model
from repro_torch.link import Workspace
from repro_torch.serve import STOP, Request, ServeEngine, run_traffic
from repro_torch.serve import traffic

pytest.importorskip("_posixshmem")  # POSIX shared memory required

ARCH = "gemma3-1b"        # smoke: 2 layers, window 16 on layer 0, vocab 256
PROMPT, NEW = 20, 4       # prompts longer than the smoke window
JOIN_S = 90.0


def _ref_publish(ws, arch=ARCH):
    """The reference's ``tests/test_traffic.py`` ``_publish_model``: weights
    drawn by the reference's ``init_params``, bundle and app published."""
    from repro import models as ref_models
    from repro.ckpt import bundle_from_params as ref_bundle
    from repro.core import ObjectKind, make_object

    cfg = ref_config(arch, smoke=True)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(cfg, 0).items()}
    bundle, payload = ref_bundle(f"weights:{cfg.name}", "v1", params)
    app, _ = make_object(
        name=f"serve:{cfg.name}", version="1", kind=ObjectKind.APPLICATION,
        refs=ref_models.manifest_refs(cfg), needed=[bundle.name])
    with ws.management() as tx:
        tx.publish(bundle, payload)
        tx.publish(app)
    return app.name


@pytest.fixture()
def ref_root(tmp_path):
    """(port workspace, app) on a root the reference published; the port's
    shm leftovers are unlinked on teardown."""
    ref = RefWorkspace.open(tmp_path / "store", epoch_cache=RefEpochCache())
    app = _ref_publish(ref)
    ws = Workspace.open(ref.root, epoch_cache=EpochCache())
    try:
        yield ws, app
    finally:
        shm_arena.unlink_root_segments(ws.registry)


@pytest.fixture()
def port_root(tmp_path):
    """(port workspace, app) on a root the port published."""
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    app = publish_model(ws, get_config(ARCH, smoke=True), device="cpu")
    try:
        yield ws, app
    finally:
        shm_arena.unlink_root_segments(ws.registry)


def _ref_digest(tensors) -> str:
    """The reference's digest, as its worker computes it."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(tensors):
        h.update(np.ascontiguousarray(tensors[name]).view(np.uint8).tobytes())
    return h.hexdigest()


def _no_ring_left(ws):
    return list(shm_arena.shm_records_dir(ws.registry).glob("repro-ring-*.json")) == []


# ------------------------------------------------------------------ wire
_ADOPTED = json.dumps({"worker": 1, "epoch_gen": 3, "digest": "ab" * 16}).encode()
FRAMES = {
    # name: (how to build it from a traffic module, which decoder reads it)
    "request_clock": (lambda m: m.encode_request(7, np.arange(5), 4, 12.5), "request"),
    "request_no_clock": (lambda m: m.encode_request(8, [3, 1], 2, None), "request"),
    "request_deadline_priority": (
        lambda m: m.encode_request(9, [4], 1, 0.0, 0.25, 2), "request"),
    "stop": (lambda m: m._REQ_HDR.pack(m._RID_STOP, 0, 0, 0.0, 0.0, 0), "request"),
    "completion_ok": (
        lambda m: m.encode_completion(7, np.array([5, 6]), 1.0, 2.0, 0.5), "completion"),
    "completion_deadline": (
        lambda m: m.encode_completion(7, np.array([5]), 1.0, 2.0, None, "deadline"),
        "completion"),
    "partial": (lambda m: m.encode_partial(7, 3, [9, 10], 4.5), "completion"),
    "ready": (lambda m: m._encode_blob(m._RID_READY, b"", 1.25), "completion"),
    "error": (lambda m: m._encode_blob(m._RID_ERROR, b"ValueError: x\n"), "completion"),
    "adopted": (lambda m: m._encode_blob(m._RID_ADOPTED, _ADOPTED), "completion"),
}


def _same_decoded(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        elif isinstance(x, float) and math.isnan(x):
            assert math.isnan(y)
        else:
            assert x == y


@pytest.mark.parametrize("frame", sorted(FRAMES))
def test_wire_frames_are_the_references_bytes_both_ways(frame):
    build, kind = FRAMES[frame]
    port, ref = build(traffic), build(ref_traffic)
    assert port == ref
    dec = "decode_request" if kind == "request" else "decode_completion"
    got_port = getattr(traffic, dec)(ref)          # port reads the reference's
    got_ref = getattr(ref_traffic, dec)(port)      # reference reads the port's
    _same_decoded(got_port, got_ref)


def test_wire_constants_equal_the_references():
    for name in ("RING_SLOTS", "_RID_WARM", "_RID_STOP", "_RID_READY",
                 "_RID_ERROR", "_RID_ADOPTED", "_STATUS_NAMES"):
        assert getattr(traffic, name) == getattr(ref_traffic, name), name
    assert traffic._REQ_HDR.format == ref_traffic._REQ_HDR.format
    assert traffic._RSP_HDR.format == ref_traffic._RSP_HDR.format
    for p, n in ((12, 8), (1024, 32), (256, 600), (1, 1)):
        assert traffic.ring_slot_bytes(p, n) == ref_traffic.ring_slot_bytes(p, n)
    assert traffic.req_channel("s", 3) == ref_traffic.req_channel("s", 3)
    assert traffic.rsp_channel("s", 3) == ref_traffic.rsp_channel("s", 3)


def test_prompt_draw_caps_ids_at_the_vocabulary():
    small, gaps = traffic.draw_prompts(256, 50, 30, 4.0, seed=3)
    assert small.max() < 256 and small.dtype == np.int32 and gaps.shape == (50,)
    # at gemma3-1b's published vocabulary the draw is the reference's exactly
    full, _ = traffic.draw_prompts(262144, 6, 9, 4.0, seed=3)
    rng = np.random.default_rng(3)
    want = rng.integers(0, 32000, (6, 9), dtype=np.int32)
    np.testing.assert_array_equal(full, want)
    np.testing.assert_array_equal(
        traffic.draw_prompts(262144, 6, 9, 4.0, seed=3)[1],
        rng.exponential(1.0 / 4.0, 6))


# ------------------------------------------------- rings across packages
@pytest.mark.parametrize("mpmc", [False, True], ids=["spsc", "mpmc"])
@pytest.mark.parametrize("creator", ["port", "reference"])
def test_rings_cross_packages(tmp_path, creator, mpmc):
    """A ring created by one package on a root is attached and read by the
    other's ``ShmRing``; on an MPMC ring the attacher produces too."""
    port_ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    ref_ws = RefWorkspace.open(port_ws.root, epoch_cache=RefEpochCache())
    sides = {"port": (ShmRing, port_ws.registry, traffic),
             "reference": (RefShmRing, ref_ws.registry, ref_traffic)}
    other = "reference" if creator == "port" else "port"
    (Cls, reg, mod), (OCls, oreg, omod) = sides[creator], sides[other]
    ring = Cls.create(reg, "t/x", slots=8, slot_bytes=mod.ring_slot_bytes(PROMPT, NEW),
                      producers=2 if mpmc else 0, producer_id=0 if mpmc else None)
    peer = OCls.attach(oreg, "t/x", timeout=5.0, producer_id=1 if mpmc else None)
    try:
        sent = [mod.encode_request(i, np.arange(PROMPT) + i, NEW, float(i)) for i in range(3)]
        for frame in sent:
            assert ring.push(frame)
        for i in range(3):
            rid, toks, max_new, enq, _, _ = omod.decode_request(peer.pop())
            assert (rid, max_new, enq) == (i, NEW, float(i))
            np.testing.assert_array_equal(toks, np.arange(PROMPT) + i)
        assert peer.pop() is None
        if mpmc:
            assert peer.push(omod.encode_partial(5, 0, [1, 2]))
            assert ring.push(mod.encode_partial(6, 0, [3]))
            got = [mod.decode_completion(ring.pop())[:2] for _ in range(2)]
            assert [(r, t.tolist()) for r, t in got] == [(5, [1, 2]), (6, [3])]
    finally:
        peer.close()
        ring.unlink(reg)
        ring.close()


# ---------------------------------------------------------- token ids
def test_out_of_range_token_ids_raise_value_error_on_the_host(port_root):
    ws, app = port_root
    cfg = get_config(ARCH, smoke=True)
    engine = ServeEngine.from_workspace(cfg, ws, app, cache_len=PROMPT + NEW,
                                        device="cpu")
    bad = np.zeros((2, PROMPT), np.int32)
    bad[1, 3] = cfg.vocab_size
    with pytest.raises(ValueError, match=f"token id {cfg.vocab_size}, outside"):
        engine.generate(bad, NEW)
    bad[1, 3] = -1
    with pytest.raises(ValueError, match="token id -1, outside"):
        engine.generate(bad, NEW)
    reqs = iter([Request(rid=0, prompt=np.full(PROMPT, 300, np.int32),
                         max_new_tokens=NEW), STOP])
    with pytest.raises(ValueError, match="request 0 holds token id 300"):
        engine.serve_loop(lambda: next(reqs), lambda c: None, max_batch=2)


def test_traffic_worker_refuses_an_out_of_range_id_with_an_error_frame(port_root, tmp_path):
    """A request frame holding an id past the vocabulary comes back from a
    real worker process as an ERROR frame naming a ValueError."""
    ws, app = port_root
    session = "badtok"
    slot = traffic.ring_slot_bytes(PROMPT, NEW)
    req = ShmRing.create(ws.registry, traffic.req_channel(session, 0),
                         slots=traffic.RING_SLOTS, slot_bytes=slot)
    proc = mp.get_context("spawn").Process(
        target=traffic._traffic_worker,
        args=(ws.root, app, ARCH, "stable-mmap-cached", session, 0, PROMPT + NEW + 4,
              2, NEW, slot, str(tmp_path)),
        kwargs={"device": "cpu"}, daemon=True)
    proc.start()
    rsp = None
    try:
        rsp = ShmRing.attach(ws.registry, traffic.rsp_channel(session, 0), timeout=60.0)
        req.push(traffic.encode_request(0, np.full(PROMPT, 256, np.int32), NEW, None))
        frames, deadline = [], time.monotonic() + JOIN_S
        while time.monotonic() < deadline and not any(
                f[0] == traffic._RID_ERROR for f in frames):
            data = rsp.pop()
            if data is None:
                time.sleep(0.01)
                continue
            frames.append(traffic.decode_completion(data))
        rids = [f[0] for f in frames]
        assert rids == [traffic._RID_READY, traffic._RID_ERROR], rids
        text = frames[-1][1].decode()
        assert "ValueError" in text and "token id 256, outside the vocabulary" in text
        assert "IndexError" not in text
        proc.join(timeout=JOIN_S)
        assert not proc.is_alive() and proc.exitcode != 0
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=10)
        if rsp is not None:
            rsp.close()
            rsp.unlink(ws.registry)
        req.close()
        req.unlink(ws.registry)


# ------------------------------------------------ the slice against JAX
def test_traffic_tokens_equal_the_reference_engines(ref_root):
    """Port workers under Poisson load stream, for every rid, the greedy
    continuation the reference's ``ServeEngine.generate`` gives the same
    prompt on the same weights (f32 smoke: identical tokens)."""
    ws, app = ref_root
    n = 6
    rep = run_traffic(ws, app, arch=ARCH, workers=2, n_requests=n, rate_hz=100.0,
                      prompt_len=PROMPT, max_new_tokens=NEW, max_batch=2, seed=5,
                      stream=True, device="cpu", timeout=JOIN_S * 2)
    s = rep.summary()
    assert rep.sent == n and rep.completed == n and rep.failed == 0, s
    assert rep.partial_frames == n * NEW and rep.stream_gaps == 0, s
    assert rep.stream_dup_frames == 0 and rep.stream_mismatches == 0, s
    # the dispatcher's draw, redrawn here: ids in [0, min(32000, vocab))
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, 256, (n, PROMPT), dtype=np.int32)
    ref_ws = RefWorkspace.open(ws.root, epoch_cache=RefEpochCache())
    engine = RefServeEngine.from_workspace(ref_config(ARCH, smoke=True), ref_ws, app,
                                           cache_len=PROMPT + NEW)
    want, _ = engine.generate(prompts, NEW)
    assert set(rep.stream_tokens) == set(range(n))
    for rid in range(n):
        np.testing.assert_array_equal(rep.stream_tokens[rid], np.asarray(want)[rid])
    # each worker's statistics came back: every request admitted once, the
    # warmup included; no kernel launches on the CPU
    assert [w["worker"] for w in rep.worker_stats] == [0, 1]
    assert sum(w["serve_loop"]["admitted"] for w in rep.worker_stats) == n + 2
    for w in rep.worker_stats:
        assert w["device"] == "cpu" and w["launches"]["flash_attention"] == 0
    # every rid was served by exactly one worker, on the one generation
    served = {}
    for w in rep.worker_stats:
        for rid, gen in w["served_gen"].items():
            assert int(rid) not in served
            served[int(rid)] = gen
    assert {r: g for r, g in served.items() if r < n} == dict.fromkeys(range(n), ws.epoch_gen)
    assert _no_ring_left(ws)


def test_mamba2_traffic_tokens_equal_the_reference_engines(tmp_path):
    """mamba2-370m, the reference's serving workhorse, on a root the
    reference published: 2 port workers under Poisson load stream, for
    every rid, the reference ``generate``'s greedy continuation of the same
    prompt (f32 smoke: identical tokens); SSM slots need no cache_len."""
    arch = "mamba2-370m"
    ref = RefWorkspace.open(tmp_path / "store", epoch_cache=RefEpochCache())
    app = _ref_publish(ref, arch)
    ws = Workspace.open(ref.root, epoch_cache=EpochCache())
    n = 6
    try:
        rep = run_traffic(ws, app, arch=arch, workers=2, n_requests=n, rate_hz=100.0,
                          prompt_len=PROMPT, max_new_tokens=NEW, max_batch=2, seed=3,
                          stream=True, device="cpu", timeout=JOIN_S * 2)
    finally:
        shm_arena.unlink_root_segments(ws.registry)
    s = rep.summary()
    assert rep.sent == n and rep.completed == n and rep.failed == 0, s
    assert rep.partial_frames == n * NEW and rep.stream_gaps == 0, s
    assert rep.stream_dup_frames == 0 and rep.stream_mismatches == 0, s
    prompts = np.random.default_rng(3).integers(0, 256, (n, PROMPT), dtype=np.int32)
    engine = RefServeEngine.from_workspace(ref_config(arch, smoke=True), ref, app)
    want, _ = engine.generate(prompts, NEW)
    for rid in range(n):
        np.testing.assert_array_equal(rep.stream_tokens[rid], np.asarray(want)[rid])
    assert sum(w["serve_loop"]["admitted"] for w in rep.worker_stats) == n + 2
    assert _no_ring_left(ws)


def test_rollover_under_load_adopts_the_references_digest(ref_root):
    """A commit lands mid-load; each port worker flips to it and reports a
    digest equal to an independent port load of the new generation and to
    the reference's digest of the same generation, loaded by the
    reference."""
    ws, app = ref_root
    cfg = get_config(ARCH, smoke=True)
    gen0 = ws.epoch_gen

    def rollover_fn():
        params = models.init_params(cfg, 1, "cpu")
        with ws.management() as tx:
            tx.publish(*bundle_from_params(f"weights:{cfg.name}", "v2", params,
                                           specs=models.param_specs(cfg)))

    n = 10
    rep = run_traffic(ws, app, arch=ARCH, workers=2, n_requests=n, rate_hz=100.0,
                      prompt_len=PROMPT, max_new_tokens=NEW, max_batch=2,
                      rollover_at=n // 3, rollover_fn=rollover_fn, device="cpu",
                      timeout=JOIN_S * 2)
    s = rep.summary()
    assert rep.sent == n and rep.completed == n and rep.failed == 0, s
    assert ws.epoch_gen == gen0 + 1
    assert len(rep.adoptions) == 2, s
    assert {a["epoch_gen"] for a in rep.adoptions} == {ws.epoch_gen}, s
    port_digest = traffic.tensors_digest(
        ws.load(app, strategy="stable-mmap-cached").tensors)
    ref_ws = RefWorkspace.open(ws.root, epoch_cache=RefEpochCache())
    ref_digest = _ref_digest(ref_ws.load(app, strategy="stable-mmap-cached").tensors)
    assert port_digest == ref_digest
    assert {a["digest"] for a in rep.adoptions} == {ref_digest}, s
    assert rep.rollover_wall_s > 0, s
    served = {}
    for w in rep.worker_stats:
        assert w["serve_loop"]["rollovers"] == 1
        assert [f["epoch_gen"] for f in w["flips"]] == [ws.epoch_gen]
        served.update({int(r): g for r, g in w["served_gen"].items() if int(r) < n})
    # each rid names the generation it was served on: the old one or the new
    assert set(served) == set(range(n))
    assert set(served.values()) <= {gen0, ws.epoch_gen}


def test_tensors_digest_reads_torch_tensors_as_their_bytes():
    import torch

    g = torch.Generator().manual_seed(0)
    t = {"b": torch.randn((3, 4), generator=g).to(torch.bfloat16),
         "a": torch.randn((5,), generator=g), "c": torch.tensor(7, dtype=torch.int32)}
    host = {"b": t["b"].view(torch.int16).numpy().view("<u2"), "a": t["a"].numpy(),
            "c": t["c"].numpy()}
    assert traffic.tensors_digest(t) == traffic.tensors_digest(host) == _ref_digest(host)
    # strided views hash as their values, not their storage
    m = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert traffic.tensors_digest({"m": m.t()}) == _ref_digest({"m": m.t().numpy()})


# ------------------------------------------------ streaming, sampled
def test_sampled_streaming_over_mpmc_rings_with_priorities(port_root):
    ws, app = port_root
    n = 8
    rep = run_traffic(ws, app, arch=ARCH, workers=2, n_requests=n, rate_hz=200.0,
                      prompt_len=PROMPT, max_new_tokens=NEW, max_batch=2,
                      stream=True, temperature=0.7, top_k=8, sampling_seed=42,
                      priorities=[i % 2 for i in range(n)], mpmc=True,
                      device="cpu", timeout=JOIN_S * 2)
    s = rep.summary()
    assert rep.sent == n and rep.completed == n and rep.failed == 0, s
    assert rep.partial_frames == n * NEW, s
    assert rep.stream_gaps == 0 and rep.stream_dup_frames == 0, s
    assert rep.stream_mismatches == 0, s
    assert set(rep.stream_tokens) == set(range(n))
    for toks in rep.stream_tokens.values():
        assert len(toks) == NEW and toks.max() < 256
    assert len(rep.ttft_s) == n
    assert 0 < rep.ttft_p50_s <= rep.ttft_p99_s <= rep.p99_s, s
    assert _no_ring_left(ws)


# ------------------------------------------------ the dispatcher's clock
def test_answers_are_read_while_the_dispatcher_waits_to_send(port_root):
    """The dispatcher drains the response rings through each inter-arrival
    gap, so an answer waits in its ring for milliseconds, not for the next
    send. A dispatcher that sleeps through the gap, as the reference's
    does, leaves each answer there for about the next gap: a median of
    0.5 s at this seed, all of it counted in the latency."""
    ws, app = port_root
    n, rate, seed = 8, 2.0, 3
    _, gaps = traffic.draw_prompts(256, n, PROMPT, rate, seed)
    assert np.median(gaps[1:]) > 0.5
    rep = run_traffic(ws, app, arch=ARCH, workers=1, n_requests=n, rate_hz=rate,
                      seed=seed, prompt_len=PROMPT, max_new_tokens=NEW, max_batch=2,
                      stream=True, device="cpu", timeout=JOIN_S)
    s = rep.summary()
    assert rep.completed == n and rep.failed == 0, s
    assert len(rep.ring_wait_s) == n and min(rep.ring_wait_s) >= 0, s
    assert s["ring_wait_p50_s"] < 0.1, s
    assert _no_ring_left(ws)

"""The port's span recorder (``repro_torch.obs``): nesting per thread, the
bounded buffer, switching it off, and the spans the serving loop and a
device load record, on the CPU."""

from __future__ import annotations

import gc
import os
import sys
import threading
from collections import Counter, deque

import numpy as np
import pytest

from repro_torch import models, obs
from repro_torch.configs import get_config
from repro_torch.core import EpochCache
from repro_torch.launch import serve as launch_serve
from repro_torch.link import Workspace
from repro_torch.serve import STOP, Request, ServeEngine

ARCH = "gemma3-1b"


@pytest.fixture(autouse=True)
def fresh_recorder():
    obs.clear()
    obs.set_enabled(True)
    yield
    obs.set_enabled(True)
    obs.clear()


def _by_name(spans) -> dict:
    return {s.name: s for s in spans}


def test_spans_nest_and_unpack_as_triples():
    with obs.span("outer", k=1) as outer:
        with obs.span("inner") as inner:
            pass
        with obs.span("sibling"):
            pass
    got = _by_name(obs.spans())
    assert [s.name for s in obs.spans()] == ["inner", "sibling", "outer"]
    assert got["inner"].parent == got["sibling"].parent == outer.id
    assert got["outer"].parent is None and outer.attrs == {"k": 1}
    assert {s.root for s in obs.spans()} == {outer.id}
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1
    name, t0, t1 = inner
    assert (name, t0, t1) == ("inner", inner.t0, inner.t1) and inner.dur == t1 - t0


def test_parents_nest_per_thread():
    """A span opened on another thread, while this thread holds one open,
    does not take it as its parent."""
    seen = {}
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait()
        with obs.span("t.outer") as o:
            with obs.span("t.inner"):
                seen["worker"] = o.id
        done.set()

    th = threading.Thread(target=worker)
    th.start()
    with obs.span("main.outer") as main:
        go.set()
        done.wait(10)
        with obs.span("main.inner"):
            pass
    th.join()
    got = _by_name(obs.spans())
    assert got["t.outer"].parent is None
    assert got["t.inner"].parent == seen["worker"] == got["t.outer"].id
    assert got["main.inner"].parent == main.id


def test_a_span_closed_by_an_exception_is_kept_and_unwinds():
    with pytest.raises(KeyError):
        with obs.span("raises"):
            raise KeyError("x")
    with obs.span("after") as after:
        pass
    assert after.parent is None
    assert [s.name for s in obs.spans()] == ["raises", "after"]


def test_the_buffer_is_bounded_and_counts_what_it_drops():
    n = obs.CAPACITY + 37
    for i in range(n):
        with obs.span("s", i=i):
            pass
    kept = obs.spans()
    assert len(kept) == obs.CAPACITY and obs.dropped() == 37
    assert kept[0].attrs["i"] == 37 and kept[-1].attrs["i"] == n - 1
    obs.clear()
    assert obs.spans() == [] and obs.dropped() == 0


def test_threads_lose_no_record_and_no_drop(monkeypatch):
    """More recording threads than cores, switching often, into a small
    buffer: every span is either kept or counted as dropped, ids are
    unique, and each thread's spans nest under its own."""
    monkeypatch.setattr(obs, "_records", deque(maxlen=97))
    threads, per = 2 * (os.cpu_count() or 2) + 1, 400
    strays = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                with obs.span("outer", k=k) as o:
                    with obs.span("inner", k=k) as inner:
                        pass
                    if inner.parent != o.id:
                        strays.append(inner)

        pool = [threading.Thread(target=work, args=(k,)) for k in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
    kept = obs.spans()
    assert strays == []
    assert len(kept) + obs.dropped() == 2 * threads * per
    assert len({s.id for s in kept}) == len(kept) == 97


def test_kept_records_are_not_tracked_by_the_garbage_collector():
    """A full buffer must not lengthen a full collection's walk."""
    for i in range(100):
        with obs.span("s", i=i, due=0.5, what="x"):
            pass
    for _ in range(5):           # a tuple is untracked a pass after the tuples it holds
        gc.collect()
    assert not any(gc.is_tracked(r) for r in obs._records)
    assert obs.spans()[-1].attrs == {"i": 99, "due": 0.5, "what": "x"}


def test_switched_off_it_records_nothing_but_still_times():
    obs.set_enabled(False)
    with obs.span("off") as s:
        pass
    obs.interval("off.interval", 1.0, 2.0)
    assert obs.spans() == [] and obs.dropped() == 0
    assert s.t1 >= s.t0 > 0.0
    obs.set_enabled(True)
    with obs.span("on"):
        pass
    assert [x.name for x in obs.spans()] == ["on"]


def test_a_span_left_out_is_not_recorded():
    with obs.span("kept"):
        with obs.span("idle") as idle:
            idle.keep = False
    assert [s.name for s in obs.spans()] == ["kept"]


def _engine(cache_len=40):
    cfg = get_config(ARCH, smoke=True)
    return ServeEngine(cfg, models.init_params(cfg, 0, "cpu"), cache_len=cache_len,
                       device="cpu")


def test_serve_loop_spans_one_per_request_and_step():
    eng = _engine()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=100 + i, prompt=rng.integers(0, 256, 6 + i, dtype=np.int32),
                    max_new_tokens=3 + i % 3, enqueued_ts=None) for i in range(7)]
    feed = iter(reqs + [STOP])
    deltas = []
    rep = eng.serve_loop(lambda: next(feed), lambda c: None, max_batch=3, max_new_cap=6,
                         on_delta=deltas.append)
    spans = obs.spans()
    count = Counter(s.name for s in spans)
    rids = [r.rid for r in reqs]
    assert rep.admitted == len(reqs) and rep.steps > 0
    assert sorted(s.attrs["rid"] for s in spans if s.name == "serve.queued") == rids
    assert sorted(s.attrs["rid"] for s in spans if s.name == "sched.admit") == rids
    assert count["sched.admit.launch"] == count["sched.admit.sync"] == len(reqs)
    assert count["sched.step"] == count["sched.step.launch"] == rep.steps
    assert count["sched.step.sync"] == rep.steps           # streaming: one read a step
    assert count["serve.retire"] == rep.steps
    assert sum(s.attrs["finished"] for s in spans if s.name == "serve.retire") == rep.completed
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name in ("sched.step.launch", "sched.step.sync"):
            assert by_id[s.parent].name == "sched.step"
        if s.name in ("sched.admit.launch", "sched.admit.sync"):
            assert by_id[s.parent].name == "sched.admit"
    for s in spans:
        if s.name == "sched.step":
            assert 1 <= s.attrs["active"] <= s.attrs["slots"] == 3
    queued = {s.attrs["rid"]: s for s in spans if s.name == "serve.queued"}
    admits = {s.attrs["rid"]: s for s in spans if s.name == "sched.admit"}
    for rid in rids:
        assert queued[rid].t1 <= admits[rid].t0
        assert queued[rid].attrs["due"] is None      # no dispatcher clock


def test_without_streaming_no_sync_spans():
    eng = _engine()
    reqs = [Request(rid=i, prompt=np.arange(5, dtype=np.int32) + i, max_new_tokens=3)
            for i in range(3)]
    feed = iter(reqs + [STOP])
    rep = eng.serve_loop(lambda: next(feed), lambda c: None, max_batch=2, max_new_cap=3)
    count = Counter(s.name for s in obs.spans())
    assert count["sched.step"] == rep.steps and count["sched.admit"] == 3
    assert count["sched.step.sync"] == count["sched.admit.sync"] == count["serve.deltas"] == 0


def test_an_idle_source_records_nothing():
    eng = _engine()
    turns = iter([None] * 40 + [STOP])
    rep = eng.serve_loop(lambda: next(turns), lambda c: None, max_batch=2)
    assert rep.admitted == rep.steps == 0
    assert obs.spans() == [] and obs.dropped() == 0


@pytest.mark.parametrize("enabled", [True, False])
def test_a_device_load_splits_its_upload(tmp_path, enabled):
    cfg = get_config(ARCH, smoke=True)
    ws = Workspace.open(tmp_path / "m", epoch_cache=EpochCache())
    app = launch_serve.publish_model(ws, cfg, device="cpu")
    obs.clear()
    obs.set_enabled(enabled)
    eng = ServeEngine.from_workspace(cfg, ws, app, strategy="stable", cache_len=24,
                                     device="cpu")
    s = eng.load_stats
    assert s.read_s > 0.0 and s.stage_wait_s == 0.0          # no staging on the CPU
    assert s.read_s + s.stage_wait_s <= s.upload_s
    assert s.upload_s + s.kernel_s + s.host_rows_s <= s.io_s
    if not enabled:
        assert obs.spans() == []
        return
    spans = obs.spans()
    got = _by_name(spans)
    start = got["engine.start"]
    assert all(x.root == start.id for x in spans)
    assert got["link.load"].parent == start.id and got["engine.lift"].parent == start.id
    for name in ("link.table_load", "link.upload", "link.page_copy", "link.host_rows"):
        assert got[name].parent == got["link.load"].id, name
    reads = [x for x in spans if x.name == "link.payload_read"]
    assert reads and all(x.parent == got["link.upload"].id for x in reads)
    assert sum(x.dur for x in reads) == pytest.approx(s.read_s, abs=1e-12)
    assert got["link.upload"].dur == s.upload_s and got["link.page_copy"].dur == s.kernel_s
    assert got["link.table_load"].dur == s.table_load_s
    assert sum(x.attrs["bytes"] for x in reads) > 0
    summary = ws.explain(app).summary()["last_load"]
    assert summary["read_s"] == s.read_s and summary["stage_wait_s"] == 0.0


def test_generate_stats_are_its_spans():
    eng = _engine()
    _, stats = eng.generate(np.arange(8, dtype=np.int32)[None], 4)
    got = _by_name(obs.spans())
    gen = got["engine.generate"]
    for name in ("engine.prefill.launch", "engine.prefill.sync", "engine.decode"):
        assert got[name].parent == gen.id
    assert stats.prefill_s == got["engine.prefill.sync"].t1 - got["engine.prefill.launch"].t0
    assert stats.decode_s == got["engine.decode"].dur

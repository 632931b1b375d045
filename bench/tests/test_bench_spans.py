"""The readers of the program's spans (``bench/spans.py`` and the
``program_span`` metrics), on spans planted by hand, and the trace's idle
gaps keyed by the program's spans from a serving loop on the CPU."""

from __future__ import annotations

import sys
import time

import numpy as np
import pytest

from bench.cell import reader
from bench.record import Record
from bench.trace import Tracer

SERVING = ("sched.accept_wait_p50_s", "sched.admit_wait_p50_s", "sched.step_ms",
           "sched.step_launch_ms", "sched.loop_gap_ms", "sched.slot_use.chat")
STARTING = ("link.payload_read_s", "engine.prefill_launch_s")


def _span(sid, name, t0, t1, parent=None, **attrs):
    from repro_torch import obs

    s = obs.Span(name, attrs)
    s.id, s.parent, s.t0, s.t1 = sid, parent, t0, t1
    s.root = sid
    return s


def _plant(monkeypatch, spans, dropped=0):
    from repro_torch import obs

    monkeypatch.setattr(obs, "spans", lambda: list(spans))
    monkeypatch.setattr(obs, "dropped", lambda: dropped)


def _serving():
    """A window [10, 20). Requests 1 and 2 due at 10.0 and 10.5, accepted at
    10.1 and 10.5, admitted from 10.2 and 10.5. Steps at [10.3, 10.4) with 2
    of 4 slots active, [10.45, 10.48), an admission at 10.5, [10.6, 10.7)
    and [10.71, 10.8) with 4 active; one step before the window and one
    ending after it."""
    s, i = [], iter(range(1, 100))
    s.append(_span(next(i), "sched.step", 9.0, 9.5, active=4, slots=4))
    s.append(_span(next(i), "serve.queued", 10.1, 10.2, rid=1, due=10.0))
    a = next(i)
    s.append(_span(a, "sched.admit", 10.2, 10.25, rid=1, prompt=8))
    step = next(i)
    s.append(_span(next(i), "sched.step.launch", 10.3, 10.32, parent=step))
    s.append(_span(step, "sched.step", 10.3, 10.4, active=2, slots=4))
    step = next(i)
    s.append(_span(next(i), "sched.step.launch", 10.45, 10.46, parent=step))
    s.append(_span(step, "sched.step", 10.45, 10.48, active=2, slots=4))
    s.append(_span(next(i), "serve.queued", 10.5, 10.5, rid=2, due=10.5))
    s.append(_span(next(i), "sched.admit", 10.5, 10.55, rid=2, prompt=8))
    step = next(i)
    s.append(_span(next(i), "sched.step.launch", 10.6, 10.64, parent=step))
    s.append(_span(step, "sched.step", 10.6, 10.7, active=4, slots=4))
    s.append(_span(next(i), "sched.step", 10.71, 10.8, active=4, slots=4))
    s.append(_span(next(i), "sched.step", 19.9, 20.1, active=4, slots=4))
    return s


def _starting():
    """A window [0, 1): two starts inside it, one read split across stages
    and a nested span between the read and its load; one start before."""
    s = []
    s.append(_span(1, "link.load", -0.5, -0.3))
    s.append(_span(2, "link.payload_read", -0.45, -0.4, parent=1, bytes=1))
    s.append(_span(10, "engine.start", 0.0, 0.3))
    s.append(_span(11, "link.load", 0.0, 0.2, parent=10))
    s.append(_span(12, "link.upload", 0.05, 0.15, parent=11))
    s.append(_span(13, "link.payload_read", 0.05, 0.09, parent=12, bytes=1))
    s.append(_span(14, "link.payload_read", 0.10, 0.12, parent=12, bytes=1))
    s.append(_span(15, "engine.prefill.launch", 0.31, 0.41))
    s.append(_span(20, "engine.start", 0.5, 0.7))
    s.append(_span(21, "link.load", 0.5, 0.6, parent=20))
    s.append(_span(22, "link.upload", 0.52, 0.58, parent=21))
    s.append(_span(23, "link.payload_read", 0.52, 0.54, parent=22, bytes=1))
    s.append(_span(25, "engine.prefill.launch", 0.71, 0.91))
    return s


def test_serving_readers_on_planted_spans(monkeypatch):
    _plant(monkeypatch, _serving())
    rec = Record("serve", {}, window=(10.0, 20.0))
    got = {name: reader(name)(rec) for name in SERVING}
    assert got["sched.accept_wait_p50_s"] == pytest.approx(0.05)       # 0.1 and 0.0
    assert got["sched.admit_wait_p50_s"] == pytest.approx(0.05)        # 0.1 and 0.0
    assert got["sched.step_ms"] == pytest.approx(95.0)                 # 30, 90, 100, 100
    assert got["sched.step_launch_ms"] == pytest.approx(20.0)          # 10, 20, 40
    # pairs: 10.4 -> 10.45 (0.05), 10.7 -> 10.71 (0.01); the admission
    # between 10.48 and 10.6 leaves that pair out
    assert got["sched.loop_gap_ms"] == pytest.approx(30.0)
    assert got["sched.slot_use.chat"] == pytest.approx(100.0 * 12 / 16)


def test_start_readers_on_planted_spans(monkeypatch):
    _plant(monkeypatch, _starting())
    rec = Record("start", {}, window=(0.0, 1.0))
    assert reader("link.payload_read_s")(rec) == pytest.approx((0.06 + 0.02) / 2)
    assert reader("engine.prefill_launch_s")(rec) == pytest.approx(0.15)


@pytest.mark.parametrize("name", SERVING + STARTING)
def test_a_window_whose_spans_were_dropped_reads_nothing(monkeypatch, name):
    spans = _serving() if name in SERVING else _starting()
    rec = Record("serve", {}, window=(10.0, 20.0) if name in SERVING else (0.0, 1.0))
    _plant(monkeypatch, spans, dropped=0)
    assert reader(name)(rec) is not None
    # records were dropped, and the oldest kept one ends inside the window
    late = [s for s in spans if s.t1 > rec.window[0] + 0.25]
    _plant(monkeypatch, late, dropped=3)
    assert reader(name)(rec) is None
    # records were dropped, all of them before the window opened
    _plant(monkeypatch, spans, dropped=3)
    assert reader(name)(rec) is not None


@pytest.mark.parametrize("name", SERVING + STARTING)
def test_a_program_without_the_recorder_reads_nothing(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    rec = Record("serve", {}, window=(0.0, 100.0))
    assert reader(name)(rec) is None


@pytest.mark.parametrize("name", SERVING + STARTING)
def test_no_spans_in_the_window_read_nothing(monkeypatch, name):
    _plant(monkeypatch, _serving() + _starting())
    assert reader(name)(Record("serve", {}, window=(50.0, 60.0))) is None


def _traced_loop(tracer):
    """A smoke serving loop run under ``tracer`` (started and stopped around
    it); returns the program's spans of the stretch."""
    from repro_torch import models, obs
    from repro_torch.configs import get_config
    from repro_torch.serve import STOP, Request, ServeEngine

    cfg = get_config("gemma3-1b", smoke=True)
    eng = ServeEngine(cfg, models.init_params(cfg, 0, "cpu"), cache_len=48, device="cpu")
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, 256, 8 + 2 * i, dtype=np.int32),
                    max_new_tokens=6, enqueued_ts=time.monotonic()) for i in range(8)]
    feed = iter(reqs + [STOP])
    obs.clear()
    tracer.start()
    eng.serve_loop(lambda: next(feed), lambda c: None, max_batch=4, max_new_cap=6,
                   on_delta=lambda d: None)
    tracer.stop()
    return [s for s in obs.spans() if s.t1 >= tracer.t0]


def test_the_trace_keys_its_gaps_by_the_programs_spans():
    """A smoke serving loop under the CPU's tracer (host operators stand in
    for kernels): given the program's spans in place of the harness's, the
    gaps between operators fall under the program's span names."""
    tracer = Tracer(True, "cpu")
    spans = _traced_loop(tracer)
    tr = tracer.summary(spans)
    gaps = dict(tr["idle_gaps"])
    names = {s.name for s in spans}
    idle = sum(gaps.values())
    assert idle > 0 and "sched.step.launch" in gaps
    outside = gaps.get("between_spans", 0.0)
    assert set(gaps) - {"between_spans"} <= names
    # only the loop's first and last instants lie outside every span
    assert outside < 0.1 * idle, tr["idle_gaps"]


def test_idle_by_span_splits_the_idle_time_exactly():
    """``bench.spans.idle_by_span``: the idle seconds under some program
    span and under none add up to the stretch's idle seconds, and the
    names it keys by are the program's."""
    from bench import spans as reduce

    tracer = Tracer(True, "cpu")
    spans = _traced_loop(tracer)
    got = reduce.idle_by_span(tracer.summary, tracer.t0, tracer.t1)
    tr = tracer.summary([])
    # the gaps inside the stretch; a kernel that runs past either end
    # counts in busy_s but leaves no gap
    assert abs(got["idle_s"] - (tr["window_s"] - tr["busy_s"])) < 0.01 * tr["window_s"]
    assert got["under_program_s"] + got["between_spans_s"] == pytest.approx(got["idle_s"])
    assert got["between_spans_s"] < 0.1 * got["idle_s"], got
    assert {k for k, _ in got["idle_gaps"]} - {"between_spans"} <= {s.name for s in spans}
    assert "serve.poll" in dict(got["idle_gaps"]) or "serve.retire" in dict(got["idle_gaps"])


def test_idle_by_span_reads_nothing_without_the_stretchs_spans(monkeypatch):
    from bench import spans as reduce
    from repro_torch import obs

    tracer = Tracer(True, "cpu")
    _traced_loop(tracer)
    # spans were dropped after the stretch opened
    late = [s for s in obs.spans() if s.t0 > tracer.t0 + 1e-6]
    _plant(monkeypatch, late, dropped=5)
    assert reduce.idle_by_span(tracer.summary, tracer.t0, tracer.t1) is None
    # no span in the stretch
    _plant(monkeypatch, [], dropped=0)
    assert reduce.idle_by_span(tracer.summary, tracer.t0, tracer.t1) is None
    # a program without the recorder
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert reduce.idle_by_span(tracer.summary, tracer.t0, tracer.t1) is None


def test_program_breakdown_prints_the_programs_idle_gaps(capsys):
    """``bench/program_breakdown.py``'s tracer: the harness's summary as it
    was, and one ``program_breakdown`` line with the program's split."""
    import json

    from bench.program_breakdown import ProgramTracer

    tracer = ProgramTracer(True, "cpu")
    _traced_loop(tracer)
    out = tracer.summary([])
    assert [k for k, _ in out["idle_gaps"]] == ["between_spans"]
    lines = [ln for ln in capsys.readouterr().err.splitlines()
             if ln.startswith("program_breakdown ")]
    assert len(lines) == 1
    got = json.loads(lines[0].split(" ", 1)[1])
    assert got["idle_s"] == pytest.approx(sum(v for _, v in out["idle_gaps"]))
    assert "sched.step.launch" in dict(got["idle_gaps"])

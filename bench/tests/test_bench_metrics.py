"""The traffic generator and the metric arithmetic, on schedules and
timestamps made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from bench import readings, traffic
from bench.cell import reader
from bench.record import Record


def test_every_seed_gets_the_same_work():
    mix = {"rate": [[1.0, 4.0]], "prompt_len": [128, 2048], "output_len": [32, 512], "ramp_s": 5}
    a = traffic.schedule(mix, 1, 20.0, 1000)
    b = traffic.schedule(mix, 2**31 + 12345, 20.0, 1000)
    assert len(a) == len(b) == 100
    for plan in (a, b):
        due = np.array([p.due for p in plan])
        assert np.all(np.diff(due) >= 0) and 0 <= due[0] and due[-1] < 25.0
        assert np.sum(due < 5.0) == 20           # the ramp's count, then the window's
        window = [p for p in plan if p.due >= 5.0]
        assert sorted(p.max_new for p in window) == list(traffic.log_uniform(32, 512, 80))
        assert min(len(p.prompt) for p in plan) >= 128 and max(p.max_new for p in plan) <= 512
    assert [len(p.prompt) for p in a] != [len(p.prompt) for p in b]
    assert [p.due for p in a] != [p.due for p in b]


def test_a_fixed_path_serves_every_seed_the_same_requests():
    mix = {"rate": [[1.0, 4.0]], "prompt_len": [128, 2048], "output_len": [32, 512], "ramp_s": 5,
           "path_seed": 0}
    a = traffic.schedule(mix, 1, 20.0, 1000)
    b = traffic.schedule(mix, 2**31 + 12345, 20.0, 1000)
    assert [(p.due, len(p.prompt), p.max_new) for p in a] == \
        [(p.due, len(p.prompt), p.max_new) for p in b]
    assert any(not np.array_equal(p.prompt, q.prompt) for p, q in zip(a, b))
    other = traffic.schedule({**mix, "path_seed": 1}, 1, 20.0, 1000)
    assert [p.due for p in other] != [p.due for p in a]
    free = traffic.schedule({k: v for k, v in mix.items() if k != "path_seed"}, 1, 20.0, 1000)
    assert [p.due for p in free] != [p.due for p in a]


def test_gaps_are_those_of_a_poisson_process():
    """Given its count, the arrivals are independent and uniform: the gaps
    are exponential (their spread equals their mean), and runs of short gaps
    come as often as they would; no smoothing across the schedule."""
    mix = {"rate": [[1.0, 2.0]], "prompt_len": [8, 16], "output_len": [4, 8]}
    gaps = np.concatenate([np.diff([p.due for p in traffic.schedule(mix, s, 500.0, 100)])
                           for s in range(20)])
    assert gaps.mean() == pytest.approx(0.5, rel=0.03)
    assert gaps.std() == pytest.approx(gaps.mean(), rel=0.05)
    assert np.mean(gaps < 0.05) == pytest.approx(1 - np.exp(-0.1), rel=0.1)
    short = gaps < np.quantile(gaps, 0.25)
    four = np.mean(short[:-3] & short[1:-2] & short[2:-1] & short[3:])
    assert four == pytest.approx(0.25 ** 4, rel=0.5)       # four short gaps in a row


def test_bursts_follow_the_rate_profile():
    mix = {"rate": [[1.0, 40.0], [4.0, 5.0]], "prompt_len": [32, 64], "output_len": [16, 32]}
    plan = traffic.schedule(mix, 7, 50.0, 100)
    assert len(plan) == round(10 * (40 + 20))
    phase = np.array([p.due % 5.0 for p in plan])
    assert abs(np.mean(phase < 1.0) - 40 / 60) < 0.05
    assert traffic.integrated(mix["rate"], 7.5) == pytest.approx(40 + 20 + 40 + 1.5 * 5)
    u = np.array([0.0, 30.0, 40.0, 61.5])
    assert traffic.inverse(mix["rate"], u) == pytest.approx([0.0, 0.75, 1.0, 5.0 + 1.5 / 40])


def _record() -> Record:
    """A window [10, 20): request 0 due at 11, first token 11.5, tokens at
    11.5, 12, 13 and 21 (after the close); request 1 due at 12, no token by
    the close; request 2 due at 9 (before the window), tokens at 10.5, 11."""
    rec = Record("serve", {}, window=(10.0, 20.0))
    rec.requests = {
        0: {"due_ts": 11.0, "first_ts": 11.5, "tokens": [(0, 11.5), (1, 12.0), (2, 13.0), (3, 21.0)]},
        1: {"due_ts": 12.0, "first_ts": None, "tokens": []},
        2: {"due_ts": 9.0, "first_ts": 9.5, "tokens": [(3, 10.5), (4, 11.0)]},
    }
    rec.prefills = [{"t_start": 11.2, "t_end": 11.5, "S": 8, "rid": 0}]
    rec.steps = [
        {"t_start": 11.5, "t_end": 12.0, "positions": [8, 30], "clean": False},
        {"t_start": 12.0, "t_end": 12.1, "positions": [9, 31], "clean": True},
        {"t_start": 12.1, "t_end": 12.4, "positions": [10], "clean": True},
        {"t_start": 20.0, "t_end": 20.2, "positions": [11], "clean": True},
    ]
    return rec


def test_ttft_counts_from_due_and_waits_past_the_close():
    rec = _record()
    assert sorted(readings.ttft(rec)) == pytest.approx([0.5, 8.0])
    assert reader("ttft_p90_s")(rec) == pytest.approx(0.5 + 0.9 * 7.5)


def test_tpot_tokens_and_steps():
    rec = _record()
    assert sorted(readings.tpot(rec)) == pytest.approx([0.5, 0.75])
    assert reader("tpot_p90_ms")(rec) == pytest.approx(1e3 * (0.5 + 0.9 * 0.25))
    assert readings.window_tokens(rec) == 5
    assert reader("sched.queue_wait_p50_s")(rec) == pytest.approx(0.2)
    assert reader("model.decode_step_ms")(rec) == pytest.approx(200.0)


def test_starts():
    rec = Record("start", {"reference": "mamba2"}, window=(0.0, 1.0))
    rec.starts = [{"t0": 0.0, "load_s": 0.2, "first_ts": 0.3, "payload_bytes": 1, "S": 1},
                  {"t0": 0.3, "load_s": 0.3, "first_ts": 0.7, "payload_bytes": 1, "S": 1},
                  {"t0": 0.7, "load_s": 0.2, "first_ts": 1.2, "payload_bytes": 1, "S": 1}]
    assert reader("engine.start_s")(rec) == pytest.approx(0.5)
    assert reader("link.load_s")(rec) == pytest.approx(0.25)
    assert reader("engine.first_token_s")(rec) == pytest.approx(0.1)


def test_nothing_to_read_reads_nothing():
    rec = Record("serve", {}, window=(0.0, 1.0))
    for name in ("ttft_p90_s", "tpot_p90_ms", "model.decode_step_ms", "model.mfu.chat",
                 "device.idle_share.chat", "device.idle_share.start", "engine.start_s",
                 "start_device_ms", "kernel.paged_copy_roofline", "engine.start_mfu"):
        assert reader(name)(rec) is None, name


def test_device_ms_per_start_counts_the_starts_inside_the_trace():
    rec = Record("start", {"reference": "mamba2"}, window=(0.0, 10.0))
    rec.starts = [{"t0": 0.5, "load_s": 0.2, "first_ts": 1.0},     # before the trace
                  {"t0": 1.0, "load_s": 0.2, "first_ts": 1.5},
                  {"t0": 1.5, "load_s": 0.2, "first_ts": 2.0},
                  {"t0": 2.0, "load_s": 0.2, "first_ts": 3.5}]     # past its end
    rec.trace = {"t0": 1.0, "t1": 2.5, "busy_s": 0.05, "window_s": 1.5,
                 "kernels": {"Memcpy HtoD (Pinned -> Device)": [0.04, 2]}}
    assert len(readings.traced_starts(rec)) == 2
    assert reader("start_device_ms")(rec) == pytest.approx(25.0)
    rec.trace = None
    assert readings.traced_starts(rec) == [] and reader("start_device_ms")(rec) is None


def test_idle_from_a_trace():
    rec = Record("serve", {}, window=(0.0, 10.0))
    rec.trace = {"t0": 1.5, "t1": 6.5, "busy_s": 1.0, "window_s": 4.0,
                 "kernels": {"other": [1.0, 1]}}
    assert reader("device.idle_share.chat")(rec) == pytest.approx(75.0)

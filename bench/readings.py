"""Reductions of a run's record that the metric readers share.

Each function takes the ``Record`` and returns a number, or ``None`` when
the run holds nothing to read (a reader then reports nothing). Times are
on the host's monotonic clock; an event belongs to the window when it ends
inside it.
"""

from __future__ import annotations

import numpy as np

from bench import roofline
from bench.trace import kernel_seconds


def _p(values, q: float) -> float | None:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if len(values) else None


def ttft(rec) -> list:
    """Per request due in the window: its first token's time from when it
    was due; a request with none by the close counts its wait so far."""
    close = rec.window[1]
    out = []
    for r in rec.requests.values():
        if rec.in_window(r["due_ts"]):
            first = r["first_ts"]
            out.append((first if first is not None and first < close else close) - r["due_ts"])
    return out


def tpot(rec) -> list:
    """Per request with two tokens or more in the window: the time from its
    first to its last token there, over the gaps between them."""
    out = []
    for r in rec.requests.values():
        ts = [t for _, t in r["tokens"] if rec.in_window(t)]
        if len(ts) >= 2:
            out.append((ts[-1] - ts[0]) / (len(ts) - 1))
    return out


def window_tokens(rec) -> int:
    return sum(1 for r in rec.requests.values() for _, t in r["tokens"] if rec.in_window(t))


def steps(rec, clean: bool = False) -> list:
    return [s for s in rec.steps if rec.in_window(s["t_end"]) and (s["clean"] or not clean)]


def prefills(rec) -> list:
    return [p for p in rec.prefills if rec.in_window(p["t_end"])]


def queue_waits(rec) -> list:
    due = {rid: r["due_ts"] for rid, r in rec.requests.items()}
    return [p["t_start"] - due[p["rid"]] for p in prefills(rec)]


def step_share(rec) -> float | None:
    """The window's prefills and decode steps: the sum of their roofline
    bounds over the sum of their measured times, in %."""
    conf = rec.conf
    work = [(roofline.prefill(conf, p["S"]), p) for p in prefills(rec)]
    work += [(roofline.decode(conf, s["positions"]), s) for s in steps(rec)]
    spent = sum(e["t_end"] - e["t_start"] for _, e in work)
    if not work or spent <= 0:
        return None
    return 100.0 * sum(roofline.bound_s(*fb) for fb, _ in work) / spent


def idle_share(rec) -> float | None:
    tr = rec.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def starts(rec) -> list:
    return [s for s in rec.starts if rec.in_window(s["first_ts"])]


def traced_starts(rec) -> list:
    """The starts that began and reached their first token inside the
    traced stretch (none without a trace)."""
    if rec.trace is None:
        return []
    return [s for s in rec.starts if s["t0"] >= rec.trace["t0"] and rec.traced(s["first_ts"])]


def device_ms_per_start(rec) -> float | None:
    """The card's busy milliseconds over the traced stretch, per start in
    it. The profiler starts and stops where the host has just read a first
    token back, so the stretch holds whole starts and nothing else."""
    traced = traced_starts(rec)
    return 1e3 * rec.trace["busy_s"] / len(traced) if traced else None


def page_copy_share(rec) -> float | None:
    if rec.trace is None:
        return None
    traced = traced_starts(rec)
    bound = sum(roofline.page_copy_bytes(s["payload_bytes"]) / roofline.HBM_BYTES_S
                for s in traced)
    spent = kernel_seconds(rec.trace, "page_copy_kernel")
    return 100.0 * bound / spent if bound > 0 and spent > 0 else None


def start_share(rec) -> float | None:
    """Each start's bound (its arena's bytes written once, then the first
    prefill's bound: the two run one after the other) over its time, in %."""
    done = starts(rec)
    if not done:
        return None
    bound = sum(s["payload_bytes"] / roofline.HBM_BYTES_S
                + roofline.bound_s(*roofline.prefill(rec.conf, s["S"])) for s in done)
    return 100.0 * bound / sum(s["first_ts"] - s["t0"] for s in done)


def p90(values) -> float | None:
    return _p(values, 90)


def p50(values) -> float | None:
    return _p(values, 50)

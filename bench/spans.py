"""Reductions of the program's own spans that the ``program_span`` readers
share.

The program records its spans in memory (``repro_torch.obs``) on the same
monotonic clock as the run's ``Record``; a reader takes them once the run
is over. A span belongs to the window when it ends inside it. Each function
returns ``None`` when there is nothing to read: a program that records no
spans (one older than the recorder), no span of the kind in the window, or
a recorder that dropped records and whose oldest kept one ends after the
window's opening (so some of the window's may be gone).
"""

from __future__ import annotations

import numpy as np


def _kept(since: float) -> list | None:
    """Every span the program kept, oldest first; None if those ending
    after ``since`` may be incomplete or the program has no recorder."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    kept = obs.spans()
    if obs.dropped() and (not kept or kept[0].t1 > since):
        return None
    return kept


def recorded(rec) -> list | None:
    """Every span the program kept, oldest first; None if the window's may
    be incomplete or the program has no recorder."""
    return _kept(rec.window[0])


def named(rec, name: str, kept: list | None = None) -> list:
    """The spans called ``name`` that end inside the window."""
    kept = recorded(rec) if kept is None else kept
    return [s for s in kept or () if s.name == name and rec.in_window(s.t1)]


def _stat(values, fn, scale: float = 1.0) -> float | None:
    return float(scale * fn(np.asarray(values, dtype=np.float64))) if len(values) else None


def median_length(rec, name: str, scale: float = 1.0) -> float | None:
    return _stat([s.dur for s in named(rec, name)], np.median, scale)


def mean_length(rec, name: str, scale: float = 1.0) -> float | None:
    return _stat([s.dur for s in named(rec, name)], np.mean, scale)


def accept_waits(rec) -> list:
    """Per request admitted in the window: from when it was due to when the
    loop accepted it."""
    return [s.t0 - s.attrs["due"] for s in named(rec, "serve.queued")
            if s.attrs.get("due") is not None]


def loop_gaps(rec) -> list:
    """Per pair of consecutive decode steps in the window with no admission
    between them: from the end of the first to the start of the next."""
    kept = recorded(rec)
    steps = sorted(named(rec, "sched.step", kept), key=lambda s: s.t0)
    admits = sorted(s.t0 for s in kept or () if s.name == "sched.admit")
    at = np.searchsorted(admits, [s.t1 for s in steps])
    out = []
    for i, (a, b) in enumerate(zip(steps, steps[1:])):
        if at[i] == len(admits) or admits[at[i]] > b.t0:
            out.append(b.t0 - a.t1)
    return out


def slot_use(rec) -> float | None:
    """Rows decoded for a request over all rows decoded, in the window's
    steps, in %."""
    steps = named(rec, "sched.step")
    if not steps:
        return None
    return 100.0 * sum(s.attrs["active"] for s in steps) / sum(s.attrs["slots"] for s in steps)


def payload_read_per_load(rec) -> list:
    """Per ``link.load`` in the window: the seconds of its
    ``link.payload_read`` spans."""
    kept = recorded(rec)
    loads = {s.id: 0.0 for s in named(rec, "link.load", kept)}
    if not loads:
        return []
    by_id = {s.id: s for s in kept}
    for s in kept:
        if s.name == "link.payload_read":
            up = by_id.get(s.parent)
            while up is not None and up.id not in loads:
                up = by_id.get(up.parent)
            if up is not None:
                loads[up.id] += s.dur
    return list(loads.values())


def idle_by_span(summarize, t0: float, t1: float) -> dict | None:
    """The card's idle seconds in a traced stretch ``[t0, t1]`` keyed by
    the program's spans instead of the harness's: ``summarize`` is a
    ``bench.trace.Tracer``'s ``summary`` over that stretch. Gives the
    traced seconds, the idle seconds (the gaps between kernels inside the
    stretch), the part of them while the host was inside some program span
    and outside every one (``between_spans``), and ``idle_gaps``: the ten
    program span names that held most idle time, each gap under the
    innermost span at its middle (``bench/program_breakdown.py`` prints
    it). None without a trace, a recorder, or every span of the
    stretch."""
    kept = _kept(t0)
    prog = [s for s in kept or () if s.t1 >= t0 and s.t0 <= t1]
    named = summarize(prog) if prog else None
    if named is None:
        return None
    # inside some span or none: the union of the spans says so exactly,
    # where the ten largest names need not hold ``between_spans``
    union = []
    for s in sorted(prog, key=lambda s: s.t0):
        if union and s.t0 <= union[-1][2]:
            union[-1][2] = max(union[-1][2], s.t1)
        else:
            union.append(["program", s.t0, s.t1])
    split = dict(summarize(union)["idle_gaps"])
    under, outside = split.get("program", 0.0), split.get("between_spans", 0.0)
    return {"window_s": named["window_s"], "idle_s": under + outside,
            "under_program_s": under, "between_spans_s": outside,
            "idle_gaps": named["idle_gaps"]}

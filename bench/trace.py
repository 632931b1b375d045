"""The device trace of a stretch of a run, reduced to what the metrics read.

``Tracer`` starts ``torch.profiler`` (the card's activity only: host
operator events add nothing read here and cost much to collect) at a point
where the host has just synchronised with the card, and stops it at a later
such point, so every kernel in the trace belongs to work the harness
started and finished inside the stretch. ``summary`` gives:

* ``busy_s``: the union of the kernels' intervals, so overlapping streams
  count once; ``window_s``: the stretch's length on the host's clock;
* ``kernels``: device seconds and launches by kernel name;
* ``device_ops``: the ten kernels that took most time;
* ``idle_gaps``: the card's idle time between kernels summed by the
  harness span (``record.spans``) that the host was in at the middle of
  each gap, the ten largest.

The profiler's timestamps count from its start; the host's clock is read
as it starts, which aligns the two to about a millisecond.
"""

from __future__ import annotations

import time


class Tracer:
    """On a CPU device (the tests) it traces the host's operators instead,
    so the reduction runs there too; a result from the card never holds
    those."""

    def __init__(self, enabled: bool, device: str = "cuda"):
        self.enabled = enabled
        self.on_card = device.startswith("cuda")
        self.prof = None
        self.t0 = self.t1 = None

    def warm(self) -> None:
        """Start and stop one profile: the first start in a process sets up
        the tracing library (seconds on the card), which belongs in set-up,
        not in the traced stretch."""
        if self.enabled:
            self.start()
            self.stop()
            self.prof = None
            self.t0 = self.t1 = None

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA if self.on_card
                                        else ProfilerActivity.CPU])
        self.prof.start()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop()

    def summary(self, spans) -> dict | None:
        if self.prof is None or self.t1 is None:
            return None
        import torch

        kind = torch.autograd.DeviceType.CUDA if self.on_card else torch.autograd.DeviceType.CPU
        ivals, kernels = [], {}
        for e in self.prof.events():
            if e.device_type != kind:
                continue
            a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if b <= a:
                continue
            ivals.append((a, b))
            s, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (s + (b - a), n + 1)
        if not ivals:
            return None
        ivals.sort()
        merged = [list(ivals[0])]
        for a, b in ivals[1:]:
            if a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        window = self.t1 - self.t0
        busy = sum(b - a for a, b in merged)
        edges = [0.0] + [x for ab in merged for x in ab] + [window]
        gaps = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                label = span_at(spans, self.t0 + (a + b) / 2)
                gaps[label] = gaps.get(label, 0.0) + (b - a)
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
        return {
            "busy_s": busy,
            "window_s": window,
            "t0": self.t0,
            "t1": self.t1,
            "kernels": {k: list(v) for k, v in kernels.items()},
            "device_ops": [[k[:120], v[0]] for k, v in top[:10]],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
        }


def span_at(spans, t: float) -> str:
    """The name of the innermost span holding host time ``t``."""
    best = None
    for name, a, b in spans:
        if a <= t <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else "between_spans"


def kernel_seconds(trace: dict, *needles: str) -> float:
    """Device seconds of the kernels whose names hold one of ``needles``."""
    return sum(s for name, (s, _) in trace["kernels"].items()
               if any(n in name for n in needles))

"""What one run recorded, on the host's monotonic clock, for the metric
readers (``bench/metrics``) to reduce.

The harness stamps everything itself, around its calls into the program:
the serving loop's streamed tokens (``on_delta``: the first token of a
request arrives right after its B=1 prefill, and every decode step's tokens
together, each after the step's one synchronisation), its completions, and
each replica start's phases. From those it derives the events below; no
timer sits inside the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Record:
    kind: str                          # "serve" or "start"
    conf: dict                         # the configuration file as run
    window: tuple = (0.0, 0.0)         # [open, close) on time.monotonic()
    setup_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    # serving: one dict a request (rid, due_ts, prompt_len, max_new,
    # handed_ts, first_ts, tokens: [(seq, t)], finished_ts, out)
    requests: dict = field(default_factory=dict)
    # serving: B=1 prefills (t_start, t_end, S) and decode steps (t_start,
    # t_end, positions written, clean: no admission since the last step)
    prefills: list = field(default_factory=list)
    steps: list = field(default_factory=list)
    # replica starts: (t0, load_s, lifted_ts, first_ts, payload_bytes, S)
    starts: list = field(default_factory=list)
    spans: list = field(default_factory=list)      # (name, t0, t1)
    trace: dict | None = None

    def in_window(self, t: float) -> bool:
        return self.window[0] <= t < self.window[1]

    @property
    def seconds(self) -> float:
        return self.window[1] - self.window[0]

    def traced(self, t_end: float) -> bool:
        """Whether work that ended at ``t_end`` lies inside the trace."""
        return self.trace is not None and self.trace["t0"] < t_end <= self.trace["t1"]

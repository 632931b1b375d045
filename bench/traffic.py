"""The one traffic generator: a mix file's parameters and a seed -> requests.

An open loop: each request is due at a time fixed before the run starts,
whatever the server does. Arrivals follow a Poisson process whose rate is
piecewise constant and repeats: ``"rate": [[seconds, req/s], ...]`` (one
segment is a steady rate; ``[[1, 2k], [4, k/4]]`` is a burst of 1 s every
5 s). Prompt and output lengths are log-uniform between the mix's bounds.

The process is drawn conditioned on its count in each of two spans, the
ramp ``[0, ramp_s)`` and the window that follows it: each span holds the
expected count of requests, rounded, and given that count a Poisson
process's arrival times are independent draws with density proportional
to the rate (uniform, for a steady one). So the gaps are those of the
process, bursts and all; only the number of requests due in the window is
the same for every seed. Each span's lengths are the quantiles of their
log-uniform laws, shuffled by the seed across the span: every seed gets the
same sizes in another order. Token ids are uniform over the vocabulary.

A mix may fix its sample path: with ``"path_seed": n`` the arrival times
and the order of the lengths are drawn from ``n``, not from the run's seed,
so every seed serves the same requests at the same times (one draw of the
process, as a replayed trace is) and the seed draws the prompts' token ids.
A tail over a window's hundred-odd requests hangs on where the bursts fall
among the short and the long requests; a fixed path leaves the run's own
noise in it, and not the draw's.

Times are seconds from the start of the schedule; the window opens at
``ramp_s``, after arrivals have filled the slots.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Planned:
    rid: int
    due: float                 # seconds from the schedule's start
    prompt: np.ndarray         # (S,) int32
    max_new: int


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def log_uniform(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles of log-uniform[lo, hi]."""
    vals = np.exp(math.log(lo) + _quantiles(n) * (math.log(hi) - math.log(lo)))
    return np.clip(np.rint(vals), lo, hi).astype(np.int64)


def rate_profile(segments) -> tuple[np.ndarray, np.ndarray, float]:
    """(segment starts, rates, period) of a repeating piecewise rate."""
    seg = np.asarray(segments, dtype=np.float64).reshape(-1, 2)
    starts = np.concatenate([[0.0], np.cumsum(seg[:-1, 0])])
    return starts, seg[:, 1], float(seg[:, 0].sum())


def integrated(segments, t: float) -> float:
    """The expected number of arrivals in [0, t)."""
    starts, rates, period = rate_profile(segments)
    per = float(np.sum(np.diff(np.append(starts, period)) * rates))
    full, rest = divmod(t, period)
    part = sum(r * min(max(rest - s, 0.0), e - s)
               for s, e, r in zip(starts, np.append(starts[1:], period), rates))
    return full * per + part


def inverse(segments, u: np.ndarray) -> np.ndarray:
    """Times t with ``integrated(t) == u`` (u sorted, non-negative)."""
    starts, rates, period = rate_profile(segments)
    ends = np.append(starts[1:], period)
    per = float(np.sum((ends - starts) * rates))
    cum = np.concatenate([[0.0], np.cumsum((ends - starts) * rates)])
    full, rest = np.divmod(u, per)
    out = np.empty_like(u)
    for i, (f, r) in enumerate(zip(full, rest)):
        j = int(np.searchsorted(cum, r, side="right") - 1)
        j = min(j, len(rates) - 1)
        while rates[j] <= 0:            # a silent segment: skip past it
            j += 1
        out[i] = f * period + starts[j] + (r - cum[j]) / rates[j]
    return out


def arrivals(segments, lo: float, hi: float, n: int, rng) -> np.ndarray:
    """``n`` sorted arrival times in [lo, hi) of the Poisson process with the
    rate ``segments``, given that ``n`` fall there."""
    a, b = integrated(segments, lo), integrated(segments, hi)
    return inverse(segments, np.sort(rng.uniform(a, b, n)))


def schedule(mix: dict, seed: int, seconds: float, vocab: int) -> list[Planned]:
    """The requests due in [0, ramp_s + seconds) for this seed."""
    rng = np.random.default_rng(seed)
    path = rng if mix.get("path_seed") is None else np.random.default_rng(int(mix["path_seed"]))
    ramp = float(mix.get("ramp_s", 0.0))
    due, plens, olens = [], [], []
    for lo, hi in ((0.0, ramp), (ramp, ramp + float(seconds))):
        n = int(round(integrated(mix["rate"], hi) - integrated(mix["rate"], lo)))
        if n == 0:
            continue
        due.append(np.clip(arrivals(mix["rate"], lo, hi, n, path), lo, np.nextafter(hi, lo)))
        plens.append(path.permutation(log_uniform(*mix["prompt_len"], n)))
        olens.append(path.permutation(log_uniform(*mix["output_len"], n)))
    if not due:
        return []
    due, plens, olens = (np.concatenate(x) for x in (due, plens, olens))
    return [
        Planned(rid=i, due=float(due[i]),
                prompt=rng.integers(0, vocab, int(plens[i]), dtype=np.int32),
                max_new=int(olens[i]))
        for i in range(len(due))
    ]

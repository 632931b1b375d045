"""The knee of an open-loop cell: the highest steady Poisson rate whose
backlog does not grow through a window.

    python3 bench/sweep.py --workload <cell> --rates 3,4,5 --seconds 50 [--seed 7]

One process builds the cell once (weights, engine, warm-up), then runs the
cell's mix at each rate in turn as a steady Poisson process (the mix's
lengths and ramp, one segment of ``[1, rate]``), each with its own window.
For each rate it prints one JSON line: tokens/s, the TTFT and TPOT
quantiles, the backlog (requests due and without a first token) at the
window's opening and close and its least-squares slope in requests/s over
the window, and the attainment: the share of requests due in the window
whose TTFT and TPOT met ``--ttft-slo`` and ``--tpot-slo-ms``. The knee is
the highest rate whose slope stays near 0 while the slope above it grows.
"""

from __future__ import annotations

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
# as in run.py: this folder's modules must not shadow the standard library's
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path[:0] = [os.path.dirname(_HERE), os.path.join(os.path.dirname(_HERE), "src")]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from bench import readings  # noqa: E402
from bench.run import ROOT, Ctx  # noqa: E402


def backlog(rec, step_s: float = 1.0) -> tuple[list, float]:
    """(backlog sampled every ``step_s`` through the window, its slope)."""
    t = np.arange(rec.window[0], rec.window[1] + 1e-9, step_s)
    due = np.array([r["due_ts"] for r in rec.requests.values()])
    first = np.array([r["first_ts"] if r["first_ts"] is not None else np.inf
                      for r in rec.requests.values()])
    n = [int(np.sum((due <= x) & (first > x))) for x in t]
    slope = float(np.polyfit(t - t[0], n, 1)[0]) if len(t) > 1 else 0.0
    return n, slope


def attainment(rec, ttft_slo: float, tpot_slo_s: float) -> float:
    ok = total = 0
    close = rec.window[1]
    for r in rec.requests.values():
        if not rec.in_window(r["due_ts"]):
            continue
        total += 1
        ts = [t for _, t in r["tokens"] if t < close]
        first = r["first_ts"] if r["first_ts"] is not None and r["first_ts"] < close else None
        tp = (ts[-1] - ts[0]) / (len(ts) - 1) if len(ts) >= 2 else 0.0
        ok += first is not None and first - r["due_ts"] <= ttft_slo and tp <= tpot_slo_s
    return ok / total if total else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ttft-slo", type=float, default=2.0)
    ap.add_argument("--tpot-slo-ms", type=float, default=150.0)
    args = ap.parse_args(argv)
    import torch

    from bench.cell import driver, resolve
    from bench.model import program_config

    cell = resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("the sweep runs on the card", file=sys.stderr)
        return 3
    cfg, conf = program_config(cell.config)
    drv = driver(cell.traffic["driver"], ROOT)
    ctx = Ctx(cell=cell, cfg=cfg, conf=conf, traffic=cell.traffic, checks=cell.checks,
              seed=args.seed, seconds=args.seconds, trace=False, device="cuda", t_proc0=time.monotonic())
    state = drv.setup(ctx)
    for rate in (float(r) for r in args.rates.split(",")):
        ctx.traffic = dict(cell.traffic, rate=[[1.0, rate]])
        rec = drv.window(ctx, state)
        n, slope = backlog(rec)
        print(json.dumps({
            "workload": args.workload, "rate": rate, "seconds": args.seconds,
            "due": rec.attempted, "tokens_per_s": readings.window_tokens(rec) / rec.seconds,
            "ttft_p50_s": readings.p50(readings.ttft(rec)),
            "ttft_p90_s": readings.p90(readings.ttft(rec)),
            "tpot_p90_ms": 1e3 * (readings.p90(readings.tpot(rec)) or 0.0),
            "decode_step_ms": 1e3 * (readings.p50([s["t_end"] - s["t_start"]
                                                   for s in readings.steps(rec, True)]) or 0.0),
            "prefill_ms_p50": 1e3 * (readings.p50([p["t_end"] - p["t_start"]
                                                   for p in readings.prefills(rec)]) or 0.0),
            "slots_busy": float(np.mean([len(s["positions"]) for s in readings.steps(rec)]
                                        or [0])),
            "backlog_open": n[0], "backlog_close": n[-1], "backlog_slope": slope,
            "attainment": attainment(rec, args.ttft_slo, args.tpot_slo_ms / 1e3),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

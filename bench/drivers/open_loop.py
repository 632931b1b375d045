"""Open-loop serving through ``ServeEngine.serve_loop``.

Set-up makes the weights from the seed, builds the engine (``cache_len``
and the loop's ``max_new_cap`` from the mix's longest prompt and answer,
``max_batch`` and ``impl`` from the configuration's ``engine``) and warms
the path with one short loop at the mix's shortest and longest prompts.

The window: the mix's schedule (``bench/traffic.py``) starts ``ramp_s``
before the window opens, so the slots are at steady occupancy when it
does. ``source()`` hands each request to the loop once it falls due (its
lateness is printed); ``on_delta`` stamps every streamed token; the loop
runs greedy with streaming on, and is stopped at the window's close by an
exception from those callbacks (each runs right after the loop has
synchronised with the card). With ``--trace 1`` the profiler covers
``trace_s`` seconds from ``trace_at_s`` into the window, started and
stopped at such points.

The check: once the window has closed, the loop's state is gone and the
peak memory read, a sample of the requests finished in the window (the
longest among them) is held against the float32 reference
(``bench/compare.py``).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from bench import compare
from bench import traffic as gen
from bench.record import Record
from bench.trace import Tracer
from bench.weights import make_weights


class _Closed(Exception):
    """The window has closed: leave the serving loop."""


def _engine_args(ctx) -> dict:
    mix = ctx.traffic
    return {"cache_len": mix["prompt_len"][1] + mix["output_len"][1],
            "max_new_cap": mix["output_len"][1]}


def setup(ctx) -> dict:
    from repro_torch import models
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import STOP, Request

    weights = make_weights(models.param_specs(ctx.cfg), ctx.seed, ctx.device)
    eng = ctx.conf["engine"]
    args = _engine_args(ctx)
    engine = ServeEngine(ctx.cfg, weights, impl=eng["impl"], cache_len=args["cache_len"],
                         device=ctx.device)
    rng = np.random.default_rng(ctx.seed)
    warm = [Request(rid=i, prompt=rng.integers(0, ctx.cfg.vocab_size, n, dtype=np.int32),
                    max_new_tokens=2)
            for i, n in enumerate(ctx.traffic["prompt_len"])]
    feed = iter(warm + [STOP])
    engine.serve_loop(lambda: next(feed), lambda c: None, max_batch=eng["max_batch"],
                      max_queue=len(warm) + 1, max_new_cap=args["max_new_cap"],
                      on_delta=lambda d: None)
    return {"weights": weights, "engine": engine}


def window(ctx, st) -> Record:
    from repro_torch.serve.scheduler import Request

    mix = ctx.traffic
    plan = gen.schedule(mix, ctx.seed, ctx.seconds, ctx.cfg.vocab_size)
    rec = Record("serve", ctx.conf)
    tracer = Tracer(ctx.trace, str(ctx.device))
    tracer.warm()
    t0 = time.monotonic()
    rec.setup_s = t0 - ctx.t_proc0
    ramp = float(mix.get("ramp_s", 0.0))
    rec.window = (t0 + ramp, t0 + ramp + ctx.seconds)
    trace_from = rec.window[0] + float(mix.get("trace_at_s", 0.0))
    trace_to = trace_from + float(mix.get("trace_s", ctx.seconds))
    reqs = rec.requests
    for p in plan:
        reqs[p.rid] = {"rid": p.rid, "due_ts": t0 + p.due, "prompt": p.prompt,
                       "prompt_len": len(p.prompt), "max_new": p.max_new, "handed_ts": None,
                       "first_ts": None, "tokens": [], "finished_ts": None, "out": None,
                       "status": None}
    state = {"next": 0, "last": t0, "burst": None}

    def tick(now: float) -> None:
        if now >= rec.window[1]:
            raise _Closed
        if tracer.enabled and tracer.prof is None and now >= trace_from:
            tracer.start()
        elif tracer.running and now >= trace_to:
            tracer.stop()

    def source():
        now = time.monotonic()
        tick(now)
        i = state["next"]
        if i < len(plan) and reqs[i]["due_ts"] <= now:
            r = reqs[i]
            state["next"] = i + 1
            r["handed_ts"] = now
            return Request(rid=i, prompt=r["prompt"], max_new_tokens=r["max_new"],
                           enqueued_ts=r["due_ts"])
        return None

    def on_delta(d) -> None:
        now = time.monotonic()
        r = reqs[d.rid]
        r["tokens"].append((d.seq, now))
        if d.seq == 0:
            r["first_ts"] = now
            begin = max(state["last"], r["handed_ts"])
            rec.prefills.append({"t_start": begin, "t_end": now, "S": r["prompt_len"],
                                 "rid": d.rid})
            rec.spans.append(("admit_prefill", begin, now))
            state["last"], state["burst"] = now, None
        else:
            b = state["burst"]
            if b is None or d.rid in b["rids"]:
                b = {"t_start": state["last"], "t_end": now, "rids": set(), "positions": [],
                     "clean": b is not None}
                rec.steps.append(b)
                rec.spans.append(("decode_step", b["t_start"], now))
                state["last"], state["burst"] = now, b
            b["rids"].add(d.rid)
            b["positions"].append(r["prompt_len"] + d.seq - 1)
        tick(now)

    def sink(comp) -> None:
        r = reqs[comp.rid]
        r["finished_ts"], r["out"], r["status"] = time.monotonic(), comp.tokens, comp.status

    try:
        st["engine"].serve_loop(source, sink, max_batch=ctx.conf["engine"]["max_batch"],
                                max_queue=len(plan) + 1,
                                max_new_cap=_engine_args(ctx)["max_new_cap"],
                                on_delta=on_delta)
    except _Closed:
        pass
    if tracer.running:
        tracer.stop()
    rec.trace = tracer.summary(rec.spans)
    due = [r for r in reqs.values() if rec.in_window(r["due_ts"])]
    rec.attempted = len(due)
    rec.failed = sum(1 for r in due if r["status"] not in (None, "ok"))
    late = np.array([r["handed_ts"] - r["due_ts"] for r in reqs.values() if r["handed_ts"]])
    if late.size:
        print(f"hand-over lateness: {late.size} requests handed, p50 {np.median(late):.6f} s, "
              f"p99 {np.quantile(late, 0.99):.6f} s, max {late.max():.6f} s; "
              f"{len(plan) - late.size} never handed", file=sys.stderr)
    return rec


def check(ctx, st, rec: Record) -> dict:
    st["engine"] = None                      # the program's state goes first
    reqs = rec.requests
    finished = {rid: r["prompt_len"] + len(r["out"]) for rid, r in reqs.items()
                if r["finished_ts"] is not None and rec.in_window(r["finished_ts"])
                and r["status"] == "ok"}
    picks = compare.sample(finished, int(ctx.checks["sample_requests"]), ctx.seed)
    served, ctrl = [], []
    for rid in picks:
        gap, low = compare.gaps(st["weights"], ctx.conf, reqs[rid]["prompt"], reqs[rid]["out"],
                                ctx.device, ctx.control)
        served.append(gap)
        if low is not None:
            ctrl.append(low)
    ctx.readings = compare.readings(served, ctrl)
    print(f"compared {len(picks)} of {len(finished)} requests finished in the window, "
          f"{sum(g.numel() for g in served)} served tokens", file=sys.stderr)
    return {**compare.checks(ctx.readings, ctx.checks["limits"]),
            **compare.check("unchecked", 0 if picks else 1, 0)}

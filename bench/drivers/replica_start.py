"""Replica starts from a committed epoch, back to back.

Set-up makes the weights from the seed and publishes them, with the
serving app that imports them, into a workspace at a fixed directory
inside the checkout (``build/bench/ws/<config>``, emptied first: it holds
one world, this seed's), with ``bake_arenas=False`` so the epoch path is
the table-driven one and nothing goes to ``/dev/shm``. One start warms the
kernels and shapes.

The window: each iteration drops the previous replica, then runs
``ServeEngine.from_workspace(cfg, ws, app, strategy=<mix's>, device)``
(during an epoch ``auto`` is the table-driven ``stable`` load: the arena
built on the card by one ``paged_reloc_copy``, the parameters lifted as its
views) and serves one request of ``prompt_len`` tokens to its first token
(``generate``: a B=1 prefill and its argmax, read back to the host). Where
the run profiles (``--trace 1``, or an end-to-end metric of the cell read
from the device trace, as ``start_device_ms`` is) the profiler covers the
starts that begin within the mix's ``trace_s`` seconds of the window's
opening.

The check: every parameter of the last replica equal, bit for bit, to the
weights the benchmark made (the arena the copy built); and each sampled
start's first token held against the float32 reference over its prompt.
"""

from __future__ import annotations

import shutil
import sys
import time

import numpy as np
import torch

from bench import compare
from bench.record import Record
from bench.trace import Tracer
from bench.weights import make_weights


def _publish(ctx, weights) -> tuple:
    from repro_torch import models
    from repro_torch.ckpt import bundle_from_params
    from repro_torch.core import ObjectKind, make_object
    from repro_torch.link import Workspace

    root = ctx.cell.root / "build" / "bench" / "ws" / ctx.cell.config_name
    shutil.rmtree(root, ignore_errors=True)
    ws = Workspace.open(root, bake_arenas=False)
    bundle, payload = bundle_from_params(f"weights:{ctx.cfg.name}", "v1", weights,
                                         specs=models.param_specs(ctx.cfg))
    app, _ = make_object(name=f"serve:{ctx.cfg.name}", version="1",
                         kind=ObjectKind.APPLICATION, refs=models.manifest_refs(ctx.cfg),
                         needed=[bundle.name])
    with ws.management() as tx:
        tx.publish(bundle, payload)
        tx.publish(app)
    return ws, app.name


def _start(ctx, ws, app, prompt):
    """One replica: (engine, its first token, t0, lifted_ts, first_ts)."""
    from repro_torch.serve import ServeEngine

    t0 = time.monotonic()
    engine = ServeEngine.from_workspace(ctx.cfg, ws, app, strategy=ctx.traffic["strategy"],
                                        device=ctx.device)
    lifted = time.monotonic()
    tok, _ = engine.generate(prompt[None], 1)
    return engine, int(tok[0, 0]), t0, lifted, time.monotonic()


def setup(ctx) -> dict:
    from repro_torch import models

    weights = make_weights(models.param_specs(ctx.cfg), ctx.seed, ctx.device)
    ws, app = _publish(ctx, weights)
    rng = np.random.default_rng(ctx.seed)
    n = int(ctx.traffic["max_starts_per_s"] * ctx.seconds) + 1
    prompts = rng.integers(0, ctx.cfg.vocab_size, (n, ctx.traffic["prompt_len"]), dtype=np.int32)
    _start(ctx, ws, app, prompts[0])
    return {"weights": weights, "ws": ws, "app": app, "prompts": prompts, "engine": None}


def window(ctx, st) -> Record:
    rec = Record("start", ctx.conf)
    tracer = Tracer(ctx.profile, str(ctx.device))
    tracer.warm()
    t_open = time.monotonic()
    rec.setup_s = t_open - ctx.t_proc0
    rec.window = (t_open, t_open + ctx.seconds)
    trace_to = t_open + float(ctx.traffic.get("trace_s", ctx.seconds))
    if tracer.enabled:
        tracer.start()
    i = 0
    while time.monotonic() < rec.window[1] and i < len(st["prompts"]):
        if tracer.running and time.monotonic() >= trace_to:
            tracer.stop()
        t_drop = time.monotonic()
        st["engine"] = None
        rec.spans.append(("drop", t_drop, time.monotonic()))
        eng, tok, t0, lifted, first = _start(ctx, st["ws"], st["app"], st["prompts"][i])
        st["engine"] = eng
        s = eng.load_stats
        rec.spans += [("load", t0, t0 + s.startup_s), ("lift", t0 + s.startup_s, lifted),
                      ("first_token", lifted, first)]
        rec.starts.append({"i": i, "t0": t0, "load_s": s.startup_s, "lifted_ts": lifted,
                           "first_ts": first, "token": tok, "payload_bytes": s.bytes_loaded,
                           "upload_s": s.upload_s, "kernel_s": s.kernel_s,
                           "S": ctx.traffic["prompt_len"]})
        i += 1
    if tracer.running:
        tracer.stop()
    rec.trace = tracer.summary(rec.spans)
    rec.attempted = len(rec.starts)
    rec.failed = 0
    return rec


def check(ctx, st, rec: Record) -> dict:
    params = st["engine"].params
    mismatched = sum(0 if torch.equal(params[n], w) else 1 for n, w in st["weights"].items())
    st["engine"] = None
    done = {s["i"]: 1 for s in rec.starts}
    picks = compare.sample(done, int(ctx.checks["sample_requests"]), ctx.seed)
    served, ctrl = [], []
    for i in picks:
        gap, low = compare.gaps(st["weights"], ctx.conf, st["prompts"][i],
                                np.array([rec.starts[i]["token"]]), ctx.device, ctx.control)
        served.append(gap)
        if low is not None:
            ctrl.append(low)
    ctx.readings = compare.readings(served, ctrl)
    print(f"compared the arena of the last of {len(rec.starts)} replicas and the first "
          f"tokens of {len(picks)}", file=sys.stderr)
    return {**compare.check("arena_mismatch", mismatched, 0),
            **compare.checks(ctx.readings, ctx.checks["limits"]),
            **compare.check("unchecked", 0 if picks else 1, 0)}

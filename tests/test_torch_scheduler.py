"""The port's continuous-batching scheduler against the reference's: the
same weights and prompts through both ``serve_loop``s, the reference's
in-process scheduler tests mirrored on the port, per-row decode positions,
and the port's counter-based sampling (its bits cannot be JAX's, so its
properties are tested instead)."""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro.serve import Request as RefRequest
from repro.serve import STOP as REF_STOP
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import convert, models
from repro_torch.configs import get_config
from repro_torch.core import EpochCache
from repro_torch.link import Workspace
from repro_torch.serve import STOP, Request, ServeEngine, faults
from repro_torch.serve import scheduler as sch
from repro_torch.serve.scheduler import run_serve_loop

ARCH = "gemma3-1b"          # smoke: 2 layers, window 16 on layer 0, MQA


def _shared(arch, seed=0):
    """(port cfg, port params, reference cfg, reference params): one set of
    weights, drawn by the reference and handed to both."""
    rcfg = ref_config(arch, smoke=True)
    rparams = ref_models.init_params(rcfg, seed)
    cfg = get_config(arch, smoke=True)
    params = convert.params_from_numpy(
        {n: np.asarray(v) for n, v in rparams.items()}, models.param_specs(cfg), "cpu")
    return cfg, params, rcfg, rparams


def _engine(arch=ARCH, cache_len=40, seed=0):
    cfg, params, _, _ = _shared(arch, seed)
    return cfg, ServeEngine(cfg, params, cache_len=cache_len, device="cpu")


def _serve(engine, reqs, **kw):
    feed = iter(list(reqs) + [STOP])
    done = {}
    rep = engine.serve_loop(lambda: next(feed, STOP),
                            lambda c: done.setdefault(c.rid, c), **kw)
    return rep, done


# ------------------------------------------------------ per-row decode
@pytest.mark.parametrize("arch", [ARCH, "deepseek-67b"])
def test_batched_decode_rows_equal_single_row_calls(arch):
    """decode_step with per-row positions: each row of the batched call is
    the B=1 call on that row (positions straddle the window and wrap the
    ring of S = 24)."""
    cfg, params, _, _ = _shared(arch)
    rng = np.random.default_rng(0)
    S, lens = 24, [5, 16, 19, 23]
    rows = []
    for n in lens:
        t = torch.from_numpy(rng.integers(0, 256, (1, n), dtype=np.int32))
        _, c = models.prefill(cfg, params, {"tokens": t}, cache_len=S)
        rows.append(c)
    batch = {"k": torch.cat([c["k"] for c in rows], 1),
             "v": torch.cat([c["v"] for c in rows], 1),
             "pos": tuple(c["pos"] for c in rows)}
    toks = torch.from_numpy(rng.integers(0, 256, (len(lens), 1), dtype=np.int32))
    for step in range(4):                  # positions reach 26 > S: ring wrap
        got, batch = models.decode_step(cfg, params, batch, toks)
        for b, c in enumerate(rows):
            want, rows[b] = models.decode_step(cfg, params, c, toks[b:b + 1])
            assert (got[b] - want[0]).abs().max().item() <= 1e-5
            assert int(got[b].argmax()) == int(want[0].argmax())
        assert batch["pos"] == tuple(c["pos"] for c in rows)
        toks = got[:, -1].argmax(-1).to(torch.int32)[:, None]


# ----------------------------------------------- against the reference
def _mixed_requests(cfg, lens, new, seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32), new)
            for i, n in enumerate(lens)]


@pytest.mark.parametrize("arch,lens", [(ARCH, [12, 16, 21, 12, 30]),
                                       ("deepseek-67b", [9, 14, 9])])
def test_greedy_serve_loop_matches_reference_serve_loop(arch, lens):
    cfg, params, rcfg, rparams = _shared(arch)
    reqs = _mixed_requests(cfg, lens, 7, seed=len(lens))
    port = ServeEngine(cfg, params, cache_len=40, device="cpu")
    rep, got = _serve(port, [Request(rid=i, prompt=p, max_new_tokens=n)
                             for i, p, n in reqs], max_batch=2)
    ref = RefServeEngine(rcfg, rparams, cache_len=40, impl="naive")
    feed = iter([RefRequest(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs]
                + [REF_STOP])
    want = {}
    ref_rep = ref.serve_loop(lambda: next(feed, REF_STOP),
                             lambda c: want.setdefault(c.rid, c), max_batch=2)
    for i, _, _ in reqs:
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert (rep.admitted, rep.steps, rep.tokens_out) == (
        ref_rep.admitted, ref_rep.steps, ref_rep.tokens_out)


def test_serve_loop_matches_generate():
    cfg, engine = _engine()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (3, 12), dtype=np.int32)
    ref, _ = engine.generate(prompts, 6)
    report, done = _serve(engine, [Request(rid=i, prompt=prompts[i], max_new_tokens=6)
                                   for i in range(3)], max_batch=2)
    assert report.completed == 3 and report.admitted == 3
    assert report.peak_active <= 2
    assert report.tokens_out == 18
    for i in range(3):
        np.testing.assert_array_equal(done[i].tokens, ref[i])
        assert done[i].tokens.dtype == np.int32


def test_serve_loop_staggered_arrivals_reuse_slots():
    cfg, engine = _engine()
    rng = np.random.default_rng(1)
    n = 5
    prompts = rng.integers(0, cfg.vocab_size, (n, 10), dtype=np.int32)
    ref, _ = engine.generate(prompts, 4)
    pending = deque(Request(rid=i, prompt=prompts[i], max_new_tokens=4)
                    for i in range(n))
    calls = {"n": 0}

    def trickle():
        calls["n"] += 1
        if not pending:
            return STOP
        return pending.popleft() if calls["n"] % 2 else None

    done = {}
    report = engine.serve_loop(trickle, lambda c: done.setdefault(c.rid, c),
                               max_batch=2, max_queue=2)
    assert report.completed == n and report.admitted == n
    assert report.peak_active <= 2 and report.peak_queue <= 2
    assert report.steps < n * 4
    for i in range(n):
        np.testing.assert_array_equal(done[i].tokens, ref[i])


def test_serve_loop_requires_decode_headroom():
    _, engine = _engine(cache_len=0)
    with pytest.raises(ValueError, match="cache_len"):
        engine.serve_loop(lambda: STOP, lambda c: None)


# ---------------------------------------------- streaming and sampling
def test_serve_loop_stream_matches_nonstream_byte_identical():
    cfg, engine = _engine()
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (3, 12), dtype=np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=6) for i in range(3)]
    kw = dict(max_batch=2, temperature=0.7, top_k=8, sampling_seed=42)
    rep0, done0 = _serve(engine, reqs, **kw)
    deltas = []
    rep1, done1 = _serve(engine, reqs, on_delta=deltas.append, **kw)
    assert rep0.deltas_out == 0 and rep1.deltas_out == 18
    spans: dict[int, dict[int, int]] = {}
    for d in deltas:
        for off, tok in enumerate(d.tokens):
            spans.setdefault(d.rid, {}).setdefault(d.seq + off, tok)
    for i in range(3):
        np.testing.assert_array_equal(done0[i].tokens, done1[i].tokens)
        assert sorted(spans[i]) == list(range(6))
        toks = np.array([spans[i][s] for s in range(6)], dtype=np.int32)
        np.testing.assert_array_equal(toks, done1[i].tokens)


def test_sampling_is_independent_of_batch_composition():
    cfg, engine = _engine()
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, cfg.vocab_size, (3, 12), dtype=np.int32)

    def run(rids, max_batch, seed=7):
        return _serve(engine, [Request(rid=i, prompt=prompts[i], max_new_tokens=5)
                               for i in rids],
                      max_batch=max_batch, temperature=0.7, top_k=8,
                      sampling_seed=seed)[1]

    batched = run([0, 1, 2], 3)
    solo = run([1], 1)
    np.testing.assert_array_equal(solo[1].tokens, batched[1].tokens)
    other = run([1], 1, seed=8)
    assert not np.array_equal(other[1].tokens, batched[1].tokens)


def test_top_k_one_sampling_equals_greedy():
    cfg, engine = _engine()
    rng = np.random.default_rng(6)
    prompts = rng.integers(0, cfg.vocab_size, (3, 14), dtype=np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=6) for i in range(3)]
    _, greedy = _serve(engine, reqs, max_batch=2)
    _, top1 = _serve(engine, reqs, max_batch=2, temperature=1.3, top_k=1,
                     sampling_seed=11)
    for i in range(3):
        np.testing.assert_array_equal(top1[i].tokens, greedy[i].tokens)


def test_sampling_never_draws_outside_the_top_k():
    rng = np.random.default_rng(8)
    logits = torch.from_numpy(rng.standard_normal((6, 256)).astype(np.float32))
    top = torch.topk(logits, 5, dim=-1).indices
    keys = torch.tensor([sch.request_key(3, r) for r in range(6)])
    seen = set()
    for i in range(300):
        tok = sch.pick_tokens(logits, keys, torch.full((6,), i), temperature=2.0,
                              top_k=5)
        assert bool((top == tok[:, None].long()).any(-1).all())
        seen.update(tok.tolist())
    assert len(seen) > 6                     # it samples, it is not argmax


def test_splitmix_bits_match_a_uint64_reference_and_take_64_bit_rids():
    mask = (1 << 64) - 1

    def fmix(x):
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & mask
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & mask
        return x ^ (x >> 31)

    rids = [0, 1, 2**32 - 1, 2**32, 2**32 + 1, 2**40 + 5, 2**63 + 9, 2**64 - 1]
    keys = [sch.request_key(5, r) for r in rids]
    assert len(set(keys)) == len(rids)        # the high half is kept
    assert all(-(2**63) <= k < 2**63 for k in keys)
    u = sch.uniforms(torch.tensor(keys), torch.tensor([3] * len(rids)), 4)
    for b, k in enumerate(keys):
        row = fmix((k + 4 * 0x9E3779B97F4A7C15) & mask)
        for v in range(4):
            h = fmix((row + (v + 1) * 0x9E3779B97F4A7C15) & mask)
            assert u[b, v].item() == ((h >> 11) + 0.5) * 2.0**-53
    # a 64-bit rid serves end to end, on its own stream
    cfg, engine = _engine()
    prompt = np.arange(10, dtype=np.int32)
    _, done = _serve(engine, [Request(rid=2**64 - 1, prompt=prompt, max_new_tokens=4),
                              Request(rid=2**32 - 1, prompt=prompt, max_new_tokens=4)],
                     max_batch=2, temperature=1.0, sampling_seed=1)
    assert done[2**64 - 1].tokens.shape == (4,)
    assert not np.array_equal(done[2**64 - 1].tokens, done[2**32 - 1].tokens)


# ------------------------------------------------------------ priority
def test_serve_loop_priority_admission_order_and_counts():
    cfg, engine = _engine()
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (4, 10), dtype=np.int32)
    reqs = [Request(rid=0, prompt=prompts[0], max_new_tokens=6, priority=0),
            Request(rid=1, prompt=prompts[1], max_new_tokens=2, priority=0),
            Request(rid=2, prompt=prompts[2], max_new_tokens=2, priority=5),
            Request(rid=3, prompt=prompts[3], max_new_tokens=2, priority=5)]
    feed = iter(reqs + [STOP])
    order = []
    rep = engine.serve_loop(lambda: next(feed, STOP), lambda c: order.append(c.rid),
                            max_batch=1, max_queue=4, priority_aging_s=0.0)
    assert rep.completed == 4
    assert order == [2, 3, 0, 1]
    assert rep.admitted_by_priority == {0: 2, 5: 2}
    assert rep.priority_aged == 0


def test_serve_loop_priority_aging_bounds_starvation():
    cfg, engine = _engine()
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (3, 10), dtype=np.int32)
    reqs = [Request(rid=0, prompt=prompts[0], max_new_tokens=6, priority=5),
            Request(rid=1, prompt=prompts[1], max_new_tokens=2, priority=0),
            Request(rid=2, prompt=prompts[2], max_new_tokens=2, priority=5)]
    offers = iter(reqs + [STOP])

    def source():
        nxt = next(offers, STOP)
        if nxt is not STOP and nxt.rid == 2:
            time.sleep(0.03)               # rid 1 ages before rid 2 lands
        return nxt

    order = []
    rep = engine.serve_loop(source, lambda c: order.append(c.rid),
                            max_batch=1, max_queue=4, priority_aging_s=0.005)
    assert rep.completed == 3
    assert order == [0, 1, 2]
    assert rep.priority_aged >= 1


# ----------------------------------------------------------- deadlines
def test_request_deadline_returns_structured_frame():
    cfg, engine = _engine()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 10), dtype=np.int32)
    now = time.monotonic()
    report, done = _serve(engine, [
        Request(rid=0, prompt=prompts[0], max_new_tokens=4,
                enqueued_ts=now - 1.0, deadline_s=0.001),
        Request(rid=1, prompt=prompts[1], max_new_tokens=4)], max_batch=2)
    assert report.deadline_expired == 1
    assert done[0].status == "deadline" and done[0].tokens.shape[0] == 0
    assert done[1].status == "ok" and done[1].tokens.shape == (4,)
    assert report.completed == 1


def test_in_flight_slot_deadline_frees_slot_with_partial_row():
    cfg, engine = _engine(cache_len=16)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (10,), dtype=np.int32)
    feed = iter([Request(rid=0, prompt=prompt, max_new_tokens=512, deadline_s=0.05),
                 STOP])
    done = {}
    report = run_serve_loop(engine, lambda: next(feed, STOP),
                            lambda c: done.setdefault(c.rid, c),
                            max_batch=1, max_new_cap=512)
    assert report.deadline_expired == 1
    assert done[0].status == "deadline"
    assert 0 < done[0].tokens.shape[0] < 512
    assert report.completed == 0


# ------------------------------------------------------------ rollovers
def test_back_to_back_commits_coalesce_to_newest():
    cfg, engine = _engine()
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10),
                                                dtype=np.int32)

    class Change:
        def __init__(self, gen):
            self.epoch_gen = gen

    class Watch:
        calls = 0

        def poll(self):
            self.calls += 1
            return Change(self.calls) if self.calls in (2, 3) else None

    adopted = []
    feed = deque([Request(rid=0, prompt=prompts[0], max_new_tokens=8), None,
                  Request(rid=1, prompt=prompts[1], max_new_tokens=4), STOP])
    done = {}
    report = run_serve_loop(engine, lambda: feed.popleft() if feed else STOP,
                            lambda c: done.setdefault(c.rid, c), max_batch=1,
                            max_new_cap=8, epoch_watch=Watch(),
                            on_epoch=lambda ch: adopted.append(ch.epoch_gen),
                            watch_interval_s=0.0)
    assert adopted == [3]
    assert report.rollovers == 1 and report.coalesced_rollovers == 1
    assert report.completed == 2


def test_serve_loop_survives_aborted_flip(tmp_path):
    """A wedged device reload deadlines: the loop counts the abort, resumes
    on the rolled-back weights and completes every request."""
    from repro_torch.ckpt import bundle_from_params
    from repro_torch.launch import serve as launch_serve

    ws = Workspace.open(tmp_path / "s", epoch_cache=EpochCache())
    cfg = get_config(ARCH, smoke=True)
    app = launch_serve.publish_model(ws, cfg, device="cpu")
    engine = ServeEngine.from_workspace(cfg, ws, app, strategy="stable",
                                        cache_len=24, device="cpu")
    v1 = {n: t.clone() for n, t in engine.params.items()}
    faults.install(faults.FaultPlan(wedge_adopt_s=30.0))
    prompts = np.random.default_rng(3).integers(0, cfg.vocab_size, (4, 10),
                                                dtype=np.int32)
    state = {"k": 0, "committed": False}

    def source():
        k = state["k"]
        if k == 1 and not state["committed"]:
            params = models.init_params(cfg, 1, "cpu")
            bundle, payload = bundle_from_params(
                f"weights:{cfg.name}", "v2", params, specs=models.param_specs(cfg))
            with ws.management() as tx:
                tx.publish(bundle, payload)
            state["committed"] = True
        if k >= 4:
            return STOP
        state["k"] += 1
        return Request(rid=k, prompt=prompts[k], max_new_tokens=4)

    done = {}
    try:
        report = run_serve_loop(
            engine, source, lambda c: done.setdefault(c.rid, c),
            max_batch=2, max_new_cap=4, epoch_watch=ws.epoch_watch(),
            on_epoch=lambda ch: engine.adopt_epoch(ws, app, strategy="stable",
                                                   deadline_s=0.25),
            watch_interval_s=0.0)
    finally:
        faults.clear()
    assert report.completed == 4
    assert report.rollover_aborts == 1 and report.rollovers >= 1
    assert ws.manager.rolled_back_from > 0
    assert all(torch.equal(v1[n], engine.params[n]) for n in v1)

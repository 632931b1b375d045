"""The port's encoder-decoder family (seamless-m4t-large-v2 smoke) against
the reference's, on shared weights and the same stubbed frames: forward,
prefill with its cross keys and values, greedy decode, ``generate`` and
``serve_loop``, a traffic drive; and the mixed prompt lengths that the
reference's scheduler cannot serve (ROADMAP Queue C), held per request
against the reference serving each request on its own."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro.serve import Request as RefRequest
from repro.serve import STOP as REF_STOP
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import EpochCache
from repro_torch.launch.serve import publish_model
from repro_torch.link import Workspace
from repro_torch.serve import STOP, Request, ServeEngine, run_traffic
from repro_torch.serve.scheduler import stub_frames

ARCH = "seamless-m4t-large-v2"   # smoke: 2 encoder + 2 decoder layers, gelu, LayerNorm
B, S, N_DECODE = 2, 12, 8
F32_TOL = 1e-4
CACHE = 40


def _frames(b, s, d):
    return np.random.default_rng(0).standard_normal((b, s, d))


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's params, forward logits, prefill logits and cache,
    and greedy tokens over N_DECODE steps, on the engine's frames stub."""
    cfg = ref_config(ARCH, smoke=True)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(cfg, 0).items()}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks),
             "frames": jnp.asarray(_frames(B, S, cfg.d_model), jnp.float32)}

    def run(p, b):
        logits, aux = ref_models.forward(cfg, p, b)
        pre, cache = ref_models.prefill(cfg, p, b, cache_len=S + N_DECODE)
        return logits, aux, pre, cache

    logits, aux, pre, cache = jax.jit(run)(params, batch)
    ref_cache = {n: np.asarray(v) for n, v in cache.items()}
    step = jax.jit(lambda p, c, t: ref_models.decode_step(cfg, p, c, t))
    tok = jnp.argmax(pre[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(N_DECODE):
        lg, cache = step(params, cache, tok)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return (params, toks, np.asarray(logits), float(aux), np.asarray(pre), ref_cache,
            np.concatenate(out, 1))


def _port():
    cfg = get_config(ARCH, smoke=True)
    params_np, toks, *_ = _reference()
    batch = {"tokens": torch.from_numpy(toks), "frames": stub_frames(cfg, B, S, "cpu")}
    return cfg, params_from_numpy(params_np, models.param_specs(cfg), "cpu"), batch


def test_stub_frames_are_the_references_draw():
    cfg = get_config(ARCH, smoke=True)
    np.testing.assert_array_equal(stub_frames(cfg, 3, 5, "cpu").numpy(),
                                  _frames(3, 5, cfg.d_model).astype(np.float32))


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_forward_matches_reference(impl):
    cfg, params, batch = _port()
    _, _, want, want_aux, *_ = _reference()
    with torch.inference_mode():
        got, aux = models.forward(cfg, params, batch, impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    assert aux.item() == want_aux == 0.0


def test_prefill_cache_and_greedy_decode_match_reference():
    cfg, params, batch = _port()
    *_, want_pre, want_cache, want_toks = _reference()
    with torch.inference_mode():
        pre, cache = models.prefill(cfg, params, batch, cache_len=S + N_DECODE)
        np.testing.assert_allclose(pre.numpy(), want_pre, atol=F32_TOL, rtol=0)
        assert cache["pos"] == int(want_cache["pos"]) == S - 1
        for name in ("k", "v", "xk", "xv"):
            assert tuple(cache[name].shape) == want_cache[name].shape, name
            np.testing.assert_allclose(cache[name].numpy(), want_cache[name],
                                       atol=F32_TOL, rtol=0, err_msg=name)
        tok = pre[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(N_DECODE):
            lg, cache = models.decode_step(cfg, params, cache, tok)
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), want_toks)


def _shared():
    rcfg = ref_config(ARCH, smoke=True)
    rparams = ref_models.init_params(rcfg, 0)
    cfg = get_config(ARCH, smoke=True)
    params = params_from_numpy({n: np.asarray(v) for n, v in rparams.items()},
                               models.param_specs(cfg), "cpu")
    return cfg, params, rcfg, rparams


def test_generate_matches_reference_generate():
    cfg, params, rcfg, rparams = _shared()
    prompts = np.random.default_rng(2).integers(0, 256, (3, 10), dtype=np.int32)
    got, _ = ServeEngine(cfg, params, cache_len=CACHE, device="cpu").generate(prompts, 6)
    want, _ = RefServeEngine(rcfg, rparams, cache_len=CACHE).generate(prompts, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def _port_serve(engine, reqs, max_batch=2):
    feed = iter([Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs] + [STOP])
    done = {}
    rep = engine.serve_loop(lambda: next(feed, STOP),
                            lambda c: done.setdefault(c.rid, c), max_batch=max_batch)
    return rep, done


def _ref_serve(engine, reqs, max_batch=2):
    feed = iter([RefRequest(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs]
                + [REF_STOP])
    done = {}
    rep = engine.serve_loop(lambda: next(feed, REF_STOP),
                            lambda c: done.setdefault(c.rid, c), max_batch=max_batch)
    return rep, done


def _requests(lens, new=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, (n,), dtype=np.int32), new)
            for i, n in enumerate(lens)]


def test_greedy_serve_loop_matches_reference_at_equal_prompt_lengths():
    cfg, params, rcfg, rparams = _shared()
    reqs = _requests([8, 8, 8, 8, 8])
    rep, got = _port_serve(ServeEngine(cfg, params, cache_len=CACHE, device="cpu"), reqs)
    ref_rep, want = _ref_serve(RefServeEngine(rcfg, rparams, cache_len=CACHE,
                                              impl="naive"), reqs)
    for i, _, _ in reqs:
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert (rep.admitted, rep.steps, rep.tokens_out) == (
        ref_rep.admitted, ref_rep.steps, ref_rep.tokens_out)


MIXED = [8, 12, 8, 16, 5]


def test_reference_scheduler_fails_on_mixed_prompt_lengths():
    """The reproducer of the Queue C entry: the reference sizes its slot
    cache's cross K/V to the first admission's prompt, so a longer prompt
    cannot be spliced into a slot."""
    _, _, rcfg, rparams = _shared()
    with pytest.raises(TypeError, match="dynamic_update_slice update shape"):
        _ref_serve(RefServeEngine(rcfg, rparams, cache_len=CACHE, impl="naive"),
                   _requests(MIXED))


def test_mixed_prompt_lengths_match_reference_served_one_by_one():
    """The port pads every slot's cross K/V to ``cache_len`` and masks past
    each prompt's length: each request of a mixed-length ``serve_loop``
    equals the reference's one-request ``serve_loop`` of it."""
    cfg, params, rcfg, rparams = _shared()
    reqs = _requests(MIXED)
    rep, got = _port_serve(ServeEngine(cfg, params, cache_len=CACHE, device="cpu"), reqs)
    assert rep.completed == len(reqs) and rep.peak_active == 2
    ref = RefServeEngine(rcfg, rparams, cache_len=CACHE, impl="naive")
    for req in reqs:
        _, want = _ref_serve(ref, [req], max_batch=1)
        np.testing.assert_array_equal(got[req[0]].tokens, want[req[0]].tokens)


def test_batched_cross_attention_rows_equal_single_row_calls():
    """decode_step on padded cross K/V with per-row ``xpos``: each row
    equals the B=1 call on its unpadded cache."""
    cfg, params, _, _ = _shared()
    rng = np.random.default_rng(5)
    rows = []
    with torch.inference_mode():
        for n in (5, 12, 9):
            t = torch.from_numpy(rng.integers(0, 256, (1, n), dtype=np.int32))
            batch = {"tokens": t, "frames": stub_frames(cfg, 1, n, "cpu")}
            rows.append(models.prefill(cfg, params, batch, cache_len=20)[1])
        pad = {n: torch.zeros((cfg.num_layers, 3, 20) + rows[0][n].shape[3:])
               for n in ("xk", "xv")}
        for b, c in enumerate(rows):
            for n in ("xk", "xv"):
                pad[n][:, b, :c[n].shape[2]] = c[n][:, 0]
        batch = {"k": torch.cat([c["k"] for c in rows], 1),
                 "v": torch.cat([c["v"] for c in rows], 1),
                 "pos": tuple(c["pos"] for c in rows),
                 "xpos": tuple(c["xk"].shape[2] - 1 for c in rows), **pad}
        toks = torch.from_numpy(rng.integers(0, 256, (3, 1), dtype=np.int32))
        for _ in range(3):
            got, batch = models.decode_step(cfg, params, batch, toks)
            for b, c in enumerate(rows):
                want, rows[b] = models.decode_step(cfg, params, c, toks[b:b + 1])
                assert (got[b] - want[0]).abs().max().item() <= 1e-5
            toks = got[:, -1].argmax(-1).to(torch.int32)[:, None]


def test_prompt_longer_than_cache_len_is_refused_on_the_host():
    cfg, params, _, _ = _shared()
    engine = ServeEngine(cfg, params, cache_len=16, device="cpu")
    with pytest.raises(ValueError, match="cache_len of 16"):
        _port_serve(engine, _requests([8, 17]))


def test_traffic_drive_serves_seamless(tmp_path):
    """One spawned worker serves seamless smoke over the shm rings: 4
    streamed requests, each equal to the engine's own greedy ``generate``
    of its prompt alone (frames are stubbed per request, so a batch of 4
    would draw other frames)."""
    cfg = get_config(ARCH, smoke=True)
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    app = publish_model(ws, cfg, device="cpu")
    n, plen, new = 4, 10, 4
    rep = run_traffic(ws, app, arch=ARCH, workers=1, n_requests=n, rate_hz=100.0,
                      prompt_len=plen, max_new_tokens=new, max_batch=2, seed=3,
                      stream=True, device="cpu", timeout=180)
    s = rep.summary()
    assert rep.completed == n and rep.failed == 0, s
    assert rep.partial_frames == n * new and rep.stream_gaps == 0, s
    assert rep.stream_mismatches == 0, s
    prompts = np.random.default_rng(3).integers(0, 256, (n, plen), dtype=np.int32)
    engine = ServeEngine(cfg, models.init_params(cfg, 0, "cpu"), cache_len=plen + new,
                         device="cpu")
    for rid in range(n):
        want, _ = engine.generate(prompts[rid:rid + 1], new)
        np.testing.assert_array_equal(rep.stream_tokens[rid], want[0])

"""The port's hybrid (zamba2-7b smoke: 4 mamba layers, a shared attention
block before layers 0 and 2, attention at hd 2*d/heads = 32) against the
reference's, on shared weights: the shared block, forward, prefill and
decode with one KV cache per invocation, the KV ring, the one set of
shared symbols behind every invocation, ``generate`` and the slot
scheduler; and both SSM families' symbol manifests at their published
widths. Float32 within 1e-4."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro.models import common as ref_common
from repro.models import hybrid as ref_hy
from repro.serve import Request as RefRequest
from repro.serve import STOP as REF_STOP
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import common, hybrid
from repro_torch.serve import STOP, Request, ServeEngine

ARCH = "zamba2-7b"
F32_TOL = 1e-4             # float32 on both sides; sums in another order
B, S, N_DECODE, CACHE = 2, 11, 6, 24


@functools.lru_cache(maxsize=None)
def _ref_params():
    cfg = ref_config(ARCH, smoke=True)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(cfg, 0).items()}
    rng = np.random.default_rng(7)
    L, H = cfg.num_layers, cfg.ssm_heads
    params["blocks/A_log"] = (rng.standard_normal((L, H)) * 0.5).astype(np.float32)
    params["blocks/dt_bias"] = (rng.standard_normal((L, H)) * 0.5).astype(np.float32)
    return cfg, params


def _shared(params_np=None):
    rcfg, rparams = _ref_params()
    rparams = rparams if params_np is None else params_np
    cfg = get_config(ARCH, smoke=True)
    return cfg, params_from_numpy(rparams, models.param_specs(cfg), "cpu"), rcfg, rparams


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 256, (b, s), dtype=np.int32)


def test_smoke_config_attends_at_twice_d_over_heads():
    cfg = get_config(ARCH, smoke=True)
    assert hybrid._hd(cfg) == 32 != cfg.resolved_head_dim
    assert hybrid.n_invocations(cfg) == 2
    full = get_config(ARCH)
    assert (hybrid._hd(full), hybrid.n_invocations(full)) == (224, 14)
    assert full.resolved_head_dim == 112


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_shared_block_matches_reference(impl):
    cfg, params, rcfg, rparams = _shared()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x0 = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    sin, cos = common.rope_angles(torch.arange(S), hybrid._hd(cfg), cfg.rope_theta)
    got, (k, v) = hybrid._shared_block(cfg, params, torch.from_numpy(x),
                                       torch.from_numpy(x0), sin, cos, impl=impl,
                                       collect_kv=True)
    rsin, rcos = ref_common.rope_angles(jnp.arange(S), ref_hy._hd(rcfg), rcfg.rope_theta)
    want, (rk, rv) = ref_hy._shared_block(
        rcfg, {n: jnp.asarray(a) for n, a in rparams.items()}, jnp.asarray(x),
        jnp.asarray(x0), rsin, rcos, impl="naive", collect_kv=True)
    _close(got, want)
    _close(k, rk)
    _close(v, rv)


@functools.lru_cache(maxsize=None)
def _reference_run():
    rcfg, rparams = _ref_params()
    toks = _tokens(1, B, S)

    def run(p, t):
        logits, aux = ref_models.forward(rcfg, p, {"tokens": t}, impl="naive")
        pre, cache = ref_models.prefill(rcfg, p, {"tokens": t}, impl="naive",
                                        cache_len=CACHE)
        return logits, aux, pre, cache

    logits, aux, pre, cache = jax.jit(run)(rparams, jnp.asarray(toks))
    step = jax.jit(lambda p, c, t: ref_models.decode_step(rcfg, p, c, t))
    ref_cache = {n: np.asarray(v) for n, v in cache.items()}
    tok = jnp.argmax(pre[:, -1], -1).astype(jnp.int32)[:, None]
    out, logits_seq = [np.asarray(tok)], []
    for _ in range(N_DECODE):
        lg, cache = step(rparams, cache, tok)
        logits_seq.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return (toks, np.asarray(logits), float(aux), np.asarray(pre), ref_cache,
            np.concatenate(out, 1), logits_seq)


@pytest.mark.parametrize("impl", ["naive", "chunked", "kernel"])
def test_forward_matches_reference(impl):
    cfg, params, _, _ = _shared()
    toks, want, want_aux, *_ = _reference_run()
    got, aux = models.forward(cfg, params, {"tokens": torch.from_numpy(toks)}, impl=impl)
    _close(got, want)
    assert aux.item() == want_aux == 0.0


def test_prefill_cache_and_greedy_decode_match_reference():
    cfg, params, _, _ = _shared()
    toks, _, _, want_pre, want_cache, want_toks, want_logits = _reference_run()
    pre, cache = models.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                                cache_len=CACHE)
    _close(pre, want_pre)
    assert cache["pos"] == int(want_cache["pos"]) == S - 1
    shapes, _ = ref_models.cache_spec(ref_config(ARCH, smoke=True), B, CACHE)
    for name in ("k", "v", "conv", "ssm"):
        assert tuple(cache[name].shape) == shapes[name].shape, name
        _close(cache[name], want_cache[name])
    assert not cache["k"][:, :, S:].any()          # zero past the prompt
    tok = pre[:, -1].argmax(-1).to(torch.int32)[:, None]
    out = [tok]
    for j in range(N_DECODE):
        lg, cache = models.decode_step(cfg, params, cache, tok)
        _close(lg, want_logits[j])
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), want_toks)


def test_cache_spec_matches_reference_at_published_widths():
    shapes, axes = hybrid.cache_spec(get_config(ARCH), 4, 1056)
    rshapes, raxes = ref_hy.cache_spec(ref_config(ARCH), 4, 1056)
    assert axes == raxes
    for n, s in rshapes.items():
        assert shapes[n] == (s.shape, str(s.dtype)), n
    assert shapes["k"][0] == (14, 4, 1056, 32, 224)


def test_prefill_then_decode_equals_forward_at_each_position():
    cfg, params, _, _ = _shared()
    toks = torch.from_numpy(_tokens(3, B, S + 5))
    full, _ = models.forward(cfg, params, {"tokens": toks}, impl="naive")
    pre, cache = models.prefill(cfg, params, {"tokens": toks[:, :S]}, impl="naive",
                                cache_len=S + 5)
    _close(pre[:, 0], full[:, S - 1])
    for j in range(S, S + 5):
        lg, cache = models.decode_step(cfg, params, cache, toks[:, j:j + 1])
        _close(lg[:, 0], full[:, j])


def test_kv_ring_write_wraps_as_the_reference():
    """A cache of 8 rows after a prompt of 6: decode writes rows 6, 7, then
    wraps to 0 and 1 (pos % S) and attends to every row, as the reference's
    ``dynamic_update_slice`` at ``pos % S`` does."""
    cfg, params, rcfg, rparams = _shared()
    toks = _tokens(4, B, 6)
    feed = _tokens(5, B, 4)
    pre, cache = models.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                                cache_len=8)
    rpre, rcache = ref_models.prefill(rcfg, rparams, {"tokens": jnp.asarray(toks)},
                                      impl="naive", cache_len=8)
    step = jax.jit(lambda p, c, t: ref_models.decode_step(rcfg, p, c, t))
    for j in range(4):
        lg, cache = models.decode_step(cfg, params, cache, torch.from_numpy(feed[:, j:j + 1]))
        rlg, rcache = step(rparams, rcache, jnp.asarray(feed[:, j:j + 1]))
        _close(lg, rlg)
        for name in ("k", "v", "ssm"):
            _close(cache[name], rcache[name])
    assert cache["pos"] == int(rcache["pos"]) == 9


def test_one_shared_tensor_feeds_every_invocation():
    """The shared block is one set of symbols: perturbing ``shared_attn/wk``
    changes the keys of every invocation, as in the reference."""
    cfg, params, rcfg, rparams = _shared()
    toks = _tokens(6, B, S)
    _, base = models.prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
    bumped = dict(rparams)
    bumped["shared_attn/wk"] = rparams["shared_attn/wk"] * 1.5
    cfg, params2, _, _ = _shared(bumped)
    _, got = models.prefill(cfg, params2, {"tokens": torch.from_numpy(toks)})
    _, want = ref_models.prefill(rcfg, bumped, {"tokens": jnp.asarray(toks)}, impl="naive")
    _close(got["k"], want["k"])
    for i in range(hybrid.n_invocations(cfg)):
        assert (got["k"][i] - base["k"][i]).abs().max().item() > 1e-3, i
    assert sum(n.startswith("shared_attn/") for n in models.param_specs(cfg)) == 10


def test_generate_matches_reference_generate():
    cfg, params, rcfg, rparams = _shared()
    prompts = _tokens(2, 3, 10)
    got, _ = ServeEngine(cfg, params, cache_len=24, device="cpu").generate(prompts, 6)
    want, _ = RefServeEngine(rcfg, rparams, cache_len=24, impl="naive").generate(prompts, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_batched_decode_rows_equal_single_row_calls():
    """Per-row positions (RoPE phase, ring slot, mask): each row of the
    batched call equals the B=1 call on that row, across a ring wrap."""
    cfg, params, _, _ = _shared()
    rng = np.random.default_rng(0)
    rows = []
    for n in (4, 9, 14):
        t = torch.from_numpy(rng.integers(0, 256, (1, n), dtype=np.int32))
        rows.append(models.prefill(cfg, params, {"tokens": t}, cache_len=16)[1])
    batch = {n: torch.cat([c[n] for c in rows], 1) for n in ("k", "v", "conv", "ssm")}
    batch["pos"] = tuple(c["pos"] for c in rows)
    toks = torch.from_numpy(rng.integers(0, 256, (3, 1), dtype=np.int32))
    for _ in range(4):                     # the 14-token row wraps at 16
        got, batch = models.decode_step(cfg, params, batch, toks)
        for b, c in enumerate(rows):
            want, rows[b] = models.decode_step(cfg, params, c, toks[b:b + 1])
            assert (got[b] - want[0]).abs().max().item() <= 1e-5
        assert batch["pos"] == tuple(c["pos"] for c in rows)
        toks = got[:, -1].argmax(-1).to(torch.int32)[:, None]


def test_greedy_serve_loop_matches_reference_serve_loop():
    cfg, params, rcfg, rparams = _shared()
    rng = np.random.default_rng(8)
    reqs = [(i, rng.integers(0, 256, (n,), dtype=np.int32), 6)
            for i, n in enumerate([12, 5, 21, 9, 30])]
    feed = iter([Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs] + [STOP])
    got = {}
    rep = ServeEngine(cfg, params, cache_len=40, device="cpu").serve_loop(
        lambda: next(feed, STOP), lambda c: got.setdefault(c.rid, c), max_batch=2)
    rfeed = iter([RefRequest(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs]
                 + [REF_STOP])
    want = {}
    ref_rep = RefServeEngine(rcfg, rparams, cache_len=40, impl="naive").serve_loop(
        lambda: next(rfeed, REF_STOP), lambda c: want.setdefault(c.rid, c), max_batch=2)
    for i, _, _ in reqs:
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert (rep.admitted, rep.steps, rep.tokens_out) == (
        ref_rep.admitted, ref_rep.steps, ref_rep.tokens_out)


def test_serve_loop_refuses_a_prompt_longer_than_the_kv_cache():
    cfg, params, _, _ = _shared()
    feed = iter([Request(rid=0, prompt=_tokens(9, 1, 30)[0], max_new_tokens=2), STOP])
    with pytest.raises(ValueError, match="cache_len"):
        ServeEngine(cfg, params, cache_len=16, device="cpu").serve_loop(
            lambda: next(feed, STOP), lambda c: None)


# ------------------------------------------------ manifests, full size
def _ref_key(refs):
    return [(r.name, tuple(r.shape), r.dtype, r.weak) for r in refs]


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
@pytest.mark.parametrize("fragment", [False, True])
def test_manifest_refs_equal_reference_at_published_widths(arch, fragment):
    """Specs only: no allocation. zamba2-7b's shared block stays one set of
    ten symbols whatever ``fragment`` says (it has no layers axis)."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    got = models.manifest_refs(cfg, fragment=fragment)
    assert _ref_key(got) == _ref_key(ref_models.manifest_refs(rcfg, fragment=fragment))
    assert models.n_params(cfg) == ref_models.n_params(rcfg) == {
        "mamba2-370m": 368_338_432, "zamba2-7b": 7_085_109_456}[arch]
    specs, rspecs = models.param_specs(cfg), ref_models.param_specs(rcfg)
    assert [(n, s.shape, s.dtype, s.axes, s.init) for n, s in specs.items()] == [
        (n, s.shape, s.dtype, s.axes, s.init) for n, s in rspecs.items()]
    shared = [r for r in got if r.name.startswith("shared_attn/")]
    assert len(shared) == (10 if arch == "zamba2-7b" else 0)

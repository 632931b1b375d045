"""The port's mamba2 (mamba2-370m smoke) against the reference's, on shared
weights and numpy inputs from a seed: the SSD core (``_segsum``, ``ssd``
against the reference's ``ssd`` and its sequential oracle ``ssd_ref``),
the causal conv, the blocks, forward, prefill and decode, ``generate``,
and the slot scheduler's ``serve_loop``. Float32 within 1e-4 unless a test
says otherwise."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro.models import mamba2 as ref_m2
from repro.serve import Request as RefRequest
from repro.serve import STOP as REF_STOP
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import mamba2
from repro_torch.serve import STOP, Request, ServeEngine

ARCH = "mamba2-370m"       # smoke: 2 layers, d 64, d_inner 128, H 8, P 16, N 16, chunk 8
F32_TOL = 1e-4             # float32 on both sides; sums in another order
B, S, N_DECODE = 2, 13, 6  # S not a multiple of the chunk


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@functools.lru_cache(maxsize=None)
def _ref_params(groups: int = 1):
    """The reference's smoke params (``ssm_groups`` = groups), with A_log,
    dt_bias, D and the conv bias drawn from a seed instead of their
    constant inits, so that heads and channels differ."""
    cfg = ref_config(ARCH, smoke=True).replace(ssm_groups=groups)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(cfg, 0).items()}
    L, H = cfg.num_layers, cfg.ssm_heads
    params["blocks/A_log"] = _np(11, L, H, scale=0.5)
    params["blocks/dt_bias"] = _np(12, L, H, scale=0.5)
    params["blocks/D"] = _np(13, L, H)
    params["blocks/conv/b"] = _np(14, *params["blocks/conv/b"].shape, scale=0.1)
    return cfg, params


def _shared(groups: int = 1):
    rcfg, rparams = _ref_params(groups)
    cfg = get_config(ARCH, smoke=True).replace(ssm_groups=groups)
    return cfg, params_from_numpy(rparams, models.param_specs(cfg), "cpu"), rcfg, rparams


def _ssd_inputs(s, *, b=2, h=4, p=8, n=6, seed=0):
    x = _np(seed, b, s, h, p)
    a = -np.abs(_np(seed + 1, b, s, h, scale=0.5))      # log decays, negative
    Bm = _np(seed + 2, b, s, h, n)
    Cm = _np(seed + 3, b, s, h, n)
    return x, a, Bm, Cm


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


# ------------------------------------------------------------ SSD core
def test_segsum_matches_reference():
    x = _np(0, 2, 3, 7)
    got = mamba2._segsum(_t(x)).numpy()
    want = np.asarray(ref_m2._segsum(jnp.asarray(x)))
    _close(got, want)
    assert (got[..., 0, 1:] == mamba2.NEG_INF).all()


@pytest.mark.parametrize("s", [16, 13, 5])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_matches_reference_and_sequential_oracle(s, with_state):
    x, a, Bm, Cm = _ssd_inputs(s)
    init = _np(9, 2, 4, 8, 6) if with_state else None
    y, final = mamba2.ssd(_t(x), _t(a), _t(Bm), _t(Cm), chunk=8,
                          initial_state=None if init is None else _t(init))
    assert y.dtype == final.dtype == torch.float32
    ry, rfinal = ref_m2.ssd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(Bm),
                            jnp.asarray(Cm), chunk=8,
                            initial_state=None if init is None else jnp.asarray(init))
    _close(y, ry)
    _close(final, rfinal)
    oy, ofinal = ref_m2.ssd_ref(jnp.asarray(x), jnp.asarray(a), jnp.asarray(Bm),
                                jnp.asarray(Cm),
                                initial_state=None if init is None else jnp.asarray(init))
    _close(y, oy)
    _close(final, ofinal)
    py, pfinal = mamba2.ssd_ref(_t(x), _t(a), _t(Bm), _t(Cm),
                                initial_state=None if init is None else _t(init))
    _close(py, oy)
    _close(pfinal, ofinal)


def test_ssd_bf16_operands_match_reference_bf16():
    """bf16 x, B and C (a stays float32), as a bf16 model feeds them: both
    packages accumulate in float32, and both round g * L, the decays and
    the states to bf16 before their products. The float32 sums agree to
    about 1e-7 relative, so a bf16 rounding of an intermediate lands on
    another value only rarely (none does at this seed: 1e-6 apart). The
    outputs are held within 1e-3 of their largest magnitude, which the
    same inputs without those bf16 roundings miss."""
    x, a, Bm, Cm = _ssd_inputs(20, seed=4)
    bf = torch.bfloat16
    xb, Bb, Cb = _t(x).to(bf), _t(Bm).to(bf), _t(Cm).to(bf)
    y, final = mamba2.ssd(xb, _t(a), Bb, Cb, chunk=8)
    ry, rfinal = ref_m2.ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
                            jnp.asarray(Bm, jnp.bfloat16), jnp.asarray(Cm, jnp.bfloat16),
                            chunk=8)
    assert y.dtype == torch.float32 and ry.dtype == jnp.float32
    ry, rfinal = np.asarray(ry), np.asarray(rfinal)
    tol = 1e-3 * np.abs(ry).max()
    _close(y, ry, tol)
    _close(final, rfinal, 1e-3 * np.abs(rfinal).max())
    unrounded, _ = mamba2.ssd(xb.float(), _t(a), Bb.float(), Cb.float(), chunk=8)
    assert np.abs(unrounded.numpy() - ry).max() > tol


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    xbc, w, b_ = _np(0, 2, 9, 12), _np(1, 4, 12), _np(2, 12)
    state = _np(3, 2, 3, 12) if with_state else None
    out, nxt = mamba2._causal_conv(_t(xbc), _t(w), _t(b_),
                                   None if state is None else _t(state))
    rout, rnxt = ref_m2._causal_conv(jnp.asarray(xbc), jnp.asarray(w), jnp.asarray(b_),
                                     None if state is None else jnp.asarray(state))
    _close(out, rout)
    _close(nxt, rnxt)


def test_split_proj_takes_indices_not_sizes():
    cfg = get_config(ARCH, smoke=True)
    d_inner, H, _, _, _, conv_ch, d_in_proj = mamba2.dims(cfg)
    proj = torch.arange(d_in_proj, dtype=torch.float32)[None, None]
    z, xbc, dt = mamba2._split_proj(cfg, proj)
    assert (z.shape[-1], xbc.shape[-1], dt.shape[-1]) == (d_inner, conv_ch, H)
    assert xbc[0, 0, 0].item() == d_inner and dt[0, 0, 0].item() == d_inner + conv_ch


# -------------------------------------------------------------- blocks
def _block_params(groups):
    cfg, params, rcfg, rparams = _shared(groups)
    p = mamba2.layer(mamba2._stacked(params), 1)
    rp = {n: jnp.asarray(a[1]) for n, a in ref_m2._stacked(rparams).items()}
    return cfg, p, rcfg, rp


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_block_with_states_matches_reference(groups, with_state):
    """G = 2 is the case where ``repeat_interleave`` and ``Tensor.repeat``
    differ (the reference's ``jnp.repeat`` is the former)."""
    cfg, p, rcfg, rp = _block_params(groups)
    d_inner, H, P, G, N, conv_ch, _ = mamba2.dims(cfg)
    x = _np(5, B, S, cfg.d_model)
    state = _np(6, B, H, P, N) if with_state else None
    conv = _np(7, B, cfg.ssm_conv - 1, conv_ch) if with_state else None
    out, final, nconv = mamba2.mamba_block(
        cfg, p, _t(x), state=None if state is None else _t(state),
        conv_state=None if conv is None else _t(conv), return_state=True)
    rout, rfinal, rconv = ref_m2.mamba_block(
        rcfg, rp, jnp.asarray(x), state=None if state is None else jnp.asarray(state),
        conv_state=None if conv is None else jnp.asarray(conv), return_state=True)
    _close(out, rout)
    _close(final, rfinal)
    _close(nconv, rconv)
    assert torch.equal(mamba2.mamba_block(cfg, p, _t(x), state=None if state is None
                                          else _t(state), conv_state=None if conv is None
                                          else _t(conv)), out)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_block_decode_matches_reference(groups):
    cfg, p, rcfg, rp = _block_params(groups)
    d_inner, H, P, G, N, conv_ch, _ = mamba2.dims(cfg)
    x, conv, state = (_np(8, B, 1, cfg.d_model), _np(9, B, cfg.ssm_conv - 1, conv_ch),
                      _np(10, B, H, P, N))
    got = mamba2.mamba_block_decode(cfg, p, _t(x), _t(conv), _t(state))
    want = ref_m2.mamba_block_decode(rcfg, rp, jnp.asarray(x), jnp.asarray(conv),
                                     jnp.asarray(state))
    for g, w in zip(got, want):
        _close(g, w)


def test_groups_repeat_interleaves_not_tiles():
    """At G = 2 a tiling repeat of B and C gives another block output."""
    cfg, p, _, _ = _block_params(2)
    x = _t(_np(5, 1, 6, cfg.d_model))
    want = mamba2.mamba_block(cfg, p, x)
    orig = mamba2._heads

    def tiled(cfg_, xbc, shape):
        d_inner, H, P, G, N, _, _ = mamba2.dims(cfg_)
        xs, Bc, Cc = torch.tensor_split(xbc, [d_inner, d_inner + G * N], dim=-1)
        return (xs.reshape(*shape, H, P),
                Bc.reshape(*shape, G, N).repeat(1, 1, H // G, 1),
                Cc.reshape(*shape, G, N).repeat(1, 1, H // G, 1))

    mamba2._heads = tiled
    try:
        assert (mamba2.mamba_block(cfg, p, x) - want).abs().max().item() > 1e-3
    finally:
        mamba2._heads = orig


# -------------------------------------------------------- whole model
@functools.lru_cache(maxsize=None)
def _reference_run():
    """The reference's forward logits, prefill logits and cache, and greedy
    tokens over N_DECODE steps, on shared params."""
    rcfg, rparams = _ref_params()
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (B, S), dtype=np.int32)

    def run(p, t):
        logits, aux = ref_models.forward(rcfg, p, {"tokens": t})
        pre, cache = ref_models.prefill(rcfg, p, {"tokens": t})
        return logits, aux, pre, cache

    logits, aux, pre, cache = jax.jit(run)(rparams, jnp.asarray(toks))
    step = jax.jit(lambda p, c, t: ref_models.decode_step(rcfg, p, c, t))
    ref_cache = {n: np.asarray(v) for n, v in cache.items()}
    tok = jnp.argmax(pre[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(N_DECODE):
        lg, cache = step(rparams, cache, tok)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return toks, np.asarray(logits), float(aux), np.asarray(pre), ref_cache, \
        np.concatenate(out, 1)


def test_param_specs_equal_reference():
    cfg, rcfg = get_config(ARCH, smoke=True), ref_config(ARCH, smoke=True)
    got, want = models.param_specs(cfg), ref_models.param_specs(rcfg)
    assert list(got) == list(want)
    for n, w in want.items():
        g = got[n]
        assert (g.shape, g.dtype, g.axes, g.init) == (w.shape, w.dtype, w.axes, w.init), n


def test_forward_matches_reference():
    cfg, params, _, _ = _shared()
    toks, want, want_aux, *_ = _reference_run()
    got, aux = models.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
    assert aux.item() == want_aux == 0.0


def test_prefill_cache_and_greedy_decode_match_reference():
    cfg, params, _, _ = _shared()
    toks, _, _, want_pre, want_cache, want_toks = _reference_run()
    pre, cache = models.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                                cache_len=64)          # ignored: no sequence axis
    _close(pre, want_pre)
    assert cache["pos"] == int(want_cache["pos"]) == S - 1
    shapes, _ = ref_models.cache_spec(ref_config(ARCH, smoke=True), B, 64)
    for name in ("conv", "ssm"):
        assert tuple(cache[name].shape) == shapes[name].shape, name
        assert str(cache[name].dtype).removeprefix("torch.") == str(shapes[name].dtype)
        _close(cache[name], want_cache[name])
    tok = pre[:, -1].argmax(-1).to(torch.int32)[:, None]
    out = [tok]
    for _ in range(N_DECODE):
        lg, cache = models.decode_step(cfg, params, cache, tok)
        tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), want_toks)
    assert cache["pos"] == S - 1 + N_DECODE


def test_cache_spec_matches_reference():
    cfg, rcfg = get_config(ARCH), ref_config(ARCH)
    shapes, axes = mamba2.cache_spec(cfg, 4, 1056)
    rshapes, raxes = ref_m2.cache_spec(rcfg, 4, 1056)
    assert axes == raxes
    for n, s in rshapes.items():
        assert shapes[n] == (s.shape, str(s.dtype)), n


def test_prefill_then_decode_equals_forward_at_each_position():
    cfg, params, _, _ = _shared()
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (B, S + 5),
                                                             dtype=np.int32))
    full, _ = models.forward(cfg, params, {"tokens": toks})
    pre, cache = models.prefill(cfg, params, {"tokens": toks[:, :S]})
    _close(pre[:, 0], full[:, S - 1])
    for j in range(S, S + 5):
        lg, cache = models.decode_step(cfg, params, cache, toks[:, j:j + 1])
        _close(lg[:, 0], full[:, j])


def test_generate_matches_reference_generate():
    cfg, params, rcfg, rparams = _shared()
    prompts = np.random.default_rng(2).integers(0, 256, (3, 10), dtype=np.int32)
    got, _ = ServeEngine(cfg, params, device="cpu").generate(prompts, 6)
    want, _ = RefServeEngine(rcfg, rparams).generate(prompts, 6)
    np.testing.assert_array_equal(got, np.asarray(want))


# ----------------------------------------------------------- serving
def test_batched_decode_rows_equal_single_row_calls():
    cfg, params, _, _ = _shared()
    rng = np.random.default_rng(0)
    rows = []
    for n in (3, 9, 14):
        t = torch.from_numpy(rng.integers(0, 256, (1, n), dtype=np.int32))
        rows.append(models.prefill(cfg, params, {"tokens": t})[1])
    batch = {"conv": torch.cat([c["conv"] for c in rows], 1),
             "ssm": torch.cat([c["ssm"] for c in rows], 1),
             "pos": tuple(c["pos"] for c in rows)}
    toks = torch.from_numpy(rng.integers(0, 256, (3, 1), dtype=np.int32))
    for _ in range(3):
        got, batch = models.decode_step(cfg, params, batch, toks)
        for b, c in enumerate(rows):
            want, rows[b] = models.decode_step(cfg, params, c, toks[b:b + 1])
            assert (got[b] - want[0]).abs().max().item() <= 1e-5
        assert batch["pos"] == tuple(c["pos"] for c in rows)
        toks = got[:, -1].argmax(-1).to(torch.int32)[:, None]


@pytest.mark.parametrize("cache_len", [0, 40])
def test_greedy_serve_loop_matches_reference_serve_loop(cache_len):
    """Mixed prompt lengths through 2 slots; an SSM engine needs no
    ``cache_len`` (the reference's rule), and one is ignored."""
    cfg, params, rcfg, rparams = _shared()
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, 256, (n,), dtype=np.int32), 6)
            for i, n in enumerate([12, 5, 21, 9, 30])]
    feed = iter([Request(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs] + [STOP])
    got = {}
    rep = ServeEngine(cfg, params, cache_len=cache_len, device="cpu").serve_loop(
        lambda: next(feed, STOP), lambda c: got.setdefault(c.rid, c), max_batch=2)
    rfeed = iter([RefRequest(rid=i, prompt=p, max_new_tokens=n) for i, p, n in reqs]
                 + [REF_STOP])
    want = {}
    ref_rep = RefServeEngine(rcfg, rparams, cache_len=cache_len).serve_loop(
        lambda: next(rfeed, REF_STOP), lambda c: want.setdefault(c.rid, c), max_batch=2)
    for i, _, _ in reqs:
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert (rep.admitted, rep.steps, rep.tokens_out) == (
        ref_rep.admitted, ref_rep.steps, ref_rep.tokens_out)


def test_slot_state_holds_conv_and_ssm_rows_per_slot():
    cfg, params, _, _ = _shared()
    from repro_torch.serve.scheduler import SlotScheduler

    eng = ServeEngine(cfg, params, device="cpu")
    sched = SlotScheduler(eng, max_batch=3)
    prompt = np.random.default_rng(6).integers(0, 256, (7,), dtype=np.int32)
    idx = sched.admit(Request(rid=0, prompt=prompt, max_new_tokens=4), 0.0)
    cache = sched._state[0]
    assert set(k for k, v in cache.items() if isinstance(v, torch.Tensor)) == {"conv", "ssm"}
    _, row = models.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)[None]})
    assert cache["ssm"].shape[1] == 3 and cache["ssm"].dtype == torch.float32
    assert torch.equal(cache["conv"][:, idx], row["conv"][:, 0])
    assert torch.equal(cache["ssm"][:, idx], row["ssm"][:, 0])
    assert not cache["ssm"][:, 1:].any() and cache["pos"] == (6, 0, 0)

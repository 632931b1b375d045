"""The port's MoE family against the reference's, on shared weights: the
``moe_block`` and ``shared_expert`` layers on numpy inputs (float32, forced
ties, dropped tokens, the aux loss), olmoe and qwen2-moe smoke end to end
(forward, prefill, greedy decode, batched decode rows, ``serve_loop``, an
epoch flip, a traffic drive), and the routing checks that ``chip_smoke.py``
runs at olmoe's published widths, shown to catch known faults."""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.configs import get_config as ref_config
from repro.models import moe as ref_moe
from repro.serve import Request as RefRequest
from repro.serve import STOP as REF_STOP
from repro.serve import ServeEngine as RefServeEngine
from repro_torch import models
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import EpochCache
from repro_torch.launch.serve import publish_model
from repro_torch.link import Workspace
from repro_torch.models import moe
from repro_torch.serve import STOP, Request, ServeEngine, run_traffic

MOE = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
B, S, N_DECODE = 2, 24, 8
F32_TOL = 1e-4                # f32 both sides; sums in another order


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ------------------------------------------------------------ top-k order
def test_top_k_takes_the_lower_index_first_among_ties():
    """The finding behind the stable sort: ``jax.lax.top_k`` gives experts
    [1, 2] on this vector, ``torch.topk`` [2, 4]."""
    p = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.05]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(p), 2)
    got_v, got_i = moe.top_k(_t(p), 2)
    assert got_i.tolist() == np.asarray(want_i).tolist() == [[1, 2]]
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # a tie-heavy matrix: small integers, many equal values in every row
    q = np.random.default_rng(0).integers(0, 4, (64, 16)).astype(np.float32)
    np.testing.assert_array_equal(moe.top_k(_t(q), 5)[1].numpy(),
                                  np.asarray(jax.lax.top_k(jnp.asarray(q), 5)[1]))


# ------------------------------------------------------ the layer itself
E, K, D, FF = 8, 3, 16, 24


def _layer_inputs(case: str, seed: int = 0):
    """(x, router_w, w_gate, w_up, w_down, capacity_factor) as numpy f32.
    ``ties``: x and the router in small integers with duplicated router
    columns, so router logits tie exactly in both packages; ``drop``: a
    capacity factor of 0.5, so experts overflow and tokens are dropped."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 12, D)).astype(np.float32)
    router = rng.standard_normal((D, E)).astype(np.float32) * D**-0.5
    if case == "ties":
        x = rng.integers(-2, 3, (B, 12, D)).astype(np.float32)
        router = rng.integers(-1, 2, (D, E)).astype(np.float32)
        router[:, 4:] = router[:, :4]                 # experts e and e+4 tie
    w = [rng.standard_normal(s).astype(np.float32) * s[1]**-0.5
         for s in ((E, D, FF), (E, D, FF), (E, FF, D))]
    return (x, router, *w, 0.5 if case == "drop" else 1.25)


def _ref_keep(x, router, k, cf):
    """The reference's kept-slot mask (``repro/models/moe.py:35-47``),
    recomputed in JAX: top-k, capacity per row, cumsum positions."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    b, s, e = probs.shape
    cap = min(max(1, int(np.ceil(k * s / e * cf))), s * k)
    oh = jax.nn.one_hot(top_e.reshape(b, s * k), e, dtype=jnp.int32)
    pos = (jnp.cumsum(oh, axis=1) * oh).sum(-1) - 1
    return np.asarray(top_e), np.asarray(pos < cap)


@pytest.mark.parametrize("case", ["f32", "ties", "drop"])
def test_moe_block_matches_reference(case):
    x, router, wg, wu, wd, cf = _layer_inputs(case)
    want, want_aux = ref_moe.moe_block(*map(jnp.asarray, (x, router, wg, wu, wd)),
                                       k=K, capacity_factor=cf)
    got, aux = moe.moe_block(*map(_t, (x, router, wg, wu, wd)), k=K, capacity_factor=cf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)
    assert abs(aux.item() - float(want_aux)) <= F32_TOL
    r = moe.route(_t(x), _t(router), k=K, capacity_factor=cf)
    want_e, want_keep = _ref_keep(x, router, K, cf)
    np.testing.assert_array_equal(r.top_e.numpy(), want_e)
    np.testing.assert_array_equal(r.keep.numpy(), want_keep)
    if case == "ties":                # the case really ties inside the top k
        p = r.probs.numpy()
        top = np.take_along_axis(p, want_e, -1)
        assert (np.diff(top, axis=-1) == 0).any()
    if case == "drop":                # ... and really drops tokens
        assert not want_keep.all()
        dropped = ~want_keep.reshape(B, 12, K).any(-1)
        assert dropped.any() and np.abs(got.numpy()[dropped]).max() == 0.0


def test_moe_block_rows_do_not_depend_on_their_neighbours():
    """Capacity is per batch row: each row of a batched call equals its
    B=1 call, also when the rows overflow their experts."""
    x, router, wg, wu, wd, cf = _layer_inputs("drop", seed=3)
    w = [_t(a) for a in (router, wg, wu, wd)]
    got, _ = moe.moe_block(_t(x), *w, k=K, capacity_factor=cf)
    for b in range(B):
        row, _ = moe.moe_block(_t(x[b:b + 1]), *w, k=K, capacity_factor=cf)
        torch.testing.assert_close(got[b:b + 1], row, atol=1e-6, rtol=0)


def test_shared_expert_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 12, D)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) * s[0]**-0.5
         for s in ((D, 2 * FF), (D, 2 * FF), (2 * FF, D), (D, 1))]
    want = ref_moe.shared_expert(*map(jnp.asarray, [x] + w))
    got = moe.shared_expert(*map(_t, [x] + w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHS.items()
                                         if c.family not in ("ssm", "hybrid")))
def test_n_active_params_equals_reference(arch):
    assert models.n_active_params(get_config(arch)) == ref_models.n_active_params(
        ref_config(arch))


# ----------------------------------------------------- the smoke models
@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """The reference's params, forward logits and aux, prefill logits and
    cache, and greedy tokens over N_DECODE steps, for ``arch`` smoke."""
    cfg = ref_config(arch, smoke=True)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(cfg, 0).items()}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks)}

    def run(p, b):
        logits, aux = ref_models.forward(cfg, p, b)
        pre, cache = ref_models.prefill(cfg, p, b, cache_len=S + N_DECODE)
        return logits, aux, pre, cache

    logits, aux, pre, cache = jax.jit(run)(params, batch)
    step = jax.jit(lambda p, c, t: ref_models.decode_step(cfg, p, c, t))
    tok = jnp.argmax(pre[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(N_DECODE):
        lg, cache = step(params, cache, tok)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return (params, toks, np.asarray(logits), float(aux), np.asarray(pre),
            np.concatenate(out, 1))


def _port(arch):
    cfg = get_config(arch, smoke=True)
    params_np, toks, *_ = _reference(arch)
    return cfg, params_from_numpy(params_np, models.param_specs(cfg), "cpu"), toks


@pytest.mark.parametrize("arch", MOE)
def test_forward_logits_and_aux_match_reference(arch):
    cfg, params, toks = _port(arch)
    _, _, want, want_aux, _, _ = _reference(arch)
    with torch.inference_mode():
        got, aux = models.forward(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    assert want_aux > 0 and abs(aux.item() - want_aux) <= F32_TOL


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_greedy_decode_match_reference(arch):
    cfg, params, toks = _port(arch)
    *_, want_pre, want_toks = _reference(arch)
    with torch.inference_mode():
        pre, cache = models.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                                    cache_len=S + N_DECODE)
        np.testing.assert_allclose(pre.numpy(), want_pre, atol=F32_TOL, rtol=0)
        tok = pre[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(N_DECODE):
            lg, cache = models.decode_step(cfg, params, cache, tok)
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), want_toks)


@pytest.mark.parametrize("arch", MOE)
def test_batched_moe_decode_rows_equal_single_row_calls(arch):
    """decode_step with per-row positions on an MoE model: each row of the
    batched call is the B=1 call on that row (capacity is per row)."""
    cfg, params, _ = _port(arch)
    rng = np.random.default_rng(0)
    lens = [5, 16, 11, 23]
    rows = []
    with torch.inference_mode():
        for n in lens:
            t = torch.from_numpy(rng.integers(0, 256, (1, n), dtype=np.int32))
            rows.append(models.prefill(cfg, params, {"tokens": t}, cache_len=28)[1])
        batch = {"k": torch.cat([c["k"] for c in rows], 1),
                 "v": torch.cat([c["v"] for c in rows], 1),
                 "pos": tuple(c["pos"] for c in rows)}
        toks = torch.from_numpy(rng.integers(0, 256, (len(lens), 1), dtype=np.int32))
        for _ in range(3):
            got, batch = models.decode_step(cfg, params, batch, toks)
            for b, c in enumerate(rows):
                want, rows[b] = models.decode_step(cfg, params, c, toks[b:b + 1])
                assert (got[b] - want[0]).abs().max().item() <= 1e-5
                assert int(got[b].argmax()) == int(want[0].argmax())
            toks = got[:, -1].argmax(-1).to(torch.int32)[:, None]


def _shared(arch):
    rcfg = ref_config(arch, smoke=True)
    rparams = ref_models.init_params(rcfg, 0)
    cfg = get_config(arch, smoke=True)
    params = params_from_numpy({n: np.asarray(v) for n, v in rparams.items()},
                               models.param_specs(cfg), "cpu")
    return cfg, params, rcfg, rparams


@pytest.mark.parametrize("arch", MOE)
def test_greedy_serve_loop_matches_reference_serve_loop(arch):
    """Mixed prompt lengths through both ``serve_loop``s, 2 slots."""
    cfg, params, rcfg, rparams = _shared(arch)
    rng = np.random.default_rng(4)
    reqs = [(i, rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32))
            for i, n in enumerate([12, 16, 21, 12, 30])]
    port = ServeEngine(cfg, params, cache_len=40, device="cpu")
    feed = iter([Request(rid=i, prompt=p, max_new_tokens=7) for i, p in reqs] + [STOP])
    got = {}
    rep = port.serve_loop(lambda: next(feed, STOP),
                          lambda c: got.setdefault(c.rid, c), max_batch=2)
    ref = RefServeEngine(rcfg, rparams, cache_len=40, impl="naive")
    feed = iter([RefRequest(rid=i, prompt=p, max_new_tokens=7) for i, p in reqs]
                + [REF_STOP])
    want = {}
    ref_rep = ref.serve_loop(lambda: next(feed, REF_STOP),
                             lambda c: want.setdefault(c.rid, c), max_batch=2)
    for i, _ in reqs:
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
    assert (rep.admitted, rep.steps, rep.tokens_out) == (
        ref_rep.admitted, ref_rep.steps, ref_rep.tokens_out)


def test_adopt_epoch_flips_an_moe_engine_to_the_new_weights(tmp_path):
    """olmoe smoke served from a Workspace, flipped to a v2 commit: after
    the flip its tokens are those of an engine built on v2 directly."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    app = publish_model(ws, cfg, device="cpu")
    engine = ServeEngine.from_workspace(cfg, ws, app, cache_len=24, device="cpu")
    prompts = np.random.default_rng(2).integers(0, 256, (2, 16), dtype=np.int32)
    before, _ = engine.generate(prompts, 6)
    v2 = models.init_params(cfg, 1, "cpu")
    bundle, payload = bundle_from_params(f"weights:{cfg.name}", "v2", v2,
                                         specs=models.param_specs(cfg))
    with ws.management() as tx:
        tx.publish(bundle, payload)
    engine.adopt_epoch(ws, app, deadline_s=30.0)
    got, _ = engine.generate(prompts, 6)
    want, _ = ServeEngine(cfg, v2, cache_len=24, device="cpu").generate(prompts, 6)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, before)


def test_traffic_drive_serves_olmoe(tmp_path):
    """One spawned worker serves olmoe smoke over the shm rings: 4 streamed
    requests, each equal to the engine's own greedy ``generate`` of the
    same prompts (the serve_loop's parity with the reference is tested
    above)."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    app = publish_model(ws, cfg, device="cpu")
    n, plen, new = 4, 14, 4
    rep = run_traffic(ws, app, arch="olmoe-1b-7b", workers=1, n_requests=n,
                      rate_hz=100.0, prompt_len=plen, max_new_tokens=new, max_batch=2,
                      seed=3, stream=True, device="cpu", timeout=180)
    s = rep.summary()
    assert rep.completed == n and rep.failed == 0, s
    assert rep.partial_frames == n * new and rep.stream_gaps == 0, s
    assert rep.stream_mismatches == 0, s
    prompts = np.random.default_rng(3).integers(0, 256, (n, plen), dtype=np.int32)
    want, _ = ServeEngine(cfg, models.init_params(cfg, 0, "cpu"), cache_len=plen + new,
                          device="cpu").generate(prompts, new)
    for rid in range(n):
        np.testing.assert_array_equal(rep.stream_tokens[rid], want[rid])


# --------------------------------- chip_smoke.py's MoE checks, on the CPU
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _faulty_capacity_over_batch(monkeypatch):
    """Capacity counted over B*S tokens with slots numbered across rows:
    the usual pooled-token idiom the port must not use."""
    def pooled(e_flat, n_experts):
        b, n = e_flat.shape
        return orig_pos(e_flat.reshape(1, b * n), n_experts).reshape(b, n)
    orig_pos = moe.slot_positions
    monkeypatch.setattr(moe, "slot_positions", pooled)
    orig_cap = moe.capacity
    monkeypatch.setattr(moe, "capacity", lambda s, *a: orig_cap(s * B, *a))


FAULTS = {
    "none": lambda mp: None,
    "unstable top-k": lambda mp: mp.setattr(
        moe, "top_k", lambda p, k: torch.topk(p, k, dim=-1)),
    "capacity over B*S": _faulty_capacity_over_batch,
    "slot index off by one": lambda mp: mp.setattr(
        moe, "slot_positions",
        (lambda orig: lambda e, n: orig(e, n) + (e % 2))(moe.slot_positions)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_chip_smoke_moe_checks_catch_known_faults(fault, monkeypatch):
    """``chip_smoke.moe_layer_check`` holds each MoE layer of a bf16 run
    against an independent host routing and a per-expert float32 FFN. At
    smoke size, with bf16 router logits full of ties and experts that
    overflow, it passes on the port's ``moe_block`` and fails on each known
    fault injected into it."""
    cs = _chip_smoke()
    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    x = torch.from_numpy(rng.integers(-2, 3, (B, 64, D)).astype(np.float32)).to(bf)
    router = rng.integers(-1, 2, (D, E)).astype(np.float32)
    router[:, 4:] = router[:, :4]
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * s[1]**-0.5).to(bf)
         for s in ((E, D, FF), (E, D, FF), (E, FF, D))]
    args = (x, torch.from_numpy(router).to(bf), *w)
    FAULTS[fault](monkeypatch)
    with torch.inference_mode():
        out, _ = moe.moe_block(*args, k=K, capacity_factor=1.0)
        res = cs.moe_layer_check(args, {"k": K, "capacity_factor": 1.0}, out)
    assert res["tied_tokens"] > 0 and res["dropped_slots"] > 0
    bad = res["routing_mismatches"] + res["keep_mismatches"] + res["pos_mismatches"]
    if fault == "none":
        assert bad == 0 and res["out_err"] <= res["out_tol"], res
    else:
        assert bad > 0 and res["out_err"] > res["out_tol"], res

"""The port's dense transformer against the reference's, on shared
weights: the reference's ``init_params`` (numpy) carried over with
``repro_torch.convert.params_from_numpy``."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as ref_models
from repro.ckpt import bundle_from_params as ref_bundle_from_params
from repro.configs import get_config as ref_config
from repro.models import common as ref_common
from repro_torch import models
from repro_torch.ckpt import bundle_from_params
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import common

DENSE = ["deepseek-67b", "qwen1.5-110b", "gemma3-1b", "starcoder2-3b",
         "chameleon-34b"]
IMPLS = ["naive", "chunked", "kernel"]
B, S, N_DECODE = 2, 24, 8     # S > gemma3 smoke's window of 16
F32_TOL = 1e-4                # f32 both sides; sums in another order


def _ref_key(ref):
    return [(r.name, tuple(r.shape), r.dtype, r.weak) for r in ref]


@functools.lru_cache(maxsize=None)
def _reference(arch: str, dtype: str = "float32"):
    """The reference's params, logits, prefill and greedy tokens for arch."""
    cfg = ref_config(arch, smoke=True).replace(dtype=dtype)
    params = {n: np.asarray(v) for n, v in ref_models.init_params(cfg, 0).items()}
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    batch = {"tokens": jnp.asarray(toks)}

    def fwd_and_prefill(p, b):   # one compile for both programs
        logits, _ = ref_models.forward(cfg, p, b)
        if dtype != "float32":
            return logits, None, None
        pre, cache = ref_models.prefill(cfg, p, b, cache_len=S + N_DECODE)
        return logits, pre, cache

    logits, pre, cache = jax.jit(fwd_and_prefill)(params, batch)
    if dtype != "float32":
        return params, toks, np.asarray(logits, np.float32), None, None
    step = jax.jit(lambda p, c, t: ref_models.decode_step(cfg, p, c, t))
    tok = jnp.argmax(pre[:, -1], -1).astype(jnp.int32)[:, None]
    out = [np.asarray(tok)]
    for _ in range(N_DECODE):
        lg, cache = step(params, cache, tok)
        tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok))
    return params, toks, np.asarray(logits), np.asarray(pre), np.concatenate(out, 1)


def _port(arch: str, dtype: str = "float32"):
    cfg = get_config(arch, smoke=True).replace(dtype=dtype)
    params_np, toks, *_ = _reference(arch, dtype)
    return cfg, params_from_numpy(params_np, models.param_specs(cfg), "cpu"), toks


@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_and_manifest_equal_reference(arch):
    cfg, rcfg = get_config(arch, smoke=True), ref_config(arch, smoke=True)
    got, want = models.param_specs(cfg), ref_models.param_specs(rcfg)
    assert list(got) == list(want)
    for n in want:
        g, w = got[n], want[n]
        assert (g.shape, g.dtype, g.axes, g.init) == (w.shape, w.dtype, w.axes, w.init), n
    for frag in (False, True):
        assert _ref_key(models.manifest_refs(cfg, fragment=frag)) == _ref_key(
            ref_models.manifest_refs(rcfg, fragment=frag))
    assert models.n_params(cfg) == ref_models.n_params(rcfg)
    # and at published size, where the port serves
    full, rfull = get_config(arch), ref_config(arch)
    assert _ref_key(models.manifest_refs(full)) == _ref_key(ref_models.manifest_refs(rfull))


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(arch, impl):
    cfg, params, toks = _port(arch)
    _, _, want, _, _ = _reference(arch)
    with torch.inference_mode():
        logits, aux = models.forward(cfg, params, {"tokens": torch.from_numpy(toks)}, impl=impl)
    assert logits.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), want, atol=F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_greedy_decode_match_reference(arch):
    cfg, params, toks = _port(arch)
    _, _, _, want_pre, want_tokens = _reference(arch)
    with torch.inference_mode():
        pre, cache = models.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                                    cache_len=S + N_DECODE)
        assert cache["k"].shape == (cfg.num_layers, B, S + N_DECODE,
                                    cfg.num_kv_heads, cfg.resolved_head_dim)
        assert cache["pos"] == S - 1
        np.testing.assert_allclose(pre.numpy(), want_pre, atol=F32_TOL)
        tok = pre[:, -1].argmax(-1).to(torch.int32)[:, None]
        out = [tok]
        for _ in range(N_DECODE):
            lg, cache = models.decode_step(cfg, params, cache, tok)
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            out.append(tok)
    assert cache["pos"] == S - 1 + N_DECODE
    np.testing.assert_array_equal(torch.cat(out, 1).numpy(), want_tokens)


@pytest.mark.parametrize("impl", IMPLS)
def test_gemma3_bf16_forward_matches_reference(impl):
    cfg, params, toks = _port("gemma3-1b", "bfloat16")
    assert params["embed/tokens"].dtype == torch.bfloat16
    _, _, want, _, _ = _reference("gemma3-1b", "bfloat16")
    with torch.inference_mode():
        logits, _ = models.forward(cfg, params, {"tokens": torch.from_numpy(toks)}, impl=impl)
    # bf16 weights and activations: the two frameworks round intermediate
    # products to bf16 at different places (XLA fuses, torch rounds each
    # op), so logits of magnitude ~0.7 agree to a few bf16 ulps
    np.testing.assert_allclose(logits.float().numpy(), want, atol=5e-2)


def test_port_bundle_equals_reference_bundle_bf16():
    """Same bf16 values -> the same symbol table, payload and content hash,
    whether the port gets torch tensors or the reference's numpy arrays."""
    params_np, *_ = _reference("gemma3-1b", "bfloat16")
    cfg = get_config("gemma3-1b", smoke=True).replace(dtype="bfloat16")
    specs = models.param_specs(cfg)
    want, want_payload = ref_bundle_from_params("w", "1", params_np)
    tensors = params_from_numpy(params_np, specs, "cpu")
    for src in (tensors, params_np):
        got, payload = bundle_from_params("w", "1", src, specs=specs)
        assert payload == want_payload
        assert got.content_hash == want.content_hash
        assert [(s.name, s.shape, s.dtype, s.offset, s.nbytes) for s in got.symbols.values()] == [
            (s.name, s.shape, s.dtype, s.offset, s.nbytes) for s in want.symbols.values()]


# ----------------------------------------------- common layers, one by one
def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _attn_inputs():
    return _np(1, 2, 12, 4, 16), _np(2, 2, 12, 2, 16), _np(3, 2, 12, 2, 16)


_COMMON = {
    "rms_norm": (lambda m, t: m.rms_norm(t(_np(4, 3, 5, 32)), t(_np(5, 32)))),
    "layer_norm": (lambda m, t: m.layer_norm(t(_np(4, 3, 32)), t(_np(5, 32)), t(_np(6, 32)))),
    "apply_rope": (lambda m, t: m.apply_rope(
        t(_np(7, 2, 9, 4, 16)),
        *m.rope_angles(t(np.arange(9, dtype=np.int32)), 16, 10_000.0))),
    "repeat_kv": (lambda m, t: m.repeat_kv(t(_np(8, 2, 5, 2, 16)), 3)),
    "naive_attention": (lambda m, t: m.naive_attention(
        *map(t, _attn_inputs()), causal=True, window=5)),
    "chunked_attention": (lambda m, t: m.chunked_attention(
        *map(t, _attn_inputs()), causal=True, window=0, chunk=5)),
    "decode_attention": (lambda m, t: m.decode_attention(
        t(_np(9, 2, 1, 4, 16)), t(_np(10, 2, 12, 2, 16)), t(_np(11, 2, 12, 2, 16)), 7)),
    "mlp_silu": (lambda m, t: m.mlp(t(_np(12, 3, 8)), t(_np(13, 8, 16)), t(_np(14, 8, 16)),
                                    t(_np(15, 16, 8)))),
    "mlp_gelu_bias": (lambda m, t: m.mlp(t(_np(12, 3, 8)), None, t(_np(14, 8, 16)),
                                         t(_np(15, 16, 8)), act="gelu",
                                         b_up=t(_np(16, 16)), b_down=t(_np(17, 8)))),
    "cross_entropy": (lambda m, t: m.cross_entropy(
        t(_np(18, 2, 5, 11)), t(np.arange(10, dtype=np.int32).reshape(2, 5) % 11))),
}


@functools.lru_cache(maxsize=None)
def _common_reference():
    """Every reference layer's output, from one compiled program."""
    outs = jax.jit(lambda: {k: f(ref_common, jnp.asarray) for k, f in _COMMON.items()})()
    return {k: np.asarray(v) for k, v in outs.items()}


@pytest.mark.parametrize("fn", sorted(_COMMON))
def test_common_layer_matches_reference(fn):
    want = _common_reference()[fn]
    got = _COMMON[fn](common, torch.from_numpy).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)

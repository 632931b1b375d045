"""The bounds that ``chip_smoke.py`` writes beside its measurements,
computed here from the configs' specs alone (no card, no allocation):
each decode step's bytes for every served family, and the input rotation
that keeps a timed kernel's inputs out of L2."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.models.transformer import _layer_windows

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mamba2_decode_step_bound(smoke):
    """mamba2-370m at B = 4: the weights with the tied output layer (bf16,
    A_log, dt_bias and D in float32), 4 embedding rows, and the conv and
    SSM states read and written; no KV cache. 1.14 GB, 0.342 ms."""
    cfg = get_config("mamba2-370m")
    L, H, d_inner = 48, 32, 2048
    weights = (368_338_432 - 3 * L * H) * 2 + 3 * L * H * 4
    ssm = L * 4 * H * 64 * 128 * 4
    conv = L * 4 * 3 * (d_inner + 2 * 128) * 2
    want = weights + 4 * 1024 * 2 + 2 * (ssm + conv)
    for rows in (1040, 1056):                 # no sequence axis: rows unused
        assert smoke.decode_bytes(cfg, rows) == want
    assert round(want / 1e9, 2) == 1.14
    assert abs(want / smoke.HBM_BYTES_PER_S * 1e3 - 0.342) < 1e-3


def test_zamba2_decode_step_bound(smoke):
    """zamba2-7b at B = 4 over 1,056 cache rows: the mamba layers and the
    untied head (12.86 GB), the shared block read once per invocation (14
    x 1.08 GB = 15.1 GB), the SSM and conv states read and written (1.19
    GB + 28 MB), and 14 KV caches at hd 224, not 81 layers at the config's
    head_dim of 112 (1.70 GB): 30.88 GB, 9.22 ms (the parts rounded as
    above sum to 30.85)."""
    cfg = get_config("zamba2-7b")
    L, I, H, d, d2 = 81, 14, 112, 3584, 7168
    shared = 4 * d2 * d2 + 3 * d2 * 14336 + d2 * d + 2 * d2
    f32 = 3 * L * H
    mamba_and_head = 7_085_109_456 - 32000 * d - shared
    weights = (mamba_and_head - f32) * 2 + f32 * 4
    state = 2 * (L * 4 * H * 64 * 64 * 4 + L * 4 * 3 * (2 * d + 2 * 64) * 2)
    kv = I * 4 * 32 * 224 * 2 * 2 * 1056
    want = weights + I * shared * 2 + 4 * d * 2 + state + kv
    assert smoke.decode_bytes(cfg, 1056) == want
    assert round(weights / 1e9, 2) == 12.86 and round(I * shared * 2 / 1e9, 1) == 15.1
    assert round(kv / 1e9, 2) == 1.70 and abs(want / 1e9 - 30.85) < 0.05
    assert abs(want / smoke.HBM_BYTES_PER_S * 1e3 - 9.218) < 1e-3
    assert cfg.resolved_head_dim == 112       # not the head_dim attention runs at


@pytest.mark.parametrize("arch,gb", [("gemma3-1b", 2.11), ("olmoe-1b-7b", 14.18),
                                     ("seamless-m4t-large-v2", 2.55)])
def test_transformer_decode_step_bounds_keep_their_values(smoke, arch, gb):
    """The families served before: weights, embedding rows and KV caches
    over the mean of 1,040 visible rows, as PERF.md records them."""
    assert round(smoke.decode_bytes(get_config(arch), 1040) / 1e9, 2) == gb


@pytest.mark.parametrize("set_bytes", [8 * 1024, 16_777_216, 58_720_256, 176_160_768])
def test_input_sets_total_more_than_twice_the_l2(smoke, set_bytes):
    made = []

    def make(n):
        made.append(n)
        return (np.zeros((n, 2)), np.ones((n, 3)))

    sets = smoke.input_sets(make, set_bytes)
    assert len(sets) == made[0] and len(sets) * set_bytes > 2 * smoke.L2_BYTES
    assert (len(sets) - 1) * set_bytes <= 2 * smoke.L2_BYTES
    assert all(len(s) == 2 and s[0].shape == (2,) for s in sets)
    calls = []
    call = smoke.rotating(lambda a, b: calls.append(id(a)), sets)
    for _ in range(2 * len(sets)):
        call()
    assert calls[:len(sets)] == calls[len(sets):]
    assert len(set(calls[:len(sets)])) == len(sets) or len(sets) == 1


def test_rms_mix_counts_every_launch_of_the_ssm_paths(smoke):
    """Phase 9 and 10's rmsnorm launches a prefill and a step: 97 and 191."""
    for arch, per in (("mamba2-370m", 97), ("zamba2-7b", 191)):
        mix = smoke.rms_mix(get_config(arch))
        assert sum(mix.values()) == per * smoke.NEW
        prefill = {s: n for s, n in mix.items() if s[0] == smoke.BATCH * smoke.PROMPT}
        assert sum(prefill.values()) == per - 1      # the final norm is on B rows


def test_gemma3_training_step_model_flops(smoke):
    """Phase 11's model flops a step (gemma3-1b, 2 x 4096 tokens): 6 x
    999,826,048 parameters x 8,192 tokens, plus attention at hd 256 with 4
    heads, x 3 for forward and backward, over 4 global layers (4096 x 4097
    / 2 visible pairs a sequence) and 22 windowed ones (window 512:
    512 x 513 / 2 + 3584 x 512 pairs)."""
    cfg = get_config("gemma3-1b")
    assert _layer_windows(cfg).count(0) == 4
    pairs = 4 * (4096 * 4097 // 2) + 22 * (512 * 513 // 2 + 3584 * 512)
    want = 6.0 * 999_826_048 * 8192 + 3 * 4.0 * 256 * 4 * 2 * pairs
    assert smoke.train_model_flops(cfg, 2, 4096) == want
    assert round(want / 1e13, 3) == 5.103


def test_attention_pairs_of_a_window(smoke):
    brute = lambda s, w: sum(min(q + 1, w) if w else q + 1 for q in range(s))
    for s, w in ((16, 0), (16, 4), (16, 16), (16, 40), (4096, 512)):
        assert smoke.attention_pairs(s, w) == brute(s, w)


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b", "seamless-m4t-large-v2",
                                  "mamba2-370m", "zamba2-7b"])
def test_decode_attention_launches_a_step_are_one_an_attention_layer(smoke, arch,
                                                                     monkeypatch):
    """The decode_attention launches ``chip_smoke.py`` expects a decode
    step: a decode step of each family's smoke config calls
    ``decode_attention`` once for each attention layer (twice for an
    encoder-decoder's: self and cross; once per shared-block invocation
    for the hybrid; never for the SSM), and the script's constants are
    that count at the depths its phases serve."""
    import torch

    from repro_torch import models
    from repro_torch.models import hybrid, transformer
    from repro_torch.serve.scheduler import stub_frames

    calls = []
    for mod in (transformer, hybrid):
        real = mod.decode_attention
        monkeypatch.setattr(mod, "decode_attention",
                            lambda *a, _real=real: calls.append(1) or _real(*a))
    cfg = get_config(arch, smoke=True)
    params = models.init_params(cfg, 0, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    batch = {"tokens": torch.as_tensor(toks)}
    if cfg.is_encdec:
        batch["frames"] = stub_frames(cfg, 2, 12, "cpu")
    with torch.inference_mode():
        logits, cache = models.prefill(cfg, params, batch, cache_len=16)
        assert not calls
        models.decode_step(cfg, params, cache, logits[:, -1:].argmax(-1).to(torch.int32))

    def per_step(c):
        if c.family == "ssm":
            return 0
        if c.family == "hybrid":
            return hybrid.n_invocations(c)
        return c.num_layers * (2 if c.is_encdec else 1)

    assert len(calls) == per_step(cfg)
    published = {"gemma3-1b": (get_config(arch), smoke.DECODE_PER_STEP),
                 "olmoe-1b-7b": (get_config(arch).replace(num_layers=smoke.MOE_LAYERS),
                                 smoke.MOE_DECODE),
                 "seamless-m4t-large-v2": (get_config(arch), smoke.ENCDEC_DECODE),
                 "mamba2-370m": (get_config(arch, smoke=True), smoke.SSM_FLASH),
                 "zamba2-7b": (get_config(arch).replace(num_layers=smoke.HYBRID_LAYERS),
                               smoke.HYBRID_FLASH)}
    c, want = published[arch]
    assert per_step(c) == want

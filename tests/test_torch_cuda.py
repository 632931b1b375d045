"""The port's hand-written kernels on the card, each held against its
plain PyTorch version; and the wrappers' device dispatch, on any machine.

This file imports only torch and the port (no JAX), so it runs on the
machine with the card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. Without a card the ``cuda`` tests skip."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn

# the reference's kernel sweep (tests/test_kernels.py, which imports JAX):
# B, Sq, Sk, H, KV, hd, causal, window
FA_CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 1, 128, True, 0),       # MQA
    (2, 96, 96, 2, 2, 32, True, 0),          # non-block-multiple
    (1, 128, 128, 4, 4, 64, True, 64),       # sliding window
    (1, 64, 192, 4, 2, 64, False, 0),        # cross attention Sq != Sk
    (1, 200, 72, 2, 1, 16, True, 0),         # ragged both sides
]
RMS_CASES = [(1, 8), (4, 300), (37, 128), (128, 1024), (5, 7)]
# the window case whose whole kv blocks the TPU kernel skips
WINDOW_CASE = (1, 512, 512, 2, 2, 32, True, 100)
# gemma3-1b's prefill shapes at serving size: MQA, head_dim 256
SLICE_CASES = [(4, 1024, 1024, 4, 1, 256, True, 0),
               (4, 1024, 1024, 4, 1, 256, True, 512)]
SLICE_RMS = [(4096, 1152), (4, 1024, 4, 256)]


def qkv(case, seed=0):
    """numpy f32 q, k, v for an FA case, from a seed."""
    B, Sq, Sk, H, KV, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, hd)).astype(np.float32))


def test_wrappers_count_no_launch_on_cpu():
    before = (fa.launches, rn.launches)
    q, k, v = (torch.from_numpy(a) for a in qkv(FA_CASES[0]))
    fa.flash_attention(q, k, v)
    rn.rmsnorm(q, torch.ones(q.shape[-1]))
    assert (fa.launches, rn.launches) == before


def test_wrappers_raise_on_a_device_without_kernel():
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        rn.rmsnorm(q, torch.empty(16, device="meta"))


# ------------------------------------------------------------ on the card
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA C++ and Triton kernels "
                    "run only on the card (python3 chip_smoke.py runs them)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES + [WINDOW_CASE] + SLICE_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(cuda, case, dt):
    causal, window = case[6], case[7]
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in qkv(case))
    n = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == n + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_CASES + SLICE_RMS)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, shape, dt):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda).to(dt)
    s = torch.randn(shape[-1], generator=g, device=cuda).to(dt)
    n = rn.launches
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn.launches == n + 1
    want = rn.rmsnorm_plain(x, s).float()
    # bf16: outputs reach ~10 on these inputs, where one bf16 ulp is 2**-7
    # relative; the two sum in other orders, so allow one ulp beside 3e-2
    atol, rtol = (1e-5, 0.0) if dt == torch.float32 else (3e-2, 2.0**-7)
    assert ((got.float() - want).abs() - rtol * want.abs()).max().item() <= atol

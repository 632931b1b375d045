"""The port's kernels against the reference's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the reference oracle (``ref.py``) and the Pallas kernel in
interpret mode, on the reference's own cases. The CUDA C++
kernels themselves are tested on the card by ``test_torch_cuda.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.flash_attention import flash_attention_ref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_ref
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rmsnorm import ops as rn
import test_torch_cuda
from test_kernels import FA_CASES, RMS_CASES
from test_torch_cuda import WINDOW_CASE, qkv as _qkv


def test_card_tests_use_the_reference_sweep_cases():
    # test_torch_cuda.py keeps its own copy (it must import no JAX)
    assert test_torch_cuda.FA_CASES == FA_CASES
    assert test_torch_cuda.RMS_CASES == RMS_CASES


def _jax_pair(q, k, v, dt, causal, window):
    qj, kj, vj = (jnp.asarray(a, dtype=jnp.dtype(dt)) for a in (q, k, v))
    ref = flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    pal = pallas_flash(qj, kj, vj, causal=causal, window=window,
                       block_q=64, block_k=64, interpret=True)
    return np.asarray(ref, np.float32), np.asarray(pal, np.float32)


@pytest.mark.parametrize("case", FA_CASES + [WINDOW_CASE])
def test_plain_flash_attention_matches_reference_f32(case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case)
    ref, pal = _jax_pair(q, k, v, "float32", causal, window)
    # the CPU wrapper path is the plain version
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    # f32 both sides, another summation order: 2e-5 as the reference's sweep
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pal, atol=2e-5)


@pytest.mark.parametrize("case", [FA_CASES[0], FA_CASES[1], FA_CASES[3]])
def test_plain_flash_attention_matches_reference_bf16(case):
    causal, window = case[6], case[7]
    q, k, v = _qkv(case, seed=1)
    ref, pal = _jax_pair(q, k, v, "bfloat16", causal, window)
    qt, kt, vt = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    # bf16 inputs; the reference rounds scores and weights to bf16, the
    # plain version keeps them in f32: 2e-2 as the reference's bf16 sweep
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), pal, atol=2e-2)


@pytest.mark.parametrize("shape", RMS_CASES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_rmsnorm_matches_reference(shape, dt):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal(shape[-1]).astype(np.float32)
    xj, sj = jnp.asarray(x, jnp.dtype(dt)), jnp.asarray(s, jnp.dtype(dt))
    ref = np.asarray(rmsnorm_ref(xj, sj), np.float32)
    pal = np.asarray(pallas_rmsnorm(xj, sj, interpret=True), np.float32)
    tdt = getattr(torch, dt)
    got = rn.rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(s).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    tol = 1e-5 if dt == "float32" else 3e-2   # as the reference's sweep
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)
    np.testing.assert_allclose(got.float().numpy(), pal, atol=tol)

"""The host side of rmsnorm's backward kernel, on the CPU (the kernel runs
only on the card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``):
the tma route's plan (``_bwd_plan``: a partition of the rows that depends
on (n, d, itemsize) alone, a ring that fits a CTA's shared memory, two
CTAs an SM at gemma3-1b's training shapes), ``bwd_route`` (the training
shapes on the tma route, unaligned rows on the two_pass route), and a
plain-torch emulation of the kernel's fixed summation order for dscale
against ``jax.vjp`` of the reference's ``rms_norm``."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import rms_norm as ref_rms_norm
from repro_torch.configs import get_config
from repro_torch.kernels.rmsnorm import ops as rn

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132
# dscale, as chip_smoke.py and the card's tests hold the kernel's: within
# 1e-4 of the largest value (a sum over the rows, in another order), plus
# bf16's rounding of each value
DSCALE_TOL = 1e-4


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cta_rows(n: int, ctas: int, i: int) -> tuple[int, int]:
    """The rows [lo, hi) that CTA ``i`` of ``ctas`` owns on the tma route:
    rmsnorm.cu's ``rmsnorm_bwd_tma_kernel`` computes [i n / P, (i + 1) n / P)
    from its grid."""
    return i * n // ctas, (i + 1) * n // ctas


def _training_shapes() -> dict:
    """gemma3-1b's norms in a training step of 2 x 4096 tokens, (rows, d):
    the attn, mlp and final norms; the q-norm over 4 heads; the k-norm."""
    cfg = get_config("gemma3-1b")
    tokens = 2 * 4096
    hd = cfg.resolved_head_dim
    return {"norm": (tokens, cfg.d_model), "q_norm": (tokens * cfg.num_heads, hd),
            "k_norm": (tokens * cfg.num_kv_heads, hd)}


def test_training_shapes_are_chip_smokes():
    """The shapes below are the ones ``chip_smoke.py`` times and checks."""
    assert set(_training_shapes().values()) == set(_smoke().RMS_BWD_TRAIN)


# -------------------------------------------------------------------- plan
PLAN_CASES = [(8192, 1152, 2), (32768, 256, 2), (8192, 256, 2), (8192, 1152, 4),
              (1, 8, 2), (5, 8, 4), (37, 128, 4), (263, 256, 2), (264, 256, 2),
              (265, 1152, 2), (100_000, 1280, 2), (4096, 640, 4)]


@pytest.mark.parametrize("n,d,itemsize", PLAN_CASES)
def test_bwd_plan_partitions_every_row_once_and_fits_shared_memory(n, d, itemsize):
    plan = rn._bwd_plan(n, d, itemsize)
    assert plan == rn._bwd_plan(n, d, itemsize)
    assert plan.ctas % plan.cluster == 0 and 1 <= plan.cluster <= 8
    spans = [cta_rows(n, plan.ctas, i) for i in range(plan.ctas)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))   # contiguous
    assert max(hi - lo for lo, hi in spans) <= -(-n // plan.ctas)  # balanced
    # the ring, barriers and flag, as rmsnorm.cu's tma_smem counts them
    ring = plan.stages * 2 * plan.rows_per_stage * d * itemsize
    assert plan.smem_bytes == ring + 16 * plan.stages + 16
    assert plan.smem_bytes <= 227 * 1024
    assert ring >= plan.warps * d * 4        # the warps' dscale rows fit after
    assert plan.rows_per_stage % plan.warps == 0 and plan.stages >= 2


def test_bwd_plan_reads_nothing_from_a_card(monkeypatch):
    """The grid is the determinism: it must not follow the SM count or the
    clock, so the plan never asks the device."""
    def refuse(*a, **k):
        raise AssertionError("the plan asked the device")

    for name in ("get_device_properties", "device_count", "current_device",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    want = [rn._bwd_plan(n, d, s) for n, d, s in PLAN_CASES]
    assert [rn._bwd_plan(n, d, s) for n, d, s in PLAN_CASES] == want


@pytest.mark.parametrize("name", ["norm", "q_norm", "k_norm"])
def test_bwd_plan_gives_every_sm_two_ctas_at_the_training_shapes(name):
    n, d = _training_shapes()[name]
    plan = rn._bwd_plan(n, d, 2)
    assert plan.ctas >= 2 * H100_SMS
    rows = [hi - lo for lo, hi in (cta_rows(n, plan.ctas, i)
                                   for i in range(plan.ctas))]
    assert min(rows) >= 1 and max(rows) - min(rows) <= 1


# ------------------------------------------------------------------- route
def _aligned(shape, dtype, offset=0):
    """A CPU tensor of ``shape`` whose data starts ``offset`` elements past
    a 64-byte boundary."""
    n = int(np.prod(shape))
    base = torch.empty(n + 64, dtype=dtype)
    skip = (-base.data_ptr() % 64) // base.element_size() + offset
    return base[skip:skip + n].view(shape)


@pytest.mark.parametrize("name", ["norm", "q_norm", "k_norm"])
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_bwd_route_sends_every_training_shape_to_tma(name, layout):
    """gemma3-1b's training rows in bf16 (bf16 scale): contiguous, and the
    q/k-norm rows read through a stride (heads of a fused projection)."""
    n, d = _training_shapes()[name]
    if layout == "contiguous":
        rows, stride = _aligned((n, d), torch.bfloat16), d
    else:
        wide = _aligned((n, 6 * d), torch.bfloat16)
        rows, stride = wide[:, 2 * d:3 * d], 6 * d
    dy = _aligned((n, d), torch.bfloat16)
    scale = _aligned((d,), torch.bfloat16)
    assert rn.bwd_route(rows, dy, scale, stride) == "tma"


@pytest.mark.parametrize("shape,dtype,route", [
    ((5, 7), torch.bfloat16, "two_pass"),      # d * 2 bytes not a multiple of 16
    ((4, 300), torch.bfloat16, "two_pass"),
    ((5, 7), torch.float32, "two_pass"),
    ((4, 300), torch.float32, "tma"),          # 1,200 bytes a row
    ((1, 8), torch.bfloat16, "tma"),
    ((37, 128), torch.float32, "tma"),
    ((16, 1280), torch.bfloat16, "tma"),       # 160 vectors, the widest
    ((16, 640), torch.float32, "tma"),
    ((16, 2048), torch.bfloat16, "two_pass"),  # 256 vectors
    ((16, 1024), torch.float32, "two_pass"),
    ((8, 7168), torch.bfloat16, "two_pass"),
])
def test_bwd_route_by_row_width(shape, dtype, route):
    rows, dy, scale = (_aligned(shape, dtype), _aligned(shape, dtype),
                       _aligned(shape[-1:], dtype))
    assert rn.bwd_route(rows, dy, scale, shape[-1]) == route


@pytest.mark.parametrize("what", ["x", "dy", "stride", "scale"])
def test_bwd_route_sends_unaligned_rows_to_two_pass(what):
    n, d = 64, 256
    rows = _aligned((n, d + 8), torch.bfloat16, offset=1 if what == "x" else 0)
    stride = d + 4 if what == "stride" else d + 8          # 8 bytes off 16
    rows = rows.flatten()[:(n - 1) * stride + d].as_strided((n, d), (stride, 1))
    dy = _aligned((n, d), torch.bfloat16, offset=1 if what == "dy" else 0)
    scale = _aligned((d,), torch.bfloat16, offset=1 if what == "scale" else 0)
    assert rn.bwd_route(rows, dy, scale, stride) == "two_pass"
    # a float32 scale need not be aligned: the forward reads it a value at a time
    if what == "scale":
        assert rn.bwd_route(rows, dy, _aligned((d,), torch.float32, 1), stride) == "tma"


def test_cpu_backward_launches_no_kernel():
    """On the CPU the norm's gradient is the plain version's: no route
    counts a launch."""
    before = (rn.backward_launches, dict(rn.backward_launches_by_route))
    x = torch.randn(4, 256, requires_grad=True)
    s = torch.ones(256, requires_grad=True)
    rn.rmsnorm(x, s).sum().backward()
    assert x.grad is not None and s.grad is not None
    assert (rn.backward_launches, rn.backward_launches_by_route) == before


# ------------------------------------------------- dscale's order, emulated
def emulate_dscale(x, scale, dy, plan, eps=1e-6):
    """dscale summed in the tma kernel's order, in float32 plain torch: CTA
    i owns rows ``cta_rows``; in each tile of ``rows_per_stage`` rows,
    warp w takes rows w, w + 4, ... and adds dy * xh row after row; the
    CTA adds its warps in order, a cluster its CTAs in rank order, and the
    last cluster the clusters' rows in order 0..Q-1."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    term = dyf * (xf * r)
    n, d = x.shape
    R, W = plan.rows_per_stage, plan.warps
    partials = []
    for i in range(plan.ctas):
        lo, hi = cta_rows(n, plan.ctas, i)
        warps = [torch.zeros(d) for _ in range(W)]
        for row in range(lo, hi):
            w = (row - lo) % R % W
            warps[w] = warps[w] + term[row]
        cta = warps[0]
        for w in range(1, W):
            cta = cta + warps[w]
        partials.append(cta)
    total = torch.zeros(d)
    for q in range(plan.ctas // plan.cluster):
        cluster = torch.zeros(d)
        for rank in range(plan.cluster):
            cluster = cluster + partials[q * plan.cluster + rank]
        total = total + cluster
    return total.to(scale.dtype)


@pytest.mark.parametrize("n,d", [(600, 64), (300, 256), (40, 1152)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_dscale_order_matches_jax_vjp_of_reference(n, d, dtype):
    """Rows split by the plan (several clusters at 600 and 300 rows, one at
    40), per-CTA partials, then the rows of partials in order: within the
    tolerance the kernel's dscale is held to on the card (DSCALE_TOL).
    This checks that the plan's order of summation keeps dscale within that
    tolerance; it does not run the kernel. The kernel's dscale is held
    against ``rmsnorm_backward_plain`` on the card, by
    ``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s phase 2."""
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    s = (1.0 + 0.5 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda a, b: ref_rms_norm(a, b), jnp.asarray(x, jdt),
                     jnp.asarray(s, jdt))
    want = np.asarray(vjp(jnp.asarray(dy, jdt))[1], np.float64)
    tdt = getattr(torch, dtype)
    xt, st, dyt = (torch.from_numpy(a).to(tdt) for a in (x, s, dy))
    plan = rn._bwd_plan(n, d, xt.element_size())
    got = emulate_dscale(xt, st, dyt, plan).float().numpy().astype(np.float64)
    tol = DSCALE_TOL * np.abs(want).max() + (2.0**-8 * np.abs(want) if dtype == "bfloat16"
                                             else 0.0)
    assert (np.abs(got - want) <= tol).all()

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
# the tensor-core route at each of its head dims (bf16; f32 takes the simt
# route on the same cases): B, Sq, Sk, H, KV, hd, causal, window, q_offset
WGMMA_CASES = [
    case
    for hd in (64, 128, 256)
    for case in (
        (2, 200, 200, 2, 1, hd, True, 0, 0),      # ragged: not tile multiples
        (1, 100, 300, 2, 2, hd, True, 0, 200),    # q_offset > 0 (a later chunk)
        (1, 150, 70, 4, 2, hd, False, 0, 0),      # cross attention, Sq != Sk
        (1, 256, 256, 4, 2, hd, True, 0, 0),      # GQA, H/KV = 2
        (2, 192, 192, 8, 2, hd, True, 0, 0),      # GQA, H/KV = 4
        (1, 300, 300, 2, 1, hd, True, 40, 0),     # window smaller than a tile
    )
]
# hd 224 (zamba2-7b's shared block) runs on the hd-256 tile: the reference's
# kernel sweep shapes at hd 224, an odd length, a window, and the prefill
HD224_CASES = [case[:5] + (224,) + case[6:] for case in FA_CASES] + [
    (1, 333, 333, 4, 2, 224, True, 0),       # odd length, GQA
    (2, 257, 257, 2, 2, 224, True, 100),     # window, ragged
    (4, 1024, 1024, 32, 32, 224, True, 0),   # zamba2-7b's prefill shape
]


def qkv(case, seed=0):
    """numpy f32 q, k, v for an FA case, from a seed."""
    B, Sq, Sk, H, KV, hd = case[:6]
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
        pytest.skip("needs an NVIDIA GPU: the CUDA C++ kernels "
                    "run only on the card (python3 chip_smoke.py runs them)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", FA_CASES + [WINDOW_CASE] + SLICE_CASES + WGMMA_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_on_card(cuda, case, dt):
    causal, window = case[6], case[7]
    q_offset = case[8] if len(case) > 8 else 0
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in qkv(case))
    kind = fa.route(dt, case[5])
    n, n_route = fa.launches, fa.launches_by_route[kind]
    got = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.launches == n + 1
    assert fa.launches_by_route[kind] == n_route + 1      # which kernel ran
    assert kind == ("wgmma" if dt == torch.bfloat16 and case[5] >= 64 else "simt")
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", HD224_CASES)
def test_flash_attention_hd224_on_the_wgmma_route_matches_plain_on_card(cuda, case):
    causal, window = case[6], case[7]
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in qkv(case, seed=3))
    n = fa.launches_by_route["wgmma"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches_by_route["wgmma"] == n + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_attention_hd224_writes_no_column_past_224_on_card(cuda):
    """The kernel's C entry writes into a view of the first 224 columns of
    256-wide rows whose last 32 hold a sentinel: the hd-256 tile's
    epilogue must leave them."""
    case = (2, 200, 200, 4, 2, 224, True, 0)
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in qkv(case, seed=4))
    buf = torch.full((2, 200, 4, 256), 7.0, device=cuda, dtype=torch.bfloat16)
    out = buf[..., :224]
    _, strides = fa._check(q, k, v)
    err = fa._library().fa_forward_wgmma(
        224, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 200, 200, 4, 2,
        *strides, *(out.stride(i) for i in range(3)), 1, 0, 0, 224**-0.5,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert bool((buf[..., 224:] == 7.0).all())
    want = fa.flash_attention_plain(q, k, v)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_flash_attention_hd224_reads_columns_192_to_223_and_no_further_on_card(cuda):
    """q, k and v are non-zero only in columns 192-223, the fourth slab's
    part inside hd 224: a kernel that dropped the slab (SLABS = 224 / 64 =
    3) would give uniform weights and zero output there. They are views of
    256-wide rows whose columns 224-255 hold large values, which a map
    wider than 224 would read into every score."""
    case = (1, 300, 300, 4, 2, 224, True, 0)
    bufs = []
    for a in qkv(case, seed=5):
        wide = np.full(a.shape[:3] + (256,), 50.0, np.float32)
        wide[..., :224] = 0.0
        wide[..., 192:224] = a[..., 192:224]
        bufs.append(torch.from_numpy(wide).to(cuda, torch.bfloat16))
    q, k, v = (b[..., :224] for b in bufs)
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = fa.flash_attention_plain(q, k, v)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert want[..., 192:].float().abs().amax().item() > 0.5   # far above the tolerance
    assert not bool(got[..., :192].any())


@pytest.mark.cuda
def test_flash_attention_wgmma_raises_on_unaligned_input_on_card(cuda):
    base = torch.zeros((1, 64, 2, 65), device=cuda, dtype=torch.bfloat16)
    q = base[..., 1:]                 # base pointer 2 bytes off, stride 65
    k = torch.zeros((1, 64, 1, 64), device=cuda, dtype=torch.bfloat16)
    n = fa.launches
    with pytest.raises(ValueError, match="16"):
        fa.flash_attention(q, k, k)
    assert fa.launches == n


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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_reads_strided_rows_on_card(cuda, dt):
    # the final norm's input at prefill: the last position of each sequence
    g = torch.Generator(device=cuda).manual_seed(1)
    full = torch.randn((4, 16, 1152), generator=g, device=cuda).to(dt)
    x = full[:, -1:, :]
    s = torch.randn(1152, generator=g, device=cuda).to(dt)
    n = rn.launches
    got = rn.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rn.launches == n + 1 and got.shape == x.shape
    want = rn.rmsnorm_plain(x, s).float()
    atol, rtol = (1e-5, 0.0) if dt == torch.float32 else (3e-2, 2.0**-7)
    assert ((got.float() - want).abs() - rtol * want.abs()).max().item() <= atol


# backward shapes: the sweep's odd widths, gemma3-1b's training shapes
# (small row counts), zamba2's widest norm, and f32 rows past NV = 4
RMS_BWD_CASES = [(5, 7), (4, 300), (37, 128), (64, 1152), (128, 256), (3, 5, 1152),
                 (16, 2048), (8, 7168), (1, 8)]


def _bwd_inputs(cuda, shape, dt, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda).to(dt)
    s = (1 + 0.5 * torch.randn(shape[-1], generator=g, device=cuda)).to(dt)
    dy = torch.randn(shape, generator=g, device=cuda).to(dt)
    return x, s, dy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RMS_BWD_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_kernel_matches_plain_on_card(cuda, shape, dt):
    x, s, dy = _bwd_inputs(cuda, shape, dt)
    n = rn.backward_launches
    dx, ds = rn._launch_backward(x, s, dy, 1e-6)
    torch.cuda.synchronize()
    assert rn.backward_launches == n + 1
    want_dx, want_ds = rn.rmsnorm_backward_plain(x, s, dy)
    assert dx.dtype == dt and ds.dtype == dt and dx.shape == x.shape
    atol, rtol = (1e-5, 0.0) if dt == torch.float32 else (3e-2, 2.0**-7)
    excess = (dx.float() - want_dx.float()).abs() - rtol * want_dx.float().abs()
    assert excess.max().item() <= atol
    # dscale: a sum over the rows, against the float32 plain sum, within
    # 1e-4 of its largest value (a column's sum may cancel to near 0), and
    # bf16's rounding of each value
    f32 = rn.rmsnorm_backward_plain(x.float(), s.float(), dy.float())[1]
    tol = 1e-4 * f32.abs().max() + (2.0**-8 * f32.abs() if dt == torch.bfloat16 else 0)
    assert ((ds.float() - f32).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_rmsnorm_backward_reads_strided_rows_on_card(cuda, dt):
    full, s, _ = _bwd_inputs(cuda, (4, 16, 1152), dt, seed=2)
    x = full[:, -1:, :]
    dy = torch.randn(x.shape, device=cuda).to(dt)
    dx, ds = rn._launch_backward(x, s, dy, 1e-6)
    want_dx, want_ds = rn.rmsnorm_backward_plain(x, s, dy)
    atol, rtol = (1e-5, 0.0) if dt == torch.float32 else (3e-2, 2.0**-7)
    for got, want in ((dx, want_dx), (ds, want_ds)):
        excess = (got.float() - want.float()).abs() - rtol * want.float().abs()
        assert excess.max().item() <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8192, 1152), (32768, 256), (5, 7)])
def test_rmsnorm_backward_dscale_is_the_same_bits_on_every_call(cuda, shape):
    x, s, dy = _bwd_inputs(cuda, shape, torch.bfloat16, seed=3)
    a = rn._launch_backward(x, s, dy, 1e-6)
    b = rn._launch_backward(x, s, dy, 1e-6)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    s32 = s.float()
    c = rn._launch_backward(x, s32, dy, 1e-6)[1]
    assert torch.equal(c, rn._launch_backward(x, s32, dy, 1e-6)[1])


@pytest.mark.cuda
def test_rmsnorm_under_grad_runs_both_kernels_and_no_grad_stays_lean(cuda):
    x, s, dy = _bwd_inputs(cuda, (6, 256), torch.bfloat16, seed=4)
    n, nb = rn.launches, rn.backward_launches
    with torch.no_grad():
        y0 = rn.rmsnorm(x, s.clone().requires_grad_())
    assert y0.grad_fn is None and (rn.launches, rn.backward_launches) == (n + 1, nb)
    xg, sg = x.clone().requires_grad_(), s.clone().requires_grad_()
    y = rn.rmsnorm(xg, sg)
    assert y.grad_fn is not None
    gx, gs = torch.autograd.grad(y, (xg, sg), dy)
    assert (rn.launches, rn.backward_launches) == (n + 2, nb + 1)
    want = rn.rmsnorm_backward_plain(x, s, dy)
    assert torch.equal(gx, rn._launch_backward(x, s, dy, 1e-6)[0])
    assert ((gs.float() - want[1].float()).abs() <= 3e-2 + 2.0**-7 * want[1].float().abs()).all()


@pytest.mark.cuda
def test_flash_attention_refuses_grad_on_card(cuda):
    q = torch.randn((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    k = torch.randn((1, 64, 1, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="impl='chunked'"):
        fa.flash_attention(q, k, k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
def test_smoke_training_step_gradients_on_card_match_cpu(cuda, arch):
    """A float32 smoke training step on the card (rmsnorm forward and
    backward kernels, chunked attention) against the CPU's (plain
    versions, which the CPU tests hold against the JAX package): the loss
    and every gradient within 1e-4 of the gradient's largest magnitude;
    each norm of the step launched its backward once."""
    from repro_torch import models
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    cpu = models.init_params(cfg, 0, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17), dtype=np.int32)
    out = {}
    for dev in ("cpu", cuda):
        p = {n: t.to(dev).requires_grad_() for n, t in cpu.items()}
        batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
                 "labels": torch.as_tensor(toks[:, 1:], device=dev)}
        nb = rn.backward_launches
        loss = models.loss_fn(cfg, p, batch)
        grads = torch.autograd.grad(loss, list(p.values()))
        out[str(dev)] = (loss.item(), {n: g.cpu() for n, g in zip(p, grads)},
                         rn.backward_launches - nb)
    (l_cpu, g_cpu, nb_cpu), (l_gpu, g_gpu, nb_gpu) = out["cpu"], out[str(cuda)]
    assert nb_cpu == 0 and nb_gpu > 0
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for n, g in g_cpu.items():
        scale = max(g.abs().max().item(), 1e-30)
        assert (g_gpu[n] - g).abs().max().item() <= 1e-4 * scale, n


# ----------------------------------------------------- paged relocation copy
# the reference's cases (tests/test_kernels.py): (pages, copies)
PAGED_CASES = [(4, 2), (64, 64), (128, 37)]


def _paged_case(n_pages, n_copies, seed=0):
    rng = np.random.default_rng(seed)
    blob = rng.integers(-(2**31), 2**31 - 1, (n_pages, 8, 128), dtype=np.int32)
    arena = rng.integers(-(2**31), 2**31 - 1, (n_pages, 8, 128), dtype=np.int32)
    src = rng.integers(0, n_pages, n_copies, dtype=np.int32)
    dst = rng.permutation(n_pages)[:n_copies].astype(np.int32)
    return blob, arena, src, dst


def test_paged_wrapper_counts_no_launch_on_cpu():
    from repro_torch.kernels.paged_reloc_copy import ops as prc

    blob, arena, src, dst = _paged_case(8, 5)
    before = prc.launches
    prc.paged_reloc_copy(torch.from_numpy(blob), torch.from_numpy(arena), src, dst)
    assert prc.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n_pages,n_copies", PAGED_CASES + [(8, 0)])
def test_paged_reloc_copy_kernel_matches_plain_on_card(cuda, n_pages, n_copies):
    from repro_torch.kernels.paged_reloc_copy import ops as prc

    blob, arena, src, dst = (torch.from_numpy(a) for a in _paged_case(n_pages, n_copies))
    blob, arena = blob.to(cuda), arena.to(cuda)
    want = prc.paged_reloc_copy_plain(blob, arena.clone(), src, dst)
    n = prc.launches
    got = prc.paged_reloc_copy(blob, arena, src, dst)
    torch.cuda.synchronize()
    assert prc.launches == n + (1 if n_copies else 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_paged_reloc_copy_keeps_untouched_pages_on_card(cuda):
    from repro_torch.kernels.paged_reloc_copy import ops as prc

    blob = torch.zeros((4, 8, 128), dtype=torch.int32, device=cuda)
    arena = torch.full((8, 8, 128), 7, dtype=torch.int32, device=cuda)
    prc.paged_reloc_copy(blob, arena, np.array([0]), np.array([3]))
    torch.cuda.synchronize()
    assert bool((arena[3] == 0).all())
    assert bool((arena[[0, 1, 2, 4, 5, 6, 7]] == 7).all())


@pytest.mark.cuda
def test_device_load_on_card_equals_host_image(cuda, tmp_path):
    from repro_torch.ckpt import bundle_from_params
    from repro_torch.core import EpochCache, ObjectKind, SymbolRef, make_object
    from repro_torch.kernels.paged_reloc_copy import ops as prc
    from repro_torch.link import Workspace

    g = torch.Generator().manual_seed(5)
    params = {"x": torch.randn((600, 32), generator=g).to(torch.bfloat16),
              "y": torch.randn((2, 4, 8), generator=g)}
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    bundle, payload = bundle_from_params("lib", "1", params)
    app, _ = make_object(
        name="app", version="1", kind=ObjectKind.APPLICATION,
        refs=[SymbolRef("x", (600, 32), "bfloat16"),
              SymbolRef("y[1]", (4, 8), "float32"),
              SymbolRef("y", (2, 4, 8), "bfloat16")],        # a CAST host row
        needed=["lib"])
    with ws.management() as tx:
        tx.publish(bundle, payload)
        tx.publish(app)
    n = prc.launches
    got = ws.load("app", strategy="stable", device=cuda)
    assert prc.launches == n + 1
    host = ws.load("app", strategy="stable")
    for name, t in got.tensors.items():
        assert t.device.type == "cuda"
        want = np.ascontiguousarray(host.tensors[name]).reshape(-1).view(np.uint8)
        assert np.array_equal(t.reshape(-1).view(torch.uint8).cpu().numpy(), want), name


@pytest.mark.cuda
def test_run_traffic_on_card_matches_cpu_with_exact_launches(cuda, tmp_path):
    """Two spawned workers serve gemma3-1b's smoke config (float32: the
    simt flash route) on the card: each worker's own launch counts are
    exact (one paged copy for its ``stable`` load, one flash launch per
    layer per admission, 4 x layers + 1 rmsnorm launches per admission and
    per step), and every stream equals the same drive's on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core import EpochCache, shm_arena
    from repro_torch.launch.serve import publish_model
    from repro_torch.link import Workspace
    from repro_torch.serve import run_traffic

    cfg = get_config("gemma3-1b", smoke=True)
    n, layers = 8, cfg.num_layers
    ws = Workspace.open(tmp_path / "store", epoch_cache=EpochCache())
    app = publish_model(ws, cfg, device="cpu")
    try:
        reps = {dev: run_traffic(ws, app, arch="gemma3-1b", workers=2, n_requests=n,
                                 rate_hz=100.0, prompt_len=20, max_new_tokens=4,
                                 max_batch=2, strategy="stable", stream=True,
                                 device=dev, timeout=300)
                for dev in ("cuda", "cpu")}
    finally:
        shm_arena.unlink_root_segments(ws.registry)
    for dev, rep in reps.items():
        s = rep.summary()
        assert rep.completed == n and rep.failed == 0, (dev, s)
        assert rep.stream_gaps == 0 and rep.stream_mismatches == 0, (dev, s)
        assert set(rep.stream_tokens) == set(range(n)), (dev, s)
    for rid in range(n):
        np.testing.assert_array_equal(reps["cuda"].stream_tokens[rid],
                                      reps["cpu"].stream_tokens[rid])
    stats = reps["cuda"].worker_stats
    assert [st["worker"] for st in stats] == [0, 1]
    assert sum(st["serve_loop"]["admitted"] for st in stats) == n + 2  # + warmups
    for st in stats:
        adm, steps = st["serve_loop"]["admitted"], st["serve_loop"]["steps"]
        assert st["device"].startswith("cuda")
        assert st["launches"] == {
            "flash_attention": layers * adm,
            "rmsnorm": (4 * layers + 1) * (adm + steps),
            "rmsnorm_backward": 0,
            "paged_reloc_copy": 1,
            "flash_routes": {"wgmma": 0, "simt": layers * adm},
        }, st


# ------------------------------------- MoE and encoder-decoder on the card
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2"])
def test_moe_and_encdec_smoke_prefill_and_decode_match_cpu_on_card(cuda, arch):
    """The smoke configs' prefill and greedy decode on the card (kernels)
    equal the CPU's (plain versions, which the CPU tests hold against the
    JAX package): logits within 1e-4 at every step, the same tokens."""
    _smoke_on_card_matches_cpu(cuda, arch)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssm_and_hybrid_smoke_prefill_and_decode_match_cpu_on_card(cuda, arch):
    """mamba2 and the hybrid (its shared block's attention at hd 32 on the
    simt route, f32) on the card against the CPU, as above; the prompt is
    longer than the smoke chunk of 8 and not a multiple of it."""
    _smoke_on_card_matches_cpu(cuda, arch)


def _smoke_on_card_matches_cpu(cuda, arch):
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.serve.scheduler import stub_frames

    cfg = get_config(arch, smoke=True)
    cpu = models.init_params(cfg, 0, "cpu")
    params = {"cpu": cpu, "cuda": {n: t.to(cuda) for n, t in cpu.items()}}
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24), dtype=np.int32)
    logits, seqs = {}, {}
    with torch.inference_mode():
        for dev, p in params.items():
            batch = {"tokens": torch.as_tensor(toks, device=dev)}
            if cfg.is_encdec:
                batch["frames"] = stub_frames(cfg, 2, 24, dev)
            lg, cache = models.prefill(cfg, p, batch, cache_len=32)
            steps, tok = [lg.float().cpu()], lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            seq = [tok.cpu()]
            for _ in range(6):
                lg, cache = models.decode_step(cfg, p, cache, tok)
                steps.append(lg.float().cpu())
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                seq.append(tok.cpu())
            logits[dev], seqs[dev] = steps, torch.cat(seq, 1)
    assert torch.equal(seqs["cpu"], seqs["cuda"])
    for a, b in zip(logits["cpu"], logits["cuda"]):
        assert (a - b).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_moe_block_bf16_ties_keep_the_cpu_order_on_card(cuda):
    """bf16 router logits that tie exactly (small integers, duplicated
    router columns): the card routes to the experts, in the order, that the
    CPU does (the lower expert first among equal probabilities), and its
    output matches the CPU's within bf16 rounding."""
    from repro_torch.models import moe

    rng = np.random.default_rng(3)
    d, e, ff, k = 64, 16, 32, 4
    x = rng.integers(-2, 3, (2, 48, d)).astype(np.float32)
    router = rng.integers(-1, 2, (d, e)).astype(np.float32)
    router[:, e // 2:] = router[:, :e // 2]
    w = [rng.standard_normal(s).astype(np.float32) * s[1] ** -0.5
         for s in ((e, d, ff), (e, d, ff), (e, ff, d))]
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in [x, router] + w]
    r_cpu = moe.route(args[0], args[1], k=k)
    probs = r_cpu.probs.numpy()
    top = np.take_along_axis(probs, r_cpu.top_e.numpy(), -1)
    assert (np.diff(top, axis=-1) == 0).any()         # the picks do tie
    np.testing.assert_array_equal(
        r_cpu.top_e.numpy(), np.argsort(-probs, axis=-1, kind="stable")[..., :k])
    on_card = [a.to(cuda) for a in args]
    r_card = moe.route(on_card[0], on_card[1], k=k)
    assert torch.equal(r_card.top_e.cpu(), r_cpu.top_e)
    assert torch.equal(r_card.keep.cpu(), r_cpu.keep)
    want, _ = moe.moe_block(*args, k=k)
    got, _ = moe.moe_block(*on_card, k=k)
    scale = want.float().abs().max().item()
    assert (got.float().cpu() - want.float()).abs().max().item() <= 2e-2 * scale


# ------------------------------------------------------ the multi-device layer
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m"])
def test_local_mesh_steps_on_card_give_the_meshless_bits(cuda, arch):
    """``build_step``'s train, prefill (flash kernel) and decode steps on
    ``make_local_mesh()`` over a one-rank NCCL group: DTensors reach the
    kernels through ``local_map`` (each launches), and the loss, the
    updated params, the logits and the tokens are the meshless steps'
    bits on the card."""
    import torch.distributed as dist

    from repro_torch import kernels, models
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import ensure_process_group, make_local_mesh
    from repro_torch.launch.steps import (build_step, make_decode_fn, make_prefill_fn,
                                          make_train_fn)
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = get_config(arch, smoke=True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 17), dtype=np.int32)
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=cuda),
             "labels": torch.as_tensor(toks[:, 1:], device=cuda)}
    opt = OptConfig(peak_lr=1e-2, warmup_steps=1)
    p0 = models.init_params(cfg, 0, cuda)
    own_group = not dist.is_initialized()
    ensure_process_group("local", "cuda")
    try:
        mesh = make_local_mesh()
        runs = {}
        for name in ("meshless", "mesh"):
            params = {n: t.clone().requires_grad_() for n, t in p0.items()}
            plain = {n: t.clone() for n, t in p0.items()}
            kernels.zero_launch_counts()
            if name == "mesh":
                shp = lambda kind: ShapeConfig(kind, 16, 4, kind)
                train = build_step(cfg, shp("train"), mesh, opt_cfg=opt).jitted
                prefill = build_step(cfg, shp("prefill"), mesh, impl="kernel").jitted
                decode = build_step(cfg, shp("decode"), mesh).jitted
                local = lambda t: t.to_local() if hasattr(t, "to_local") else t
            else:
                train = make_train_fn(cfg, opt)
                prefill, decode = make_prefill_fn(cfg, impl="kernel"), make_decode_fn(cfg)
                local = lambda t: t
            p, _, metrics = train(params, init_opt_state(params), batch)
            with torch.no_grad():
                logits, cache = prefill(plain, {"tokens": batch["tokens"]})
                tok, toks_out = torch.argmax(local(logits)[:, -1:], -1).int(), []
                for _ in range(3):
                    tok, cache = decode(plain, cache, tok)
                    toks_out.append(local(tok))
            runs[name] = (metrics["loss"], {n: local(t).detach() for n, t in p.items()},
                          local(logits), torch.cat(toks_out, 1), kernels.launch_counts())
    finally:
        if own_group:
            dist.destroy_process_group()
    (l0, p0_, lg0, t0, c0), (l1, p1, lg1, t1, c1) = runs["meshless"], runs["mesh"]
    assert torch.equal(l0, l1) and torch.equal(lg0, lg1) and torch.equal(t0, t1)
    for n, t in p0_.items():
        assert torch.equal(p1[n], t), n
    assert c1 == c0 and c1["rmsnorm"] > 0 and c1["rmsnorm_backward"] > 0
    assert c1["flash_attention"] == (0 if arch == "mamba2-370m" else cfg.num_layers)

"""The flash-attention wrapper's choice of kernel and its TMA checks, on any
machine: ``route(dtype, hd)`` and ``tma_strides`` are plain Python, so
their tables and refusals are tested here on CPU tensors; the kernels they
choose are tested on the card by ``test_torch_cuda.py``."""

from __future__ import annotations

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as fa


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 224, "wgmma"),   # zamba2-7b's shared block, on the hd-256 tile
    (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"),
    (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"),      # f32 stays off the tensor cores (TF32)
    (torch.float32, 128, "simt"),
    (torch.float32, 256, "simt"),
])
def test_route_table(dtype, hd, want):
    assert fa.route(dtype, hd) == want


@pytest.mark.parametrize("dtype,hd,err", [
    (torch.float16, 64, TypeError),
    (torch.float64, 64, TypeError),
    (torch.bfloat16, 48, ValueError),
    (torch.bfloat16, 512, ValueError),
    (torch.float32, 8, ValueError),
    (torch.float32, 224, ValueError),   # the simt route has no hd-224 case
    (torch.bfloat16, 192, ValueError),
])
def test_route_refuses_what_no_kernel_takes(dtype, hd, err):
    with pytest.raises(err):
        fa.route(dtype, hd)


def test_every_head_dim_has_a_route_in_both_dtypes():
    routes = {(dt, hd): fa.route(dt, hd)
              for dt in (torch.float32, torch.bfloat16) for hd in fa.HEAD_DIMS}
    assert {r for r in routes.values()} == {"wgmma", "simt"}
    assert all(routes[(torch.float32, hd)] == "simt" for hd in fa.HEAD_DIMS)


def test_tma_strides_of_the_model_layout():
    q = torch.zeros((2, 10, 4, 256), dtype=torch.bfloat16)
    assert fa.tma_strides(q) == (10 * 4 * 256, 4 * 256, 256)


def test_tma_strides_give_size_one_axes_a_contiguous_stride():
    # one KV head (MQA) and one sequence: their strides are never used, and
    # a transposed view may leave them anything; TMA still needs 16 B multiples
    k = torch.zeros((1, 7, 1, 64), dtype=torch.bfloat16).as_strided(
        (1, 7, 1, 64), (3, 64, 5, 1))
    assert fa.tma_strides(k) == (7 * 64, 64, 64)


def test_tma_strides_read_a_slice_of_a_fused_projection():
    # q as the first H heads of a fused (B, S, H + 2KV, hd) projection
    qkv = torch.zeros((2, 8, 6, 128), dtype=torch.bfloat16)
    q = qkv[:, :, :4]
    assert fa.tma_strides(q) == (8 * 6 * 128, 6 * 128, 128)
    v = qkv[:, :, 5:]                  # base offset 5 * 256 B: still aligned
    assert fa.tma_strides(v) == (8 * 6 * 128, 6 * 128, 128)


def test_tma_strides_refuse_an_unaligned_base():
    flat = torch.zeros(2 * 8 * 2 * 64 + 1, dtype=torch.bfloat16)
    q = flat[1:].view(2, 8, 2, 64)      # 2 bytes past an aligned address
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.tma_strides(q, "q")


def test_tma_strides_refuse_a_row_stride_off_16_bytes():
    padded = torch.zeros((2, 8, 2, 68), dtype=torch.bfloat16)
    q = padded[..., :64]                 # head stride 136 B
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        fa.tma_strides(q, "q")


def test_tma_strides_refuse_a_strided_head_dim():
    q = torch.zeros((2, 8, 64, 2), dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.tma_strides(q, "q")


def test_tma_strides_refuse_a_wrong_rank():
    with pytest.raises(ValueError, match="expected"):
        fa.tma_strides(torch.zeros((8, 64), dtype=torch.bfloat16))


def test_cpu_wrapper_counts_no_route():
    before = dict(fa.launches_by_route)
    q = torch.randn((1, 8, 2, 64)).to(torch.bfloat16)
    k = torch.randn((1, 8, 1, 64)).to(torch.bfloat16)
    out = fa.flash_attention(q, k, k)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert fa.launches_by_route == before


def test_tma_strides_take_hd_224_rows_of_448_bytes():
    # zamba2-7b's shared block: hd 224 is 448 B a row, a multiple of 16
    q = torch.zeros((2, 8, 4, 224), dtype=torch.bfloat16)
    assert fa.tma_strides(q) == (8 * 4 * 224, 4 * 224, 224)
    wide = torch.zeros((2, 8, 4, 256), dtype=torch.bfloat16)[..., :224]
    assert fa.tma_strides(wide) == (8 * 4 * 256, 4 * 256, 256)


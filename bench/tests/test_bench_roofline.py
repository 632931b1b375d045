"""Counts of operations and bytes from bench/roofline.py, worked by hand."""

from __future__ import annotations

import pytest

from bench import roofline

MOE = {"reference": "olmoe", "dtype": "bfloat16", "num_hidden_layers": 1, "hidden_size": 4,
       "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 2,
       "intermediate_size": 3, "num_experts": 4, "num_experts_per_tok": 2, "vocab_size": 10}
SSM = {"reference": "mamba2", "dtype": "bfloat16", "num_hidden_layers": 1, "hidden_size": 4,
       "state_size": 2, "head_dim": 2, "expand": 2, "n_groups": 1, "conv_kernel": 4,
       "vocab_size": 10}


def test_bound_and_experts():
    assert roofline.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.experts_hit(4, 2, 1) == pytest.approx(2.0)
    assert roofline.experts_hit(4, 2, 2) == pytest.approx(3.0)
    assert roofline.page_copy_bytes(4096) == 8192


def test_flash_call():
    # S=3, H=2, KV=1, hd=2: pairs 6, 4*2*2*6 = 96 ops; (2*3*2*2 + 2*3*1*2) * 2 B = 72
    assert roofline.flash_call(MOE, 3) == (96, 72)


def test_moe_prefill_by_hand():
    # attention params: 4*(2+2)*2 + 2*2*4 = 48; S = 1
    # ops: qkvo 2*48 = 96, attention 4*2*2*1 = 16, router 2*4*4 = 32,
    #      experts 2*2*3*4*3 = 144, head 2*4*10 = 80 -> 368
    # bytes: (48 + 16 + 2*3*4*3) * 2 = 272, cache row 2*1*2*2 = 8,
    #        embed 4*2 + head 40*2 + logits 10*4 = 128 -> 408
    assert roofline.prefill(MOE, 1) == (pytest.approx(368), pytest.approx(408))


def test_moe_decode_by_hand():
    # two rows at positions 0 and 2: keys 1 + 3 = 4
    # ops: 2*2*48 = 192, attention 4*2*2*4 = 64, router 2*2*4*4 = 64,
    #      experts 2*2*2*3*4*3 = 288, head 2*2*4*10 = 160 -> 768
    # bytes: (48 + 16 + 3*36) * 2 = 344, cache 4*8 = 32, embed 2*4*2 = 16,
    #        head 80, logits 2*10*4 = 80 -> 552
    assert roofline.decode(MOE, [0, 2]) == (pytest.approx(768), pytest.approx(552))


def test_ssm_by_hand():
    # d_inner 8, H 4, gn 2, conv 12, in_proj 2*8+2*2+4 = 24
    # ops a token: 2*4*24 + 2*8*4 + 2*4*12 + 4*4*2*2 = 192+64+96+64 = 416
    # weights: (96 + 32 + 48 + 12 + 8 + 4) * 2 + 3*4*4 = 448; state 4*2*2*4 + 3*12*2 = 136
    # prefill of 3: 3*416 + 80 ops; 448 + 136 + (3*4 + 40)*2 + 10*4 = 728 bytes
    assert roofline.prefill(SSM, 3) == (pytest.approx(1328), pytest.approx(728))
    # decode of 2 rows: 2*416 + 160 ops; 448 + 2*2*136 + (2*4 + 40)*2 + 80 = 1168 bytes
    assert roofline.decode(SSM, [5, 9]) == (pytest.approx(992), pytest.approx(1168))

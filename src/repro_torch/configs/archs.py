"""The 10 assigned architectures — exact configs from the assignment table.

Each entry records its public source and verification tier in the docstring
line. ``d_ff`` is the per-expert hidden dim for MoE archs (as assigned).
"""

from __future__ import annotations

from .base import ModelConfig

# [arXiv:2401.02954; hf] — llama-arch dense
DEEPSEEK_67B = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
)

# [hf:Qwen/Qwen1.5-0.5B; hf] — QKV bias
QWEN15_110B = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

# [hf:google/gemma-3-1b-pt; unverified] — 5:1 local:global, 128k context
GEMMA3_1B = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    qk_norm=True,
    sliding_window=512,
    global_every=6,            # layers 5, 11, 17, 23 are global (5 local : 1)
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

# [arXiv:2402.19173; hf] — GQA, RoPE, biased projections + gelu
STARCODER2_3B = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    use_bias=True,
    act="gelu",
    rope_theta=999_999.4,
)

# [arXiv:2409.02060; hf] — 64 experts, top-8, MHA
OLMOE_1B_7B = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,                 # per-expert
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    qk_norm=True,
)

# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 4 shared + 60 routed, top-4
QWEN2_MOE_A27B = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                 # per-expert
    vocab_size=151936,
    num_experts=60,
    experts_per_token=4,
    num_shared_experts=4,      # shared expert hidden = 4 * 1408 = 5632
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

# [arXiv:2405.21060; unverified] — SSD (state-space duality)
MAMBA2_370M = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,           # 32 ssm heads (expand*d_model / 64)
    ssm_chunk=128,             # §Perf hillclimb A: -17% HLO flops vs 256, MXU-aligned
    tie_embeddings=True,
)

# [arXiv:2308.11596; hf] — enc-dec, multimodal (audio frontend stubbed)
SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,             # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio_frames",
    act="gelu",
    use_bias=True,
)

# [arXiv:2405.09818; unverified] — early fusion, VQ image tokens
CHAMELEON_34B = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    frontend="vq_tokens",
)

# [arXiv:2411.15242; unverified] — Mamba2 backbone + shared attention blocks
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,                # shared-attn-block MLP hidden
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,             # §Perf hillclimb A
    attn_every=6,              # shared attn block before layers 0,6,12,...
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        DEEPSEEK_67B,
        QWEN15_110B,
        GEMMA3_1B,
        STARCODER2_3B,
        OLMOE_1B_7B,
        QWEN2_MOE_A27B,
        MAMBA2_370M,
        SEAMLESS_M4T_LARGE_V2,
        CHAMELEON_34B,
        ZAMBA2_7B,
    )
}

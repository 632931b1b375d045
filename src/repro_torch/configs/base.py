"""Architecture + shape configuration.

One ``ModelConfig`` per assigned architecture (exact numbers from the
assignment table; sources cited in each arch file). ``reduced()`` derives the
CPU-smoke-test variant of any config: same family/topology, tiny dims.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | audio | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # attention flavour
    qkv_bias: bool = False           # qwen1.5 QKV bias
    qk_norm: bool = False            # gemma3 / chameleon
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention everywhere
    global_every: int = 0            # gemma3: every Nth layer is global
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    use_bias: bool = False           # starcoder2: bias on all projections
    act: str = "silu"                # silu (SwiGLU) | gelu

    # MoE (d_ff above is the per-expert hidden dim for moe archs)
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0      # qwen2-moe: shared expert = n * d_ff wide
    capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_groups: int = 1

    # hybrid (zamba2): shared attention block every N backbone layers
    attn_every: int = 0

    # encoder-decoder (seamless): encoder layer count (0 = decoder-only)
    encoder_layers: int = 0

    # modality frontend stub: none | audio_frames | vq_tokens
    frontend: str = "none"

    dtype: str = "bfloat16"
    # activation rematerialization on the layer stack:
    #   nothing — recompute everything (min residency, max recompute)
    #   dots    — save matmul outputs, recompute elementwise
    #   none    — no remat (max residency, zero recompute)
    remat_policy: str = "nothing"

    # ----------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """True for sub-quadratic archs (see DESIGN.md §4): SSM/hybrid decode
        is O(1)/token; gemma3's 5:1 sliding-window layers bound the cache."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests (full configs are only
    exercised via the dry-run's ShapeDtypeStructs)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=max(2, min(4, cfg.attn_every + 1) if cfg.attn_every else 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=96 if not cfg.is_moe else 32,
        vocab_size=256,
        dtype="float32",
        rope_theta=cfg.rope_theta,
    )
    if cfg.is_moe:
        kw.update(num_experts=4, experts_per_token=2,
                  num_shared_experts=min(cfg.num_shared_experts, 1))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.attn_every:
        kw.update(attn_every=2, num_layers=4)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2)
    if cfg.sliding_window:
        kw.update(sliding_window=16, global_every=min(cfg.global_every, 2))
    return cfg.replace(**kw)

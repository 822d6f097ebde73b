"""Architecture / run configuration (the port's own copy of the JAX
package's ``configs/base.py``, which it does not import).

Every assigned architecture is one ``ModelConfig`` (exact public dims) plus
a ``reduced()`` variant for CPU smoke tests. Input shapes are the four
assigned cells (train_4k / prefill_32k / decode_32k / long_500k); each cell
records which step it lowers and whether the arch family supports it
(long_500k needs sub-quadratic attention; decode needs a decoder).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention dims (MiniCPM3 / DeepSeek-style)."""
    q_lora: int = 768
    kv_lora: int = 256
    nope_dim: int = 64       # per-head non-rotary dims
    rope_dim: int = 32       # shared rotary dims
    v_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0      # qwen2-moe style always-on experts
    expert_d_ff: int = 0
    moe_period: int = 1            # every k-th layer uses MoE
    capacity_factor: float = 1.25
    # --- attention flavour ---
    attn_type: str = "gqa"         # gqa | mla
    qkv_bias: bool = False
    mla: Optional[MLAConfig] = None
    rope_theta: float = 1e4
    # --- hybrid (jamba) ---
    attn_period: int = 0           # attn every k-th layer, rest SSM
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> d_model // 16
    # --- xLSTM ---
    slstm_period: int = 0          # sLSTM every k-th layer, rest mLSTM
    # --- enc-dec (seamless) ---
    enc_layers: int = 0            # 0 -> decoder-only
    # --- vlm ---
    cross_attn_period: int = 0     # cross-attn every k-th layer
    n_vision_tokens: int = 1601    # stub frontend: precomputed patch embeds
    # --- numerics / training ---
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    remat: str = "full"            # full | dots | none
    fsdp: bool = True              # shard weights over the data axis too
    # --- divisibility padding (TP) ---
    vocab_pad_to: int = 256
    expert_pad_to: int = 1         # set to EP degree at mesh-build time
    pad_heads_to: int = 0          # perf opt-in: pad q-heads for TP (e.g.
    #                                yi-34b 56 -> 64; extra heads are live
    #                                capacity)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        return max(self.n_heads, self.pad_heads_to) if self.pad_heads_to \
            else self.n_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab, self.vocab_pad_to)

    @property
    def dec_layers(self) -> int:
        return self.n_layers if self.enc_layers == 0 else self.n_layers

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or max(self.d_model // 16, 1)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid — O(1) or tiny KV state)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # all assigned archs autoregress (enc-dec has decoder)

    def padded_experts(self, ep: int) -> int:
        """Experts padded to a multiple of the expert-parallel degree."""
        return _round_up(self.n_experts, ep) if self.n_experts else 0

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        changes = dict(
            n_layers=max(2, min(4, self.attn_period or 2) * 2)
            if self.attn_period else (4 if self.enc_layers else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads <
            self.n_heads else 4,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=256,
            head_dim=16,
            n_vision_tokens=8,
            remat="none",
            fsdp=False,
            dtype="float32",
        )
        if self.is_moe:
            changes.update(n_experts=4, top_k=2, expert_d_ff=64,
                           n_shared_experts=min(self.n_shared_experts, 1))
        if self.mla is not None:
            changes.update(mla=MLAConfig(q_lora=32, kv_lora=16, nope_dim=8,
                                         rope_dim=8, v_dim=8))
        if self.enc_layers:
            changes.update(enc_layers=2, n_layers=2)
        if self.attn_period:
            changes.update(attn_period=4, n_layers=8)
        if self.slstm_period:
            changes.update(slstm_period=2, n_layers=4, head_dim=16)
        if self.cross_attn_period:
            changes.update(cross_attn_period=2, n_layers=4)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES = {s.name: s for s in ALL_SHAPES}


def shape_supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is a valid cell, and why not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full attention: 500k-token KV prefill is quadratic " \
                      "(skip per spec; run for ssm/hybrid)"
    return True, ""


def smoke_shape(cfg: ModelConfig) -> InputShape:
    return InputShape("smoke", 32, 2, "train")

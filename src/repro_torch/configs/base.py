"""Architecture + shape configuration dataclasses for the assigned model pool."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    d_expert: int               # per-expert FFN hidden dim
    num_shared: int = 0         # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # leading layers with a dense FFN instead
    d_ff_dense: int = 0          # hidden dim of those dense FFNs
    dispatch_chunks: int = 16    # lax.map chunks over token groups (memory cap)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0         # 0 = no query compression (V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False       # Qwen2.5
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # family extensions
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0          # hybrid: one (shared) attention block every k layers
    shared_attn: bool = False    # zamba2: attention block weights are shared
    enc_layers: int = 0          # encdec
    dec_layers: int = 0
    cross_every: int = 0         # vlm: cross-attention layer every k layers
    frontend_tokens: int = 0     # vlm/audio: stub frontend sequence length
    mtp_depth: int = 0           # DeepSeek-V3 multi-token prediction heads
    sub_quadratic: bool = False  # supports long_500k
    has_decoder: bool = True
    # training-system knobs
    optimizer: str = "adamw"     # adamw | adafactor | adamw8bit
    remat: str = "full"          # full | dots | none
    microbatches: int = 1        # gradient-accumulation steps per train step
    grad_accum_dtype: str = "float32"  # bf16 halves the accumulator (671B cfg)
    fsdp_over_pod: bool = True   # shard params over the pod axis too
    attn_chunk: int = 1024       # flash-style KV/Q chunking threshold block
    notes: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (reported vs public figures in configs)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        dh = self.dh
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.mla is not None:
            m = self.mla
            qdim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
            if m.q_lora_rank:
                per_layer += d * m.q_lora_rank + m.q_lora_rank * qdim
            else:
                per_layer += d * qdim
            per_layer += d * (m.kv_lora_rank + m.rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.family in ("dense", "moe", "vlm", "encdec", "hybrid"):
            per_layer += d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                + self.n_heads * dh * d
        if self.moe is not None:
            mo = self.moe
            expert = 3 * d * mo.d_expert
            moe_layers = L - mo.first_dense_layers
            per_layer_moe = (mo.num_experts + mo.num_shared) * expert + d * mo.num_experts
            total_ffn = moe_layers * per_layer_moe \
                + mo.first_dense_layers * 3 * d * mo.d_ff_dense
        elif self.family == "ssm":
            total_ffn = L * 2 * d * self.d_ff  # rwkv channel-mix (2 mats)
        else:
            total_ffn = L * 3 * d * self.d_ff  # swiglu
        if self.family == "ssm":
            # rwkv6 time-mix: r,k,v,g,o (d×d) + decay/ln params
            per_layer = 5 * d * d + 2 * d * 64
        if self.family == "hybrid" and self.ssm is not None:
            d_in = self.ssm.expand * d
            per_layer = 2 * d * d_in + d_in * d + d_in * (2 * self.ssm.d_state)
        return emb + L * per_layer + total_ffn


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k"]
    if cfg.has_decoder:
        out.append("decode_32k")
        if cfg.sub_quadratic:
            out.append("long_500k")
    return out

"""Architecture + shape configuration dataclasses.

Every assigned architecture is a selectable config (``--arch <id>``); the
exact numbers come from the assignment table (sources noted per file).
Layer *patterns* describe one scanned superblock: dense archs have
pattern ("dense",) repeated n_layers times; RecurrentGemma uses
("rec", "rec", "local_attn") (1 local-attn : 2 recurrent); the VLM inserts
a cross-attention layer every 5th layer.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LayerKind = str  # dense | moe | rwkv | rec | local_attn | cross


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qk_norm: bool = False
    activation: str = "swiglu"  # swiglu | gelu
    # Layer pattern (one scanned superblock); remainder layers appended.
    pattern: Tuple[LayerKind, ...] = ("dense",)
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25  # tokens over capacity are dropped
    # Hybrid / SSM
    rnn_width: int = 0  # RG-LRU recurrent width (0 => d_model)
    conv_width: int = 4  # temporal conv in the recurrent block
    local_window: int = 0  # local-attention window
    rwkv_head_dim: int = 64
    # VLM / audio frontends are stubs: inputs arrive as embeddings.
    embed_inputs: bool = False  # True => input_specs provide (B, S, d_model)
    n_image_tokens: int = 0  # cross-attn KV length (vlm)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # long_500k eligibility: sub-quadratic sequence mixing only.
    subquadratic: bool = False

    @property
    def n_superblocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> Tuple[LayerKind, ...]:
        r = self.n_layers % len(self.pattern)
        return self.pattern[:r]

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        d, f = self.d_model, self.d_ff
        per_layer = {}
        att = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        dense_ff = d * f * (3 if self.activation == "swiglu" else 2)
        moe_ff = self.n_experts * d * f * (
            3 if self.activation == "swiglu" else 2
        ) + d * self.n_experts
        if self.shared_expert:
            moe_ff += dense_ff
        rnn = self.rnn_width or d
        rec = d * rnn * 2 + rnn * d + rnn * (self.conv_width + 2)  # gates+out+conv+lru
        rwkv_att = 5 * d * d + d * d  # r,k,v,g,w-lora(+o) approx
        per_layer["dense"] = att + dense_ff
        per_layer["local_attn"] = att + dense_ff
        per_layer["cross"] = att + dense_ff
        per_layer["moe"] = att + moe_ff
        per_layer["rec"] = rec + dense_ff
        per_layer["rwkv"] = rwkv_att + 2 * d * f // 2  # channel mix ~ 2*d*(f/2)
        body = sum(
            per_layer[k]
            for k in (self.pattern * self.n_superblocks + self.remainder)
        )
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return body + emb

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if self.n_experts == 0:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        ff_one = d * f * (3 if self.activation == "swiglu" else 2)
        inactive = (self.n_experts - self.experts_per_token) * ff_one
        n_moe = sum(
            1 for k in (self.pattern * self.n_superblocks + self.remainder) if k == "moe"
        )
        return self.param_count() - n_moe * inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shapes_for(cfg: ArchConfig) -> Tuple[str, ...]:
    """Valid shape cells for an arch (long_500k only if sub-quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        names.append("long_500k")
    return tuple(names)

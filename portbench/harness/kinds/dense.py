"""A dense layer: pre-norm grouped-query self-attention and a SwiGLU FFN."""

from __future__ import annotations

from typing import Any, Dict, List

from .. import counts
from . import attention_layout, kv_cache_bytes, mat, weight_bytes


def layout(a: Dict[str, Any]) -> list:
    D, F = a["d_model"], a["d_ff"]
    return attention_layout(a) + [mat(("ffn", "w1"), (D, F)), mat(("ffn", "w2"), (F, D)),
                                  mat(("ffn", "w3"), (D, F))]


def product_params(a: Dict[str, Any]) -> int:
    return counts.attn_params(a) + counts.expert_params(a)


def attention_flops(a: Dict[str, Any], B: int, S: int, causal: bool = True) -> float:
    return counts.attention_flops(B, a["n_heads"], S, a["head_dim"], causal)


def decode_bytes(a: Dict[str, Any], contexts: List[int]) -> int:
    return weight_bytes(layout(a), counts.F32) + kv_cache_bytes(a, contexts, counts.BF16)

"""An MoE layer: pre-norm grouped-query self-attention, a router, and
``n_experts`` SwiGLU experts of which each token meets
``experts_per_token``."""

from __future__ import annotations

from typing import Any, Dict, List

from .. import counts
from . import attention_layout, kv_cache_bytes, mat, weight_bytes


def layout(a: Dict[str, Any]) -> list:
    D, F, E = a["d_model"], a["d_ff"], a["n_experts"]
    return attention_layout(a) + [mat(("moe", "router"), (D, E)), mat(("moe", "we1"), (E, D, F)),
                                  mat(("moe", "we2"), (E, F, D)), mat(("moe", "we3"), (E, D, F))]


def product_params(a: Dict[str, Any]) -> int:
    return (counts.attn_params(a) + a["d_model"] * a["n_experts"]
            + a["experts_per_token"] * counts.expert_params(a))


def attention_flops(a: Dict[str, Any], B: int, S: int, causal: bool = True) -> float:
    return counts.attention_flops(B, a["n_heads"], S, a["head_dim"], causal)


def decode_bytes(a: Dict[str, Any], contexts: List[int]) -> int:
    return weight_bytes(layout(a), counts.F32) + kv_cache_bytes(a, contexts, counts.BF16)

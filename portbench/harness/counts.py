"""The work an operation needs, from the configuration's shapes.

FLOPs count multiply-adds as 2 and products only: the matrix products of
the model (attention projections, the FFN or the experts a token is routed
to, the router, the head) and attention's two products. A model's counts
are its layers' summed kind by kind (`harness/kinds/<kind>.py`), and
the embedding's, final norm's and head's. Nothing an
implementation recomputes (remat) or pads (capacity slots) counts. Causal
attention counts the S (S + 1) / 2 pairs it needs. Bytes count each input
read once and each output written once, at the dtype the configuration
runs: float32 weights (4 bytes), a bfloat16 cache (2 bytes).

The arithmetic was written for the benchmark; the port's dry run
(`src/repro_torch/launch/dryrun.py`) counts what the port executes, a
different quantity.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

from . import kinds

F32 = 4
BF16 = 2


def attn_params(a: Dict[str, Any]) -> int:
    """Product parameters of one layer's attention projections."""
    D, q, kv = a["d_model"], a["n_heads"] * a["head_dim"], a["n_kv_heads"] * a["head_dim"]
    return D * q + 2 * D * kv + q * D


def expert_params(a: Dict[str, Any]) -> int:
    """One SwiGLU FFN (one expert): w1, w3 and w2."""
    return 3 * a["d_model"] * a["d_ff"]


def head_params(a: Dict[str, Any]) -> int:
    return a["d_model"] * a["vocab_size"]


def attention_flops(B: int, H: int, S: int, D: int, causal: bool = True) -> float:
    """Forward flops of attention's two products over S queries and keys."""
    pairs = S * (S + 1) / 2 if causal else S * S
    return 4.0 * B * H * D * pairs


def _over_layers(a: Dict[str, Any], per_layer):
    """``per_layer(kind)`` summed over the model's layers, kind by kind."""
    return sum(n * per_layer(kind) for kind, n in kinds.census(a))


def layers_product_params(a: Dict[str, Any]) -> int:
    """Product parameters one token meets in all the layers (routed experts
    only)."""
    return _over_layers(a, lambda k: k.product_params(a))


def product_params(a: Dict[str, Any]) -> int:
    """Product parameters one token meets in a forward pass with logits."""
    return layers_product_params(a) + head_params(a)


def train_step_flops(a: Dict[str, Any], B: int, S: int, causal: bool = True) -> float:
    """Model flops of a train step: 6 x product parameters x tokens, plus
    attention's forward and backward (3 x its forward)."""
    attn = _over_layers(a, lambda k: k.attention_flops(a, B, S, causal))
    return 6.0 * product_params(a) * B * S + 3.0 * attn


def prefill_flops(a: Dict[str, Any], B: int, P: int, causal: bool = True) -> float:
    """Forward flops of a prefill: every layer on every prompt token, the
    head on the last position of each prompt."""
    body = 2.0 * layers_product_params(a) * B * P
    attn = _over_layers(a, lambda k: k.attention_flops(a, B, P, causal))
    return body + attn + 2.0 * head_params(a) * B


def decode_step_flops(a: Dict[str, Any], contexts: Iterable[int]) -> float:
    """One decode step: each row's token through every layer and the head,
    attending over its ``context`` valid positions (its own included)."""
    contexts = list(contexts)
    per_pos = _over_layers(a, lambda k: k.attention_flops(a, 1, 1))
    return 2.0 * product_params(a) * len(contexts) + per_pos * sum(contexts)


def decode_step_bytes(a: Dict[str, Any], contexts: Iterable[int]) -> float:
    """Bytes one decode step must move: each layer's (its weights, of an MoE
    layer every expert's, and its cache's reads and writes), the final
    norm, the head, the embedding rows, and the float32 logits written."""
    contexts = list(contexts)
    B, D = len(contexts), a["d_model"]
    layers = _over_layers(a, lambda k: k.decode_bytes(a, contexts))
    return layers + F32 * (D + head_params(a) + B * D + B * a["vocab_size"])


def flash_call(B: int, H: int, KVH: int, S: int, D: int, itemsize: int = F32):
    """(flops, bytes) of one causal flash-attention forward call."""
    return attention_flops(B, H, S, D, True), itemsize * (2 * B * H * S * D + 2 * B * KVH * S * D)


def decode_attn_bytes(H: int, KVH: int, D: int, valid: Iterable[int]) -> float:
    """Bytes of one decode-attention call: each row's valid bf16 K/V once,
    its float32 query read and output written."""
    valid = list(valid)
    return 2 * KVH * D * BF16 * sum(valid) + 2 * len(valid) * H * D * F32


def roofline_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    from .peaks import HBM_BYTES_PER_S, PEAK_FLOPS

    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)

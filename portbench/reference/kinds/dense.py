"""A dense layer: pre-norm grouped-query self-attention and a SwiGLU FFN."""

from __future__ import annotations

from ..lm import attention_block, attention_step, ffn, rms_norm


def forward(a, p, x, ps):
    """x (B, S, D); positions at or after ``ps.prompt_len`` read the bf16 cache."""
    x = x + attention_block(a, p["attn"], rms_norm(x, p["norm_attn"], a["norm_eps"]),
                            ps.prompt_len)
    return x + ffn(p["ffn"], rms_norm(x, p["norm_ffn"], a["norm_eps"]))


def step(a, p, x, pos0, state, ps):
    x = attention_step(a, p, x, pos0, state)
    return x + ffn(p["ffn"], rms_norm(x, p["norm_ffn"], a["norm_eps"]))

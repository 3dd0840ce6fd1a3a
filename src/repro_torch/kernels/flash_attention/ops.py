"""Public flash-attention op: the CUDA kernel on the card, plain on CPU.

Dispatch follows q's device and nothing else: a CPU tensor takes
`ref.attention_ref` (differentiated by autograd), a CUDA tensor launches
the kernel (or raises), anything else raises. There is no fallback from
the kernel to the plain version.

On the card, when an input requires grad, the launch goes through
`FlashAttention`, whose backward recomputes the plain version under
autograd: the port of the reference's only differentiable attention (its
chunked XLA form; a `pallas_call` has no VJP). Inference launches the
kernel directly.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import obs
from . import kernel_cuda, ref


class FlashAttention(torch.autograd.Function):
    """``forward_fn(q, k, v, causal=, scale=)`` forward (the kernel on the
    card), backward by autograd through `ref.attention_ref` on the saved
    inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, forward_fn):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return forward_fn(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, do):
        with obs.span("lm.attn.flash_backward"):
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            with torch.enable_grad():
                out = ref.attention_ref(*inputs, causal=ctx.causal, scale=ctx.scale)
                dq, dk, dv = torch.autograd.grad(out, inputs, do)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention: (B,H,S,D) x (B,KVH,S,D) -> (B,H,S,D) in q's dtype."""
    kind = q.device.type
    if kind == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            if scale is None:
                scale = 1.0 / (q.shape[-1] ** 0.5)
            return FlashAttention.apply(q, k, v, causal, scale, kernel_cuda.flash_attention_cuda)
        return kernel_cuda.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    if kind == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"flash_attention: unsupported device {q.device}")

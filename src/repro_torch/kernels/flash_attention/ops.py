"""Public flash-attention op: the CUDA kernel on the card, plain on CPU.

Dispatch follows q's device and nothing else: a CPU tensor takes
`ref.attention_ref` (differentiated by autograd), a CUDA tensor launches
the kernel (or raises), anything else raises. There is no fallback from
the kernel to the plain version.

On the card, when an input requires grad, the launch goes through
`FlashAttention`: its forward also saves each row's log-sum-exp, and its
backward launches the backward kernel (`csrc/flash_attention_bwd.cu`),
which recomputes the probabilities tile by tile from it. The reference has
no such kernel (a `pallas_call` has no VJP; its only differentiable
attention is the plain XLA form), so on the CPU the backward is autograd
through `ref.attention_ref`. Inference launches the forward kernel
directly, without the log-sum-exp.
"""

from __future__ import annotations

from typing import Optional

import torch

from ... import obs
from . import kernel_cuda, ref


class FlashAttention(torch.autograd.Function):
    """``forward_fn(q, k, v, causal=, scale=)`` forward. On the card
    (``forward_fn`` the kernel, asked for its log-sum-exp) the backward is
    the backward kernel on the saved inputs, output and log-sum-exp; on the
    CPU it is autograd through `ref.attention_ref` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, forward_fn):
        ctx.causal, ctx.scale = causal, scale
        if q.device.type == "cuda":
            out, lse = forward_fn(q, k, v, causal=causal, scale=scale, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return forward_fn(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, do):
        with obs.span("lm.attn.flash_backward"):
            saved = ctx.saved_tensors
            if saved[0].device.type == "cuda":
                dq, dk, dv = kernel_cuda.flash_attention_backward_cuda(
                    do, *saved, causal=ctx.causal, scale=ctx.scale)
            else:
                inputs = [t.detach().requires_grad_() for t in saved]
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

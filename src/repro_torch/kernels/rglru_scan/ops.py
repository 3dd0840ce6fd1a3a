"""Public RG-LRU scan op: the CUDA kernel on the card, plain on CPU.

Dispatch follows gx's device and nothing else: a CPU tensor takes
`ref.rglru_scan_ref` (differentiated by autograd), a CUDA tensor launches
the kernel (or raises), anything else raises. There is no fallback from
the kernel to the plain version.

On the card, when an input requires grad, the launch goes through
`RGLRUScan`, whose backward recomputes the plain version under autograd,
as the reference differentiates its plain scan (a `pallas_call` has no
VJP). Both outputs carry gradients. The gradient of
``sqrt(-expm1(2 log_a))`` is infinite at ``log_a = 0``, as in the
reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel_cuda, ref


class RGLRUScan(torch.autograd.Function):
    """``forward_fn(log_a, gx, h0)`` forward (the kernel on the card),
    backward by autograd through `ref.rglru_scan_ref` on the saved inputs."""

    @staticmethod
    def forward(ctx, log_a, gx, h0, forward_fn):
        ctx.save_for_backward(log_a, gx, h0)
        return forward_fn(log_a, gx, h0)

    @staticmethod
    def backward(ctx, d_out, d_final):
        log_a, gx, h0 = ctx.saved_tensors
        inputs = [t.detach().requires_grad_() for t in (log_a, gx)]
        if h0 is not None:
            inputs.append(h0.detach().requires_grad_())
        with torch.enable_grad():
            outs = ref.rglru_scan_ref(*inputs[:2], inputs[2] if h0 is not None else None)
            grads = torch.autograd.grad(outs, inputs, (d_out, d_final))
        return grads[0], grads[1], grads[2] if h0 is not None else None, None


def rglru_scan(
    log_a: torch.Tensor,
    gx: torch.Tensor,
    h0: Optional[torch.Tensor] = None,
):
    """(states (B, T, D) in gx's dtype, final state (B, D) float32)."""
    kind = gx.device.type
    if kind == "cuda":
        if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (log_a, gx, h0)
        ):
            return RGLRUScan.apply(log_a, gx, h0, kernel_cuda.rglru_scan_cuda)
        return kernel_cuda.rglru_scan_cuda(log_a, gx, h0)
    if kind == "cpu":
        return ref.rglru_scan_ref(log_a, gx, h0)
    raise ValueError(f"rglru_scan: unsupported device {gx.device}")

"""Public decode-attention op: the CUDA kernel on the card, plain on CPU.

Dispatch follows q's device and nothing else: a CPU tensor takes
`ref.decode_attention_ref`, a CUDA tensor launches the kernel (or raises),
anything else raises. There is no fallback from the kernel to the plain
version. Decode takes no gradient: an input that requires grad (with grad
mode on) raises on every device, as the reference never differentiates
decode and the kernel's output would carry none.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel_cuda, ref


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """(B,H,D) query vs (B,KVH,S,D) cache, (B,) valid lengths -> (B,H,D);
    with ``return_lse`` also the (B,H) float32 log-sum-exp of each row's
    scaled logits (-inf, with a zero output, where a row has no valid
    position)."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k_cache, v_cache)
    ):
        raise RuntimeError("decode_attention takes no gradient: run decode under "
                           "torch.no_grad() or on tensors that do not require grad")
    kind = q.device.type
    if kind == "cuda":
        return kernel_cuda.decode_attention_cuda(q, k_cache, v_cache, lengths, scale=scale,
                                                 return_lse=return_lse)
    if kind == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths, scale=scale,
                                        return_lse=return_lse)
    raise ValueError(f"decode_attention: unsupported device {q.device}")

"""Public RWKV-6 scan op: the CUDA kernel on the card, plain on CPU.

Mirrors the inference forward of `repro.kernels.rwkv6_scan.ops.rwkv6_scan`:
k and v are cast to r's dtype, w, u and s0 to float32, and ``s0=None``
starts from zeros. On the card one kernel launch covers the whole sequence
(the reference's chunk checkpointing exists only for its custom VJP, which
comes with the training slice).

Dispatch follows r's device and nothing else: a CPU tensor takes
`ref.rwkv6_scan_ref`, a CUDA tensor launches the kernel (or raises),
anything else raises. There is no fallback from the kernel to the plain
version. With ``state_out`` the final state is written into that tensor
(which may be ``s0``: decode updates its cache in place) and returned.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel_cuda, ref


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    s0: Optional[torch.Tensor] = None,
    *,
    state_out: Optional[torch.Tensor] = None,
):
    """(outputs (B, H, T, N) in r's dtype, final state (B, H, N, N) float32)."""
    k, v = k.to(r.dtype), v.to(r.dtype)
    w, u = w.float(), u.float()
    s0 = None if s0 is None else s0.float()
    kind = r.device.type
    if kind == "cuda":
        return kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u.contiguous(), s0, state_out=state_out)
    if kind == "cpu":
        out, s_final = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
        if state_out is None:
            return out, s_final
        return out, state_out.copy_(s_final)
    raise ValueError(f"rwkv6_scan: unsupported device {r.device}")

"""Plain PyTorch version of the RWKV-6 scan kernel (any device).

Port of the reference's `rwkv6_scan_ref` (the Finch recurrence). Per head,
with state S in R^{N x N} (key dim x value dim):

  o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
  S_t = diag(w_t) S_{t-1} + k_t v_t^T

with the data-dependent decay w_t in (0, 1) (already exp(-exp(.))-mapped by
the caller) and the per-head bonus u. Float32 throughout, one step at a
time over every (b, h) at once; ``s0=None`` starts from zeros. Returns the
(B, H, T, N) outputs in r's dtype and the final (B, H, N, N) state in
float32. The inputs are unbound and the outputs stacked, not indexed and
written per step, so that autograd through this function (the backward of
the chunked op) moves no whole (B, H, T, N) buffer per step.
"""

from __future__ import annotations

from typing import Optional

import torch


def rwkv6_scan_ref(
    r: torch.Tensor,  # (B, H, T, N)
    k: torch.Tensor,  # (B, H, T, N)
    v: torch.Tensor,  # (B, H, T, N)
    w: torch.Tensor,  # (B, H, T, N) decay in (0, 1)
    u: torch.Tensor,  # (H, N) bonus
    s0: Optional[torch.Tensor] = None,  # (B, H, N, N) initial state
):
    B, H, _, N = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]  # (1, H, N, 1)
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) if s0 is None
         else s0.float())
    outs = []
    for r_t, k_t, v_t, w_t in zip(*(x.unbind(2) for x in (rf, kf, vf, wf))):
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, N, N)
        outs.append(((S + uf * kv) * r_t[..., :, None]).sum(dim=2))
        S = w_t[..., :, None] * S + kv
    return torch.stack(outs, dim=2).to(r.dtype), S

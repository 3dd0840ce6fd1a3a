"""Plain PyTorch version of the RWKV-6 scan kernel (any device).

Port of the reference's `rwkv6_scan_ref` (the Finch recurrence). Per head,
with state S in R^{N x N} (key dim x value dim):

  o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
  S_t = diag(w_t) S_{t-1} + k_t v_t^T

with the data-dependent decay w_t in (0, 1) (already exp(-exp(.))-mapped by
the caller) and the per-head bonus u. Float32 throughout, one step at a
time over every (b, h) at once; ``s0=None`` starts from zeros. Returns the
(B, H, T, N) outputs in r's dtype and the final (B, H, N, N) state in
float32.
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
    B, H, T, N = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]  # (1, H, N, 1)
    S = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device) if s0 is None
         else s0.float())
    out = torch.empty((B, H, T, N), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]  # (B, H, N, N)
        out[:, :, t] = ((S + uf * kv) * rf[:, :, t, :, None]).sum(dim=2)
        S = wf[:, :, t, :, None] * S + kv
    return out.to(r.dtype), S

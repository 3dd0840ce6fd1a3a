"""Plain PyTorch version of the RG-LRU scan kernel (any device).

Port of the reference's `rglru_scan_ref` (RecurrentGemma's gated linear
recurrence). Given the per-step log-decay ``log_a`` (<= 0) and the gated
input ``gx``, both computed by the caller:

  a_t = exp(log_a_t)
  h_t = a_t * h_{t-1} + sqrt(-expm1(2 * log_a_t)) * gx_t

in float32, one step at a time. The sqrt(1 - a^2) normaliser is taken as
sqrt(-expm1(2 log_a)) for stability at a ~ 1. Returns the (B, T, D) states
in gx's dtype and the final (B, D) state in float32. The inputs are
unbound and the states stacked, not indexed and written per step, so that
autograd through this function (the backward of the kernel's op) moves no
whole (B, T, D) buffer per step.
"""

from __future__ import annotations

from typing import Optional

import torch


def rglru_scan_ref(
    log_a: torch.Tensor,  # (B, T, D) <= 0
    gx: torch.Tensor,  # (B, T, D)
    h0: Optional[torch.Tensor] = None,  # (B, D)
):
    B, _, D = log_a.shape
    la = log_a.float()
    g = gx.float()
    h = (torch.zeros((B, D), dtype=torch.float32, device=la.device) if h0 is None
         else h0.float())
    hs = []
    for la_t, g_t in zip(la.unbind(1), g.unbind(1)):
        h = torch.exp(la_t) * h + torch.sqrt(-torch.expm1(2.0 * la_t)) * g_t
        hs.append(h)
    return torch.stack(hs, dim=1).to(gx.dtype), h

"""Public RWKV-6 scan op: the CUDA kernel on the card, plain on CPU.

Port of `repro.kernels.rwkv6_scan.ops.rwkv6_scan`: k and v are cast to r's
dtype, w, u and s0 to float32, and ``s0=None`` starts from zeros.

Inference (no input requires grad): one kernel launch covers the whole
sequence on the card, `ref.rwkv6_scan_ref` on the CPU. With ``state_out``
the final state is written into that tensor (which may be ``s0``: decode
updates its cache in place) and returned.

Training (an input requires grad): the reference's chunk-checkpointed VJP,
`RWKV6Scan`. Autograd through the per-step scan would save a (B, H, N, N)
state per step; instead the forward runs ``T // chunk`` chunks (``chunk``
the largest divisor of T up to ``DEFAULT_CHUNK``), each one launch of the
kernel on the card (the plain version on the CPU) from the previous
chunk's state, and saves the chunk-initial states. The backward walks the
chunks in reverse and recomputes each with `ref.rwkv6_scan_ref` under
autograd, from its saved state, with the output's and the carried state's
cotangents. Peak memory: one chunk's residuals plus the chunk states.

Dispatch follows r's device and nothing else; there is no fallback from
the kernel to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernel_cuda, ref

DEFAULT_CHUNK = 256


def _chunk_div(t: int, cap: int) -> int:
    for c in range(min(cap, t), 0, -1):
        if t % c == 0:
            return c
    return 1


class RWKV6Scan(torch.autograd.Function):
    """Chunk-checkpointed scan: ``forward_fn(r, k, v, w, u, s)`` runs each
    chunk (the kernel on the card), the backward recomputes each chunk with
    the plain version under autograd. Inputs already cast as `rwkv6_scan`
    casts them; s0 is a (B, H, N, N) float32 tensor."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk: int, forward_fn):
        T = r.shape[2]
        outs, states, s = [], [], s0
        for c in range(0, T, chunk):
            states.append(s)
            o, s = forward_fn(r[:, :, c : c + chunk], k[:, :, c : c + chunk],
                              v[:, :, c : c + chunk], w[:, :, c : c + chunk], u, s)
            outs.append(o)
        ctx.save_for_backward(r, k, v, w, u, *states)
        ctx.chunk = chunk
        return torch.cat(outs, dim=2), s

    @staticmethod
    def backward(ctx, d_out, d_final):
        r, k, v, w, u, *states = ctx.saved_tensors
        chunk = ctx.chunk
        grads = [torch.empty_like(t) for t in (r, k, v, w)]
        du = torch.zeros_like(u, dtype=torch.float32)
        ds = d_final
        for i in reversed(range(len(states))):
            c = i * chunk
            part = [t[:, :, c : c + chunk].detach().requires_grad_() for t in (r, k, v, w)]
            uu, s_in = u.detach().requires_grad_(), states[i].detach().requires_grad_()
            with torch.enable_grad():
                o_c, s_out = ref.rwkv6_scan_ref(*part, uu, s_in)
                g = torch.autograd.grad((o_c, s_out), (*part, uu, s_in),
                                        (d_out[:, :, c : c + chunk], ds))
            for dst, src in zip(grads, g[:4]):
                dst[:, :, c : c + chunk] = src
            du = du + g[4]
            ds = g[5]
        return (*grads, du.to(u.dtype), ds, None, None)


def rwkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    s0: Optional[torch.Tensor] = None,
    *,
    chunk: int = DEFAULT_CHUNK,
    state_out: Optional[torch.Tensor] = None,
):
    """(outputs (B, H, T, N) in r's dtype, final state (B, H, N, N) float32)."""
    k, v = k.to(r.dtype), v.to(r.dtype)
    w, u = w.float(), u.float()
    s0 = None if s0 is None else s0.float()
    kind = r.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"rwkv6_scan: unsupported device {r.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w, u, s0)
    ):
        if state_out is not None:
            raise ValueError("rwkv6_scan: state_out (decode's in-place state) takes no "
                             "gradient")
        B, H, T, N = r.shape
        if s0 is None:
            s0 = torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
        forward_fn = kernel_cuda.rwkv6_scan_cuda if kind == "cuda" else ref.rwkv6_scan_ref
        return RWKV6Scan.apply(r, k, v, w, u.contiguous(), s0, _chunk_div(T, chunk),
                               forward_fn)
    if kind == "cuda":
        return kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u.contiguous(), s0, state_out=state_out)
    out, s_final = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    if state_out is None:
        return out, s_final
    return out, state_out.copy_(s_final)

"""Error-feedback int8 gradient compression (port of
`repro.optim.compression`).

For bandwidth-bound data-parallel reductions, gradients are quantised to
int8 with a per-tensor scale before the all-reduce; the quantisation
residual is fed back into the next step's gradient (error feedback keeps
SGD convergence — Karimireddy et al. 2019).

  quantize / dequantize              - pure functions
  compressed_all_reduce(g, e, comm, axis) - the reference's
                                       ``compressed_psum``, one leaf
  compressed_all_reduce_tree         - the same over many leaves, with one
                                       max and one int32 sum for all of them

The arithmetic is the reference's source, operation for operation: the
scale ``max|g + e| / 127 + 1e-12``, the max of the scales over the axis,
requantisation against that agreed scale (round half to even, clip, then
the int8 cast), the int8 values summed as int32, then ``total * scale /
n``. Every division is by a tensor on the operand's device (on CUDA a
Python divisor is a multiply by its reciprocal) and no multiply-add is
fused, so the port gives the bits of the reference's functions run
eagerly. (Under ``jax.jit`` XLA's CPU backend rewrites ``/ 127.0`` as a
multiply by the float32 reciprocal and contracts ``max * r + 1e-12`` and
``gf - q * scale`` into FMAs, which moves the jitted reference's scale by
an ulp for some tensors.) The int8 payloads are plain torch ops on the
rank's device: the reference has no Pallas kernel for them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch

from ..models.layers import tree_map
from .adamw import leaves


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=x.device)


def _requantize(gf: torch.Tensor, scale: torch.Tensor):
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_error = gf - q.float() * scale
    return q, new_error


def quantize(g: torch.Tensor, error: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                             torch.Tensor]:
    """(int8 values, scale, new_error). g+error is quantised symmetrically."""
    gf = g.float() + error
    scale = torch.max(torch.abs(gf)) / _const(gf, 127.0) + 1e-12
    q, new_error = _requantize(gf, scale)
    return q, scale, new_error


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_all_reduce(g: torch.Tensor, error: torch.Tensor, comm, axis):
    """int8 all-reduce of one leaf with error feedback along ``axis``;
    returns (the mean over the axis, new_error)."""
    (out,), (new_error,) = compressed_all_reduce_tree([g], [error], comm, axis)
    return out, new_error


def compressed_all_reduce_tree(gs: Sequence[torch.Tensor], errors: Sequence[torch.Tensor],
                               comm, axis) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """`compressed_all_reduce` of every leaf. Scales stay per leaf; the
    leaves' scales are max-reduced as one vector and their int32 values
    summed as one buffer (the same bits as leaf by leaf: max and integer
    sums are exact)."""
    gfs = [g.float() + e for g, e in zip(gs, errors)]
    scales = torch.stack([torch.max(torch.abs(gf)) / _const(gf, 127.0) + 1e-12 for gf in gfs])
    scales = comm.all_reduce(scales, axis, op="max")
    qs, new_errors = zip(*(_requantize(gf, scales[i]) for i, gf in enumerate(gfs)))
    flat = torch.cat([q.reshape(-1).to(torch.int32) for q in qs])
    total = comm.all_reduce(flat, axis)
    n = _const(flat, float(comm.axis_size(axis)))
    out, at = [], 0
    for i, q in enumerate(qs):
        t = total[at: at + q.numel()].reshape(q.shape)
        at += q.numel()
        out.append(t.float() * scales[i] / n)
    return out, list(new_errors)


def init_error(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def payload_bytes(params: Any) -> Dict[str, int]:
    """What one sync of ``params``' gradients moves per axis: the int32
    sum, the float32 scales, against the float32 gradients."""
    n = sum(p.numel() for p in leaves(params))
    k = sum(1 for _ in leaves(params))
    return {"int32_payload": 4 * n, "scales": 4 * k, "float32_grads": 4 * n}

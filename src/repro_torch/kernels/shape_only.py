"""The recurrences as one shape-only op each, for the dry run.

`repro_torch.launch.dryrun` runs a rank's step on fake tensors
(``FakeTensorMode``), where the plain versions of the RWKV-6 and RG-LRU
scans would still loop in Python once per time step (over an hour for
rwkv6-7b at 4,096 positions). `rwkv6_scan` and `rglru_scan` there
(`kernels/*/ops.py` reach them only on fake inputs) are custom ops whose
forward and backward return outputs of the kernels' shapes and dtypes,
and whose FLOPs `FLOP_FORMULAS` gives `torch.utils.flop_counter`:

  rwkv6: 7 operations per state entry and step, B*H*T*N*N entries (the
         plain recurrence: k*v, u*kv, S + u*kv, times r, the sum over the
         key dim, w*S, + kv; `PERF.md` §6);
  rglru: 8 operations per element, B*T*D elements (2*la, expm1, negate,
         sqrt, exp, a*h, mult*gx, add; `chip_smoke.py`'s RGLRU_OPS).

A backward counts twice its forward (the cotangent of each product and
sum costs two of its forward's, the rule the counter applies to a matrix
product). Registering the ops allocates nothing and builds no kernel;
their real-tensor bodies raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

RWKV6_OPS_PER_ENTRY = 7
RGLRU_OPS_PER_ELEMENT = 8
BACKWARD_FACTOR = 2


def _fake_only(name):
    raise RuntimeError(f"repro_torch::{name} is shape-only: it runs on fake tensors alone")


# ------------------------------------------------------------------ RWKV-6


@torch.library.custom_op("repro_torch::rwkv6_scan_shape", mutates_args=())
def _rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
           u: torch.Tensor, s0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    _fake_only("rwkv6_scan_shape")


@_rwkv6.register_fake
def _(r, k, v, w, u, s0):
    B, H, _, N = r.shape
    return torch.empty_like(r), r.new_empty((B, H, N, N), dtype=torch.float32)


@torch.library.custom_op("repro_torch::rwkv6_scan_shape_grad", mutates_args=())
def _rwkv6_grad(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, s0: Optional[torch.Tensor], d_out: Optional[torch.Tensor],
                d_s: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                                      torch.Tensor, torch.Tensor, torch.Tensor]:
    _fake_only("rwkv6_scan_shape_grad")


@_rwkv6_grad.register_fake
def _(r, k, v, w, u, s0, d_out, d_s):
    B, H, _, N = r.shape
    return (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v), torch.empty_like(w),
            torch.empty_like(u), r.new_empty((B, H, N, N), dtype=torch.float32))


def _rwkv6_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs[:5])
    ctx.s0 = inputs[5]


def _rwkv6_backward(ctx, d_out, d_s):
    r, k, v, w, u = ctx.saved_tensors
    grads = _rwkv6_grad(r, k, v, w, u, ctx.s0, d_out, d_s)
    return (*grads[:5], grads[5] if ctx.s0 is not None else None)


_rwkv6.register_autograd(_rwkv6_backward, setup_context=_rwkv6_setup)


def rwkv6_scan(r, k, v, w, u, s0=None, state_out=None):
    """`kernels.rwkv6_scan.ops.rwkv6_scan` on fake inputs (k, v in r's
    dtype, w, u, s0 float32): (outputs, final state), the state written
    into ``state_out`` where given."""
    out, s = _rwkv6(r, k, v, w, u, s0)
    return out, s if state_out is None else state_out.copy_(s)


def _rwkv6_flops(r, *_, out_shape=None, **__) -> int:
    B, H, T, N = r
    return RWKV6_OPS_PER_ENTRY * B * H * T * N * N


# ------------------------------------------------------------------ RG-LRU


@torch.library.custom_op("repro_torch::rglru_scan_shape", mutates_args=())
def _rglru(log_a: torch.Tensor, gx: torch.Tensor,
           h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    _fake_only("rglru_scan_shape")


@_rglru.register_fake
def _(log_a, gx, h0):
    B, _, D = gx.shape
    return torch.empty_like(gx), gx.new_empty((B, D), dtype=torch.float32)


@torch.library.custom_op("repro_torch::rglru_scan_shape_grad", mutates_args=())
def _rglru_grad(log_a: torch.Tensor, gx: torch.Tensor, h0: Optional[torch.Tensor],
                d_out: Optional[torch.Tensor], d_h: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _fake_only("rglru_scan_shape_grad")


@_rglru_grad.register_fake
def _(log_a, gx, h0, d_out, d_h):
    B, _, D = gx.shape
    return (torch.empty_like(log_a), torch.empty_like(gx),
            gx.new_empty((B, D), dtype=torch.float32))


def _rglru_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], inputs[1])
    ctx.h0 = inputs[2]


def _rglru_backward(ctx, d_out, d_h):
    log_a, gx = ctx.saved_tensors
    d_la, d_gx, d_h0 = _rglru_grad(log_a, gx, ctx.h0, d_out, d_h)
    return d_la, d_gx, d_h0 if ctx.h0 is not None else None


_rglru.register_autograd(_rglru_backward, setup_context=_rglru_setup)


def rglru_scan(log_a, gx, h0=None):
    """`kernels.rglru_scan.ops.rglru_scan` on fake inputs: (states,
    final state)."""
    return _rglru(log_a, gx, h0)


def _rglru_flops(log_a, *_, out_shape=None, **__) -> int:
    B, T, D = log_a
    return RGLRU_OPS_PER_ELEMENT * B * T * D


def _backward(forward):
    def flops(*args, **kwargs) -> int:
        return BACKWARD_FACTOR * forward(*args, **kwargs)
    return flops


# `FlopCounterMode(custom_mapping=FLOP_FORMULAS)`: the ops' FLOPs from
# their inputs' shapes.
FLOP_FORMULAS = {
    torch.ops.repro_torch.rwkv6_scan_shape: _rwkv6_flops,
    torch.ops.repro_torch.rwkv6_scan_shape_grad: _backward(_rwkv6_flops),
    torch.ops.repro_torch.rglru_scan_shape: _rglru_flops,
    torch.ops.repro_torch.rglru_scan_shape_grad: _backward(_rglru_flops),
}

"""ctypes wrappers of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward (``csrc/flash_attention_bwd.cu``).

The forward replaces `repro.kernels.flash_attention.kernel.flash_attention_pallas`;
the backward replaces no TPU kernel (a `pallas_call` has no VJP). Each
source's header states its bound on the card and the tiling. The wrappers
validate their inputs (q, k, v may be strided views, such as the heads split
out of a projection, as long as the last dimension is contiguous), allocate
contiguous outputs in q's dtype, launch on the current stream and raise if
a launch was refused. ``flash_attention_cuda.launches`` counts forward
launches, ``flash_attention_backward_cuda.launches`` backward calls (each a
set of launches: Δ, dQ, dK/dV).

The kernel is compiled for the head_dims in ``HEAD_DIMS``. Any other
head_dim up to 256 runs on it zero-padded to the next of them, with the
scale kept at 1/sqrt of the original: zero columns change neither Q K^T
nor the output columns that are kept, which are sliced back. The kernel
copies K/V tiles in 16-byte `cp.async` chunks, so a view whose data pointer
or batch, head or sequence stride is not a multiple of 16 bytes is copied
to contiguous storage first.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p, p, i, i, i, i, i, i] + [ll] * 9 + [ctypes.c_float, i, p]
    )
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _bind_bwd(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib.flash_attention_bwd_launch.argtypes = (
        [p] * 10 + [i] * 6 + [ll] * 9 + [ctypes.c_float, i, p]
    )
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p


def _check(t: torch.Tensor, name: str, device, dtype) -> None:
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {dtype}")
    if t.dim() != 4:
        raise ValueError(f"flash_attention: {name} must be 4-D, got {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {name}'s last dimension must be contiguous")


def aligned(t: torch.Tensor) -> bool:
    """Whether ``t``'s data pointer and its batch, head and sequence strides
    (those of dimensions longer than 1) are multiples of 16 bytes."""
    esize = t.element_size()
    strides = [s * esize for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return not (t.data_ptr() % 16 or any(s % 16 for s in strides))


def flash_attention_cuda(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KVH, S, D)
    v: torch.Tensor,  # (B, KVH, S, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """(B, H, S, D) in q's dtype; with ``return_lse`` also each row's
    log-sum-exp of the scaled logits, (B, H, S) float32, for the backward."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, device, q.dtype)
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if k.shape != (B, KVH, S, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention: {H} heads do not group over {KVH} KV heads")
    if D > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head_dim {D} is above the largest the kernel "
                         f"takes, {HEAD_DIMS[-1]}")
    if scale is None:
        scale = 1.0 / (D**0.5)
    if D not in HEAD_DIMS and q.numel() and k.numel():
        q, k, v = _pad_head_dim(D, q, k, v)
        res = flash_attention_cuda(q, k, v, causal=causal, scale=scale, return_lse=return_lse)
        if return_lse:
            return res[0][..., :D].contiguous(), res[1]
        return res[..., :D].contiguous()
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    q, k, v = (t if aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    lib = build.load(SOURCE, _bind)
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, DTYPES[q.dtype],
            B, H, KVH, S, D, *strides, float(scale), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(rc).decode()} "
            f"({rc})"
        )
    flash_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def _pad_head_dim(D: int, *ts: torch.Tensor):
    """``ts`` zero-padded in the last dimension to the next of HEAD_DIMS."""
    Dp = next(d for d in HEAD_DIMS if d > D)
    return tuple(torch.nn.functional.pad(t, (0, Dp - D)) for t in ts)


def flash_attention_backward_cuda(
    do: torch.Tensor,  # (B, H, S, D): the output's gradient
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KVH, S, D)
    v: torch.Tensor,  # (B, KVH, S, D)
    o: torch.Tensor,  # (B, H, S, D): the forward's output
    lse: torch.Tensor,  # (B, H, S) float32: the forward's log-sum-exp
    *,
    causal: bool = True,
    scale: Optional[float] = None,
):  # (dq, dk, dv) in q's dtype, contiguous
    """The gradients of `flash_attention_cuda` with respect to q, k and v,
    from its saved output and log-sum-exp; no (B, H, S, S) tensor is formed.
    A head_dim that is not in HEAD_DIMS is zero-padded as the forward pads
    it (zero columns add nothing to any product, and the padded gradients
    are sliced off)."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention_backward_cuda needs CUDA tensors, got {device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(t, name, device, q.dtype)
    for t, name in ((o, "o"), (do, "do")):  # copied to contiguous storage below
        if t.device != device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention backward: {name} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {device}")
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if k.shape != (B, KVH, S, D) or v.shape != k.shape or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError(f"flash_attention backward: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} do not match")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or lse.device != device:
        raise ValueError(f"flash_attention backward: lse must be float32 {(B, H, S)} on "
                         f"{device}, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if KVH == 0 or H % KVH:
        raise ValueError(f"flash_attention: {H} heads do not group over {KVH} KV heads")
    if D > HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention: head_dim {D} is above the largest the kernel "
                         f"takes, {HEAD_DIMS[-1]}")
    if scale is None:
        scale = 1.0 / (D**0.5)
    if D not in HEAD_DIMS and q.numel() and k.numel():
        grads = flash_attention_backward_cuda(*_pad_head_dim(D, do, q, k, v, o), lse,
                                              causal=causal, scale=scale)
        return tuple(t[..., :D].contiguous() for t in grads)
    dq = torch.empty((B, H, S, D), dtype=q.dtype, device=device)
    dk = torch.empty((B, KVH, S, D), dtype=q.dtype, device=device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v = (t if aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
    delta = torch.empty((B, H, S), dtype=torch.float32, device=device)
    lib = build.load(BWD_SOURCE, _bind_bwd)
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPES[q.dtype], B, H, KVH, S, D, *strides, float(scale), int(bool(causal)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention backward launch failed: "
            f"{lib.flash_attention_bwd_error_string(rc).decode()} ({rc})"
        )
    flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


flash_attention_backward_cuda.launches = 0

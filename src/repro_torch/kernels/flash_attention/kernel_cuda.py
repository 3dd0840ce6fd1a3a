"""ctypes wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces `repro.kernels.flash_attention.kernel.flash_attention_pallas`. The
source's header states its bound on the card and the tiling. The wrapper
validates its inputs (q, k, v may be strided views, such as the heads split
out of a projection, as long as the last dimension is contiguous), allocates
the contiguous (B, H, S, D) output in q's dtype, launches on the current
stream and raises if the launch was refused.
``flash_attention_cuda.launches`` counts launches.

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
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    ll = ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [p, p, p, p, i, i, i, i, i, i] + [ll] * 9 + [ctypes.c_float, i, p]
    )
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


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
) -> torch.Tensor:  # (B, H, S, D) in q's dtype
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
        Dp = next(d for d in HEAD_DIMS if d > D)
        q, k, v = (torch.nn.functional.pad(t, (0, Dp - D)) for t in (q, k, v))
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)[..., :D].contiguous()
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    q, k, v = (t if aligned(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    lib = build.load(SOURCE, _bind)
    strides = [t.stride(i) for t in (q, k, v) for i in range(3)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
            B, H, KVH, S, D, *strides, float(scale), int(bool(causal)), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash_attention launch failed: {lib.flash_attention_error_string(rc).decode()} "
            f"({rc})"
        )
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0

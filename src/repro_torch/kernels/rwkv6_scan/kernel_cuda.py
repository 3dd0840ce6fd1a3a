"""ctypes wrapper of the CUDA RWKV-6 scan kernel (``csrc/rwkv6_scan.cu``).

Replaces `repro.kernels.rwkv6_scan.kernel.rwkv6_scan_pallas`. The source's
header states its bound on the card and the design. The wrapper validates
its inputs (r, k, v of one dtype and w float32, each (B, H, T, N) and
possibly a strided view, such as the heads split out of a projection, with
a contiguous last dimension; u (H, N) and s0 (B, H, N, N) contiguous
float32), allocates the contiguous (B, H, T, N) output in r's dtype,
launches on the current stream and raises if the launch was refused. The
launch refuses a view whose pointer or batch, head or time stride is not
a multiple of 16 bytes (the kernel's copies need them) with
cudaErrorMisalignedAddress before anything runs; the wrapper then copies
such views and launches again. Any T, 1 included: the
reference kernel's ``T % block_t`` assertion is not copied.

The final state goes to ``state_out`` when it is given (a contiguous
(B, H, N, N) float32 tensor, which may be ``s0`` itself: the kernel reads
each part of the state before writing it, so decode updates its cache in
place), else to a new tensor. ``rwkv6_scan_cuda.launches`` counts
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build
from ..flash_attention.kernel_cuda import aligned

SOURCE = "rwkv6_scan.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MISALIGNED = 716  # cudaErrorMisalignedAddress: a view the copies cannot read as it is
HEAD_DIMS = (16, 32, 64)


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = [p] * 8 + [i] * 5 + [ctypes.POINTER(ctypes.c_longlong), p]
    lib.rwkv6_scan_launch.restype = ctypes.c_int
    lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_error_string.restype = ctypes.c_char_p


def _check_state(t: torch.Tensor, name: str, shape, device) -> None:
    if (t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"rwkv6_scan: {name} must be a contiguous {shape} float32 tensor "
                         f"on {device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def rwkv6_scan_cuda(
    r: torch.Tensor,  # (B, H, T, N)
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,  # (B, H, T, N) float32 decay in (0, 1)
    u: torch.Tensor,  # (H, N) float32
    s0: Optional[torch.Tensor] = None,  # (B, H, N, N) float32
    *,
    state_out: Optional[torch.Tensor] = None,
):
    """(outputs (B, H, T, N) in r's dtype, final state (B, H, N, N) float32)."""
    device = r.device
    if device.type != "cuda":
        raise ValueError(f"rwkv6_scan_cuda needs CUDA tensors, got {device}")
    if r.dtype not in DTYPES:
        raise TypeError(f"rwkv6_scan: unsupported dtype {r.dtype}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r must be 4-D, got {tuple(r.shape)}")
    B, H, T, N = r.shape
    for t, name, dtype in ((k, "k", r.dtype), (v, "v", r.dtype), (w, "w", torch.float32)):
        if t.device != device:
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"rwkv6_scan: {name} is {t.dtype}, expected {dtype}")
        if t.shape != r.shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} does not match r "
                             f"{tuple(r.shape)}")
    if N not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head size {N} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("rwkv6_scan: the last dimension of r, k, v, w must be contiguous")
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"rwkv6_scan: empty shape {tuple(r.shape)}")
    _check_state(u, "u", (H, N), device)
    if s0 is not None:
        _check_state(s0, "s0", (B, H, N, N), device)
    if state_out is None:
        state_out = torch.empty((B, H, N, N), dtype=torch.float32, device=device)
    else:
        _check_state(state_out, "state_out", (B, H, N, N), device)
    out = torch.empty((B, H, T, N), dtype=r.dtype, device=device)
    lib = build.load(SOURCE, _bind)

    def launch(r, k, v, w):
        strides = (ctypes.c_longlong * 12)(*[t.stride(i) for t in (r, k, v, w) for i in range(3)])
        return lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if s0 is None else s0.data_ptr(), out.data_ptr(), state_out.data_ptr(),
            DTYPES[r.dtype], B, H, T, N, strides, stream,
        )

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = launch(r, k, v, w)
        if rc == MISALIGNED:  # checked in the launch, off the common path
            rc = launch(*(t if aligned(t) else t.clone(memory_format=torch.contiguous_format)
                          for t in (r, k, v, w)))
    if rc != 0:
        raise RuntimeError(
            f"rwkv6_scan launch failed: {lib.rwkv6_scan_error_string(rc).decode()} ({rc})"
        )
    rwkv6_scan_cuda.launches += 1
    return out, state_out


rwkv6_scan_cuda.launches = 0

"""ctypes wrapper of the CUDA costmap kernel (``csrc/costmap.cu``).

Replaces `repro.kernels.costmap.kernel.costmap_pallas`. The source's header
states its bound on the card and what the design does about it. The
wrapper validates its inputs, allocates the output, launches on the current
stream and raises if the launch was refused. ``costmap_cuda.launches``
counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "costmap.cu"


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.costmap_launch.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.costmap_launch.restype = ctypes.c_int
    lib.costmap_error_string.argtypes = [ctypes.c_int]
    lib.costmap_error_string.restype = ctypes.c_char_p


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"costmap: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"costmap: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"costmap: {name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"costmap: {name} must be contiguous")


def costmap_cuda(
    lut_table: torch.Tensor,  # (n_models, LUT_SIZE) f32
    perf_idx: torch.Tensor,  # (T,) int32
    latency_us: torch.Tensor,  # (T, M) f32
) -> torch.Tensor:  # (T, M) int32
    device = latency_us.device
    if device.type != "cuda":
        raise ValueError(f"costmap_cuda needs CUDA tensors, got {device}")
    _check(lut_table, "lut_table", torch.float32, 2, device)
    _check(perf_idx, "perf_idx", torch.int32, 1, device)
    _check(latency_us, "latency_us", torch.float32, 2, device)
    T, M = latency_us.shape
    if perf_idx.shape[0] != T:
        raise ValueError(f"costmap: perf_idx has {perf_idx.shape[0]} rows, latency {T}")
    if lut_table.numel() > 1024:
        raise ValueError("costmap: the kernel holds at most 1024 table entries")
    if T * M >= 2**31 - 1024:
        raise ValueError(f"costmap: {T}x{M} exceeds the kernel's 32-bit offsets")
    out = torch.empty((T, M), dtype=torch.int32, device=device)
    if T * M == 0:
        return out
    lib = build.load(SOURCE, _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.costmap_launch(
            perf_idx.data_ptr(), latency_us.data_ptr(), lut_table.data_ptr(),
            out.data_ptr(), T, M, lut_table.shape[0], lut_table.shape[1], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"costmap launch failed: {lib.costmap_error_string(rc).decode()} ({rc})"
        )
    costmap_cuda.launches += 1
    return out


costmap_cuda.launches = 0

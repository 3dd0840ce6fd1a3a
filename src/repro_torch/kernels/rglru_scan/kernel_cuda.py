"""ctypes wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

Replaces `repro.kernels.rglru_scan.kernel.rglru_scan_pallas`. The source's
header states its bound on the card and the design. The wrapper validates
its inputs (log_a and gx contiguous (B, T, D) of one dtype, h0 an optional
(B, D) float32 state), allocates the (B, T, D) states in gx's dtype and the
(B, D) float32 final state, launches on the current stream and raises if
the launch was refused. Any T and D: the reference kernel's
``T % block_t`` / ``D % block_d`` assertion is not copied.
``rglru_scan_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import build

SOURCE = "rglru_scan.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.rglru_scan_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p


def rglru_scan_cuda(
    log_a: torch.Tensor,  # (B, T, D)
    gx: torch.Tensor,  # (B, T, D)
    h0: Optional[torch.Tensor] = None,  # (B, D) float32
):
    """(states (B, T, D) in gx's dtype, final state (B, D) float32)."""
    device = gx.device
    if device.type != "cuda":
        raise ValueError(f"rglru_scan_cuda needs CUDA tensors, got {device}")
    if log_a.device != device:
        raise ValueError(f"rglru_scan: log_a is on {log_a.device}, gx on {device}")
    if gx.dtype not in DTYPES or log_a.dtype != gx.dtype:
        raise TypeError(f"rglru_scan: log_a {log_a.dtype} and gx {gx.dtype} must share "
                        f"one of {list(DTYPES)}")
    if gx.dim() != 3 or log_a.shape != gx.shape:
        raise ValueError(f"rglru_scan: log_a {tuple(log_a.shape)} and gx "
                         f"{tuple(gx.shape)} must be the same (B, T, D)")
    if not (log_a.is_contiguous() and gx.is_contiguous()):
        raise ValueError("rglru_scan: log_a and gx must be contiguous")
    B, T, D = gx.shape
    if h0 is not None and (h0.device != device or h0.dtype != torch.float32
                           or h0.shape != (B, D) or not h0.is_contiguous()):
        raise ValueError(f"rglru_scan: h0 must be a contiguous ({B}, {D}) float32 "
                         f"tensor on {device}")
    if gx.numel() == 0:
        raise ValueError(f"rglru_scan: empty shape {tuple(gx.shape)}")
    out = torch.empty((B, T, D), dtype=gx.dtype, device=device)
    h_final = torch.empty((B, D), dtype=torch.float32, device=device)
    lib = build.load(SOURCE, _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.rglru_scan_launch(
            log_a.data_ptr(), gx.data_ptr(), None if h0 is None else h0.data_ptr(),
            out.data_ptr(), h_final.data_ptr(), DTYPES[gx.dtype], B, T, D, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"rglru_scan launch failed: {lib.rglru_scan_error_string(rc).decode()} ({rc})"
        )
    rglru_scan_cuda.launches += 1
    return out, h_final


rglru_scan_cuda.launches = 0

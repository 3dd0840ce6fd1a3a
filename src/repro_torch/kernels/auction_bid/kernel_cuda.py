"""ctypes wrapper of the CUDA auction-bid kernel (``csrc/auction_bid.cu``).

Replaces `repro.kernels.auction_bid.kernel.bid_top2_pallas`. The source's
header states the merge that makes it equal to the reference (index
included), its bound on the card, and the chunked design. The wrapper picks
the column chunking, validates inputs, allocates outputs and scratch,
launches on the current stream and raises if the launch was refused.
``bid_top2_cuda.launches`` counts calls that launched.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import build

SOURCE = "auction_bid.cu"
_MIN_CHUNK = 256  # one column per thread of a 256-thread CTA
_CTAS_PER_SM = 4


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.bid_top2_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
    lib.bid_top2_launch.restype = ctypes.c_int
    lib.bid_top2_error_string.argtypes = [ctypes.c_int]
    lib.bid_top2_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def chunk_columns(T: int, C: int, n_sms: int) -> int:
    """Columns per CTA: enough chunks that T rows fill ~4 CTAs per SM, but
    no chunk narrower than one column per thread."""
    target = max(1, -(-_CTAS_PER_SM * n_sms // T))
    n_chunks = max(1, min(target, -(-C // _MIN_CHUNK)))
    return -(-C // n_chunks)


def _check(t: torch.Tensor, name: str, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"bid_top2: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"bid_top2: {name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"bid_top2: {name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"bid_top2: {name} must be contiguous")


def bid_top2_cuda(values, price1, price2, *, chunk_cols: int | None = None):
    """(best_idx i32, best_val f32, second_val f32) per row; see ref.py.

    Requires price2 >= price1 per column (the auction's slot prices always
    satisfy it). ``chunk_cols`` overrides the column chunking (tests).
    """
    device = values.device
    if device.type != "cuda":
        raise ValueError(f"bid_top2_cuda needs CUDA tensors, got {device}")
    _check(values, "values", 2, device)
    _check(price1, "price1", 1, device)
    _check(price2, "price2", 1, device)
    T, C = values.shape
    if price1.shape[0] != C or price2.shape[0] != C:
        raise ValueError(f"bid_top2: prices must have {C} columns")
    if T == 0 or C == 0 or T > 65535 or T * C >= 2**31:
        raise ValueError(f"bid_top2: unsupported shape ({T}, {C})")
    if chunk_cols is None:
        chunk_cols = chunk_columns(T, C, _sm_count(device.index or 0))
    n_chunks = -(-C // chunk_cols)
    idx = torch.empty(T, dtype=torch.int32, device=device)
    best = torch.empty(T, dtype=torch.float32, device=device)
    second = torch.empty(T, dtype=torch.float32, device=device)
    part = torch.empty(3 * T * n_chunks if n_chunks > 1 else 1, dtype=torch.int32,
                       device=device)
    lib = build.load(SOURCE, _bind)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.bid_top2_launch(
            values.data_ptr(), price1.data_ptr(), price2.data_ptr(), idx.data_ptr(),
            best.data_ptr(), second.data_ptr(), part.data_ptr(), T, C, chunk_cols,
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"bid_top2 launch failed: {lib.bid_top2_error_string(rc).decode()} ({rc})"
        )
    bid_top2_cuda.launches += 1
    return idx, best, second


bid_top2_cuda.launches = 0

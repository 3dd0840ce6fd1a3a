"""ctypes wrapper of the persistent CUDA auction-phase kernel
(``csrc/auction_phase.cu``).

Replaces `repro.kernels.auction_bid.kernel.bid_top2_pallas` together with
the ``jax.lax.while_loop`` of `repro.core.auction.auction_phase_step`
around it: the whole Jacobi phase is one cooperative launch, and the host
reads the result once. The source's header states what it computes, its
bound on the card and the design. The wrapper validates its inputs,
allocates the outputs and the workspace, launches on the current stream and
raises if the launch was refused, including where the grid cannot be
co-resident; it never falls back to the step-wise loop.
``auction_phase_cuda.launches`` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build

SOURCE = "auction_phase.cu"


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.auction_phase_max_ctas.argtypes = []
    lib.auction_phase_max_ctas.restype = i
    lib.auction_phase_default_ctas.argtypes = [i, i, i]
    lib.auction_phase_default_ctas.restype = i
    lib.auction_phase_workspace_bytes.argtypes = [i, i, i]
    lib.auction_phase_workspace_bytes.restype = ctypes.c_size_t
    lib.auction_phase_launch.argtypes = [p] * 10 + [i, i, i, ctypes.c_float, i, i, p]
    lib.auction_phase_launch.restype = i
    lib.auction_phase_error_string.argtypes = [i]
    lib.auction_phase_error_string.restype = ctypes.c_char_p


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"auction_phase: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"auction_phase: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"auction_phase: {name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"auction_phase: {name} must be contiguous")


def max_ctas(device=None) -> int:
    """CTAs of the kernel that can be co-resident on ``device``'s card."""
    lib = build.load(SOURCE, _bind)
    with torch.cuda.device(device):
        n = lib.auction_phase_max_ctas()
    if n <= 0:
        raise RuntimeError("auction_phase: the occupancy query failed")
    return n


def auction_phase_cuda(price0, values_m, value_u, job_col, active, eps: float,
                       max_iters: int, *, ctas: int | None = None,
                       return_bidder_rows: bool = False, stats_on_device: bool = False):
    """(price (M, S) f32, owner (M, S) i32, assigned (Tp,) i32, iters int),
    as `ref.auction_phase_ref`; with ``return_bidder_rows`` a fifth value,
    the bidder rows summed over the iterations.

    ``ctas`` overrides the kernel's grid (a grid that cannot be co-resident
    is refused; a full grid on a small instance times the barriers).
    ``stats_on_device`` leaves the counts on the card: ``iters`` (and the
    bidder rows) come back as 0-dim int64 CUDA tensors and the call does not
    wait for the kernel, so a caller that launches several solves reads all
    their counts at once.
    """
    device = values_m.device
    if device.type != "cuda":
        raise ValueError(f"auction_phase_cuda needs CUDA tensors, got {device}")
    if values_m.dim() != 2 or price0.dim() != 2:
        raise ValueError("auction_phase: values_m and price0 must be 2-D")
    Tp, M = values_m.shape
    S = price0.shape[1]
    _check(values_m, "values_m", torch.float32, (Tp, M), device)
    _check(price0, "price0", torch.float32, (M, S), device)
    _check(value_u, "value_u", torch.float32, (Tp,), device)
    _check(job_col, "job_col", torch.int32, (Tp,), device)
    _check(active, "active", torch.bool, (Tp,), device)
    if Tp == 0 or M == 0 or S == 0:
        raise ValueError(f"auction_phase: empty shape (Tp, M, S) = ({Tp}, {M}, {S})")
    eps32 = ctypes.c_float(float(eps))
    if not eps32.value > 0:
        raise ValueError(f"auction_phase: eps must be > 0 (bids are ordered by their bits), "
                         f"got {eps}")
    lib = build.load(SOURCE, _bind)
    with torch.cuda.device(device):
        if ctas is None:
            ctas = lib.auction_phase_default_ctas(Tp, M, max_ctas(device))
        price = torch.empty((M, S), dtype=torch.float32, device=device)
        owner = torch.empty((M, S), dtype=torch.int32, device=device)
        assigned = torch.empty((Tp,), dtype=torch.int32, device=device)
        stats = torch.empty((2,), dtype=torch.int64, device=device)
        work = torch.empty(lib.auction_phase_workspace_bytes(Tp, M, ctas), dtype=torch.uint8,
                           device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.auction_phase_launch(
            price0.data_ptr(), values_m.data_ptr(), value_u.data_ptr(), job_col.data_ptr(),
            active.data_ptr(), price.data_ptr(), owner.data_ptr(), assigned.data_ptr(),
            stats.data_ptr(), work.data_ptr(), Tp, M, S, eps32,
            min(int(max_iters), 2**31 - 1), ctas, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"auction_phase launch failed: {lib.auction_phase_error_string(rc).decode()} "
            f"({rc}; grid of {ctas} CTAs)"
        )
    auction_phase_cuda.launches += 1
    if stats_on_device:
        iters, bidder_rows = stats[0], stats[1]
    else:
        iters, bidder_rows = stats.tolist()  # the one read of the launch's result
    out = (price, owner, assigned, iters)
    return out + (bidder_rows,) if return_bidder_rows else out


auction_phase_cuda.launches = 0

"""Hand-written CUDA kernels for the port's hot spots (Hopper, sm_90a).

Each kernel package has:
  kernel_cuda.py - ctypes wrapper of the CUDA C++ source in ``csrc/``,
                   with a launch counter (``<wrapper>.launches``)
  ops.py         - dispatch: CUDA tensor -> kernel, CPU tensor -> plain version
  ref.py         - the plain PyTorch version (any device)

  costmap      - fused latency -> LUT perf -> integer arc cost (Eq. 6);
                 replaces repro.kernels.costmap.kernel.costmap_pallas
  auction_bid  - per-row top-2 bid of the auction solver; replaces
                 repro.kernels.auction_bid.kernel.bid_top2_pallas (the
                 step-wise loop's bid; off the card's main path)
  auction_phase - the auction's whole Jacobi phase, the bid fused with the
                 loop, in one persistent cooperative launch per solve;
                 replaces bid_top2_pallas with the reference's while_loop
                 (repro.core.auction.auction_phase_step)
  flash_attention  - blocked causal GQA attention (LM prefill); replaces
                 repro.kernels.flash_attention.kernel.flash_attention_pallas;
                 its backward (``flash_attention_bwd``, training) replaces
                 no TPU kernel: a pallas_call has no VJP
  decode_attention - one-token GQA attention against a KV cache (LM
                 decode); replaces
                 repro.kernels.decode_attention.kernel.decode_attention_pallas
  rglru_scan   - RecurrentGemma's RG-LRU diagonal recurrence (the rec
                 block's prefill); replaces
                 repro.kernels.rglru_scan.kernel.rglru_scan_pallas
  rwkv6_scan   - the RWKV-6 N x N state recurrence (the rwkv block's
                 prefill and decode); replaces
                 repro.kernels.rwkv6_scan.kernel.rwkv6_scan_pallas

`build` compiles the sources with nvcc on first use.
"""

from .auction_bid.kernel_cuda import bid_top2_cuda
from .auction_phase.kernel_cuda import auction_phase_cuda
from .costmap.kernel_cuda import costmap_cuda
from .decode_attention.kernel_cuda import decode_attention_cuda
from .flash_attention.kernel_cuda import flash_attention_backward_cuda, flash_attention_cuda
from .rglru_scan.kernel_cuda import rglru_scan_cuda
from .rwkv6_scan.kernel_cuda import rwkv6_scan_cuda

#: (name, wrapper, CUDA source) of every kernel of the port: the scheduling
#: path's (the bid, then the phase that fuses it with the loop), the LM
#: path's attention kernels (flash's backward for training), then the
#: recurrent blocks' scans.
KERNELS = (
    ("costmap", costmap_cuda, "costmap.cu"),
    ("auction_bid", bid_top2_cuda, "auction_bid.cu"),
    ("auction_phase", auction_phase_cuda, "auction_phase.cu"),
    ("flash_attention", flash_attention_cuda, "flash_attention.cu"),
    ("flash_attention_bwd", flash_attention_backward_cuda, "flash_attention_bwd.cu"),
    ("decode_attention", decode_attention_cuda, "decode_attention.cu"),
    ("rglru_scan", rglru_scan_cuda, "rglru_scan.cu"),
    ("rwkv6_scan", rwkv6_scan_cuda, "rwkv6_scan.cu"),
)


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn, _ in KERNELS}


def decode_lse_launches() -> int:
    """Those of decode_attention's launches that also wrote each row's
    log-sum-exp (a cache whose sequence is split over ranks)."""
    return decode_attention_cuda.lse_launches


def reset_launch_counts() -> None:
    for _, fn, _ in KERNELS:
        fn.launches = 0
    decode_attention_cuda.lse_launches = 0

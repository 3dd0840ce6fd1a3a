"""NoMora scheduler in PyTorch, with hand-written CUDA kernels for Hopper.

A port of the JAX package `repro` (which stays the reference): the same
modules under the same names, checked against it on the same inputs by
``tests/test_torch_*.py``. Host modules stay numpy; the scheduling round
(costmap, rack reduce, thresholds, auction) runs as torch tensor code on an
explicit ``device``, with its hot spots as CUDA C++ kernels built at first
use (`repro_torch.kernels`).

Layout:
  core/         topology, perf_model, latency, latency_device, workload,
                trace, policy, auction, flow_network, mcmf, round_program,
                scheduler_backend, engine, metrics, metrics_stream,
                scenarios, simulator, reference_sim, serving, sweep
  kernels/      costmap, auction_bid, auction_phase, attention, scans: kernel
                wrapper + plain version + dispatch
  csrc/         the CUDA C++ sources, compiled for sm_90a by nvcc
  obs/          telemetry spans and counters, Chrome-trace and audit export
  distributed/  straggler detection
  convert.py    reference objects -> port objects (duck-typed)

Importing this package imports neither jax nor `repro`.
"""

from .device import resolve_device  # noqa: F401

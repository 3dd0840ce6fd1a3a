"""Plain PyTorch version of the costmap kernel (any device).

cost(t, m) = round2sig(1 / p_{model(t)}(round10(latency(t, m)))) * 100,
exactly as `repro_torch.core.perf_model` defines it (paper Eq. 6, §5.2
rounding, §6 10us LUT discretisation). Bit-identical to the reference's
`costmap_ref` and to ``csrc/costmap.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.core import perf_model


def costmap_ref(
    lut_table: torch.Tensor,  # (n_models, LUT_SIZE) f32
    perf_idx: torch.Tensor,  # (T,) int32
    latency_us: torch.Tensor,  # (T, M) f32
) -> torch.Tensor:  # (T, M) int32
    perf = perf_model.lookup_perf(lut_table, perf_idx[:, None], latency_us)
    return perf_model.perf_to_cost(perf)

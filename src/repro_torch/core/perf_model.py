"""Application performance prediction functions dependent upon network latency.

Port of `repro.core.perf_model` (paper §3, Eqs. 2-5): each application has
a piecewise model — constant 1.0 below a threshold latency, and a fitted
polynomial above it. Predictions are discretised in 10 us steps into a
(4, 101) float32 lookup table; costs follow §5.2, ``round(10/p) * 10``.

Bit-identity with the reference: the table is evaluated in float32 on the
CPU with the powers written as repeated multiplies (``x*x``,
``x*(x*x)``), which is what jax's ``integer_pow`` computes, and each
coefficient is rounded to float32 before the multiply, as jax's weak-typed
scalars are. ``torch.pow`` would round differently.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

LATENCY_MIN_US = 0.0
LATENCY_MAX_US = 1000.0
LUT_STEP_US = 10.0  # paper §6: predictions discretised in steps of 10us
LUT_SIZE = int(LATENCY_MAX_US / LUT_STEP_US) + 1  # 0, 10, ..., 1000


def _int_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x**k by binary exponentiation, multiply for multiply like jax's
    ``integer_pow`` (k=2: x*x; k=3: x*(x*x))."""
    if k == 0:
        return torch.ones_like(x)
    acc = None
    base = x
    while k:
        if k & 1:
            acc = base if acc is None else acc * base
        k >>= 1
        if k:
            base = base * base
    return acc


@dataclasses.dataclass(frozen=True)
class PerfModel:
    """Piecewise performance model: 1.0 below `threshold_us`, poly above.

    ``coeffs`` are polynomial coefficients in ascending order, applied to
    latency in microseconds.
    """

    name: str
    threshold_us: float
    coeffs: tuple

    def __call__(self, latency_us):
        return self.evaluate(latency_us)

    def evaluate(self, latency_us) -> torch.Tensor:
        """Normalised performance in (0, 1] for latency in us (float32, CPU)."""
        x = torch.as_tensor(latency_us, dtype=torch.float32)
        xc = torch.clamp(x, LATENCY_MIN_US, LATENCY_MAX_US)
        poly = torch.zeros_like(xc)
        for k, c in enumerate(self.coeffs):
            poly = poly + torch.tensor(c, dtype=torch.float32) * _int_pow(xc, k)
        out = torch.where(xc < self.threshold_us, torch.ones_like(poly), poly)
        return torch.clamp(out, 1e-2, 1.0)

    def lut(self) -> torch.Tensor:
        """Discretised predictions: perf at 0, 10, ..., 1000 us."""
        grid = torch.arange(LUT_SIZE, dtype=torch.float32) * LUT_STEP_US
        return self.evaluate(grid)


# --- Paper Eqs. 2-5 (coefficients verbatim) --------------------------------

MEMCACHED = PerfModel(
    name="memcached",
    threshold_us=40.0,
    coeffs=(1.067, -3.093e-3, 4.084e-6, -1.898e-9),  # Eq. 2
)

STRADS = PerfModel(
    name="strads",
    threshold_us=20.0,
    coeffs=(1.009, -2.095e-3, 2.571e-6, -1.232e-9),  # Eq. 3
)

SPARK = PerfModel(
    name="spark",
    threshold_us=200.0,
    coeffs=(1.0199, -1.161e-4),  # Eq. 4 (linear)
)

TENSORFLOW = PerfModel(
    name="tensorflow",
    threshold_us=40.0,
    coeffs=(1.005, -5.146e-4, 5.837e-7, -3.46e-10),  # Eq. 5
)

APP_MODELS: Dict[str, PerfModel] = {
    m.name: m for m in (MEMCACHED, STRADS, SPARK, TENSORFLOW)
}
APP_MODEL_LIST: Sequence[PerfModel] = (MEMCACHED, STRADS, SPARK, TENSORFLOW)
APP_MODEL_INDEX: Dict[str, int] = {m.name: i for i, m in enumerate(APP_MODEL_LIST)}


def perf_lut_table() -> torch.Tensor:
    """(n_models, LUT_SIZE) float32 CPU table, row per model."""
    return torch.stack([m.lut() for m in APP_MODEL_LIST], dim=0)


def lookup_perf(lut_table: torch.Tensor, model_idx, latency_us) -> torch.Tensor:
    """Discretised performance lookup (paper §6 hash-table semantics).

    ``latency_us`` is rounded half-to-even to the nearest 10us step and
    clipped to the table; ``model_idx`` selects the row. Both broadcast.
    The divisor is a tensor on the latency's device: on CUDA, torch turns
    division by a host scalar into a multiply by its reciprocal, which is
    not IEEE division and would move a step boundary.
    """
    lat = torch.as_tensor(latency_us, dtype=torch.float32, device=lut_table.device)
    step_us = torch.tensor(LUT_STEP_US, dtype=torch.float32, device=lat.device)
    step = torch.clamp(torch.round(lat / step_us), 0, LUT_SIZE - 1).to(torch.int64)
    idx = torch.as_tensor(model_idx, device=lut_table.device).to(torch.int64)
    return lut_table[idx, step]


def perf_to_cost(perf) -> torch.Tensor:
    """Paper §5.2 integer arc cost ``round(10/p) * 10`` as int32."""
    p = torch.clamp(torch.as_tensor(perf, dtype=torch.float32), min=1e-6)
    inv = torch.ones_like(p) / p  # IEEE division on every device
    return (torch.round(inv * 10.0) * 10.0).to(torch.int32)

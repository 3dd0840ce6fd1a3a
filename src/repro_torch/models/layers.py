"""Shared layer primitives: parameter specs and numerics.

Port of `repro.models.layers`. Parameters are nested dicts of tensors with
the reference's keys and shapes (``x @ W`` with ``W`` shaped (in, out));
``Param(shape, axes)`` declares one. The logical ``axes`` are kept as data
for parity with the reference and are not read on one card.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # overrides fan-in scale

    def make(self, generator: torch.Generator, dtype) -> torch.Tensor:
        device = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        # fan-in = second-to-last dim (skips the stacked-layers leading dim)
        fan_in = self.shape[-2] if len(self.shape) > 1 else self.shape[-1]
        scale = self.scale if self.scale is not None else max(fan_in, 1) ** -0.5
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return (x * scale).to(dtype)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of a nested dict (a leaf is anything else),
    with the matching leaves of the dicts in ``rest`` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_params(specs: Dict[str, Any], generator: torch.Generator, dtype) -> Dict[str, Any]:
    """Instantiate a nested dict of Param specs into tensors on the
    generator's device. Draws follow the specs' key order; the numbers
    differ from the reference's ``jax.random`` (tests carry parameters
    across with `repro_torch.convert.lm_params_from_reference`)."""
    return tree_map(lambda p: p.make(generator, dtype), specs)


def stack_specs(specs: Dict[str, Any], n: int, axis_name: str = "layers"):
    """Prepend a stacking dimension (the layer axis) to every spec."""
    return tree_map(
        lambda p: Param((n,) + p.shape, (axis_name,) + p.axes, init=p.init, scale=p.scale),
        specs,
    )


# --- numerics ----------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """The frequencies in numpy float32, exactly as the reference builds
    them, copied to ``device`` once (a copy from host memory per call would
    wait for the card at every layer)."""
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    return torch.from_numpy(np.asarray(freq, np.float32)).to(device)


def rope(
    x: torch.Tensor,  # (..., S, D_head) or (..., 1, D_head)
    positions: torch.Tensor,  # (..., S)
    theta: float,
) -> torch.Tensor:
    half = x.shape[-1] // 2
    freq = _rope_freq(half, float(theta), x.device)
    ang = positions[..., None].float() * freq  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def activation_fn(name: str):
    if name == "swiglu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation.
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)

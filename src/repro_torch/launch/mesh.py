"""Meshes as plain data, and device ordering for a NoMora-placed job.

Port of `repro.launch.mesh`. A jax ``Mesh`` is a grid of devices with
named axes; here `Mesh` is the same grid as plain data: the axis names,
their sizes (``shape``, an ordered name -> size mapping, as
``jax.sharding.Mesh.shape`` is) and ``devices``, a numpy array of that
shape whose entries say what each position is (by default its rank, the
row-major index into the grid). Building one starts no process and touches
no device; `repro_torch.distributed.comm` gives each rank of a running job
its process groups over a mesh.

Process rank r always sits at the r-th position in row-major order, so the
ranks of any slice along some axes are ascending in that slice's own
row-major order (the order `torch.distributed.new_group` keeps).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over a grid of ``devices`` (anything: ranks by default)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """The grid position of process ``rank``: {axis: index}."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def __repr__(self):
        return f"Mesh({self.shape})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], devices: Optional[Sequence] = None):
    """A mesh of ``shape`` over ``axes``; ``devices`` (row-major) default to
    the ranks 0..n-1."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    grid = np.arange(n) if devices is None else np.asarray(list(devices), dtype=object)
    if grid.size != n:
        raise ValueError(f"{grid.size} devices for a mesh of shape {shape}")
    return Mesh(grid.reshape(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices: Optional[Sequence] = None):
    """Single pod: 16x16 = 256 chips (data, model); multi-pod: 2 pods.
    Described, never launched here (``nomora_ordered_devices`` may give
    the order of ``devices``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def small_mesh(data: int = 2, model: int = 2):
    return make_mesh((data, model), ("data", "model"))


def parse_mesh(text: str) -> Mesh:
    """``--mesh DxM`` of the launchers: a (data, model) mesh."""
    try:
        dm, tm = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x1") from None
    if dm < 1 or tm < 1:
        raise ValueError(f"--mesh {text!r}: axis sizes must be positive")
    return make_mesh((dm, tm), ("data", "model"))


def nomora_ordered_devices(
    host_of_device: Sequence[int],
    latency_to_root: Sequence[float],
    devices: Optional[Sequence] = None,
):
    """Order mesh devices by the NoMora placement.

    Hosts closest (lowest RTT) to the job's root host take the model-
    parallel (innermost, latency-critical) positions; far hosts land on the
    data axis where only gradient reductions cross them. Returns devices
    sorted by (latency_to_root[host_of_device[d]], d). ``devices`` defaults
    to the visible CUDA devices (raises without a card).
    """
    if not devices:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    lat = np.asarray(latency_to_root, dtype=np.float64)
    order = sorted(range(len(devices)), key=lambda d: (lat[host_of_device[d]], d))
    return [devices[i] for i in order]

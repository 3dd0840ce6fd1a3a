"""Device ordering for a NoMora-placed job.

Port of `repro.launch.mesh`'s `nomora_ordered_devices`. The reference's
mesh constructors (`make_mesh`, `make_production_mesh`, `small_mesh`) build
JAX meshes for sharded training and serving; they come with the
multi-device slice of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


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

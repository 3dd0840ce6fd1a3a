"""Elastic scaling + failure recovery (port of `repro.distributed.elastic`).

Two cooperating layers:

1. Cluster level (NoMora): a machine-removal event re-queues its tasks;
   the next scheduling round re-places them via the policy — the paper's
   migration mechanism doubles as failure recovery. The simulator supports
   failure injection (SimConfig.failures) and tests assert recovery.

2. Job level: a training job that loses hosts restarts from the latest
   checkpoint on a smaller mesh. `elastic_mesh` picks the largest feasible
   (data, model) factorisation for the surviving device count, and
   ``CheckpointManager.restore(..., shardings=...)`` gives each rank of the
   new mesh its shard of the host arrays (no resharding collectives at
   load). Checkpoints hold whole leaves, so any mesh restores any other's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ..launch.mesh import Mesh, make_mesh


def elastic_mesh(
    n_devices: int,
    model_parallelism: int,
    *,
    pod_axis: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Largest mesh (data, model) [, pod] that fits n_devices.

    Keeps model parallelism fixed (parameter layout compatibility) and
    shrinks the data axis — the standard elastic-DP policy. ``devices``
    (the first ``data * model`` are used) default to the ranks.
    """
    if n_devices < model_parallelism:
        raise ValueError(
            f"cannot keep model_parallelism={model_parallelism} with "
            f"{n_devices} devices"
        )
    data = n_devices // model_parallelism
    use = data * model_parallelism
    devs = None if devices is None else list(devices)[:use]
    if pod_axis and pod_axis > 1 and data % pod_axis == 0:
        shape: Tuple[int, ...] = (pod_axis, data // pod_axis, model_parallelism)
        names: Tuple[str, ...] = ("pod", "data", "model")
    else:
        shape = (data, model_parallelism)
        names = ("data", "model")
    return make_mesh(shape, names, devs)


def survivors(n_total: int, failed: Sequence[int]) -> int:
    return n_total - len(set(failed))

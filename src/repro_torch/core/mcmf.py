"""Min-cost max-flow via successive shortest paths, Bellman-Ford in torch.

Port of `repro.core.mcmf`, the paper-faithful solver for the
Firmament/Quincy flow network (§4). Edge relaxation is a vectorised
Bellman-Ford over the residual arc list on ``device``: a scatter-min finds
each node's best tentative distance, a second scatter-min recovers the
lowest-id arc achieving it, in exact int32 arithmetic (distances are
bounded by path length x max arc cost, far below 2^30). Augmentations are
unit paths walked on the host, one Bellman-Ford each, as in the reference.

Bit-identity with the reference's ``jax.lax.while_loop``:

- ``dist``, ``parent``, ``cand`` and the arc ids are int32; gathers and
  scatters index with int64 copies of ``src`` and ``dst``.
- ``segment_min`` is ``scatter_reduce_(..., "amin")`` onto a buffer
  filled with int32's maximum, which is what jax returns for an empty
  segment.
- The loop ends when an iteration improves nothing, or after
  ``n_nodes + 1`` iterations. An iteration that improves nothing leaves
  ``dist`` and ``parent`` as they were, so the host reads the flag only
  every `BF_CHECK_EVERY` iterations (one sync each) and the result keeps
  the reference's bits, as long as the total stays within the cap.

Counters (``obs``): ``mcmf.augmentations``, ``mcmf.bf_iterations`` and
``mcmf.host_syncs`` (flag reads plus one path read back an augmentation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device

INT_INF = np.int32(2**30)
_I32_MAX = np.iinfo(np.int32).max

#: Bellman-Ford iterations between host reads of the "improved" flag.
BF_CHECK_EVERY = 4


@dataclasses.dataclass
class FlowResult:
    flow: np.ndarray  # (E,) flow on each forward arc
    total_cost: int
    total_flow: int


def _bellman_ford(src_l, dst_l, cost, resid, source: int, n_nodes: int,
                  check_every: int = BF_CHECK_EVERY):
    """(dist, parent_arc, iterations, flag reads) over the residual graph;
    INT_INF = unreachable.

    ``src_l`` / ``dst_l`` are int64 index tensors, ``cost`` and ``resid``
    int32, all on one device.
    """
    dev = cost.device
    E2 = cost.shape[0]
    eid = torch.arange(E2, dtype=torch.int32, device=dev)
    no_arc = torch.full((E2,), E2, dtype=torch.int32, device=dev)
    inf = torch.full((E2,), int(INT_INF), dtype=torch.int32, device=dev)
    live = resid > 0

    dist = torch.full((n_nodes,), int(INT_INF), dtype=torch.int32, device=dev)
    dist[source] = 0
    parent = torch.full((n_nodes,), -1, dtype=torch.int32, device=dev)

    it, reads = 0, 0
    while it < n_nodes + 1:
        for _ in range(min(check_every, n_nodes + 1 - it)):
            cand = torch.where(live, torch.minimum(dist[src_l] + cost, inf), inf)
            best = torch.full((n_nodes,), _I32_MAX, dtype=torch.int32, device=dev)
            best.scatter_reduce_(0, dst_l, cand, "amin")
            # Arc argmin: the lowest-id arc achieving the node's best distance.
            hit = (cand < inf) & (cand == best[dst_l])
            best_e = torch.full((n_nodes,), _I32_MAX, dtype=torch.int32, device=dev)
            best_e.scatter_reduce_(0, dst_l, torch.where(hit, eid, no_arc), "amin")
            improved = best < dist
            dist = torch.where(improved, best, dist)
            parent = torch.where(improved, best_e, parent)
            it += 1
        reads += 1
        if not bool(improved.any()):
            break
    return dist, parent, it, reads


def min_cost_max_flow(
    src: np.ndarray,
    dst: np.ndarray,
    cap: np.ndarray,
    cost: np.ndarray,
    source: int,
    sink: int,
    n_nodes: int,
    *,
    device="cuda",
) -> FlowResult:
    """Successive-shortest-paths MCMF (integer caps/costs), the
    Bellman-Ford on ``device``."""
    dev = resolve_device(device)
    E = len(src)
    if int(np.abs(cost).max(initial=0)) * (n_nodes + 2) >= int(INT_INF):
        raise ValueError("costs too large for int32 Bellman-Ford")
    src2_np = np.concatenate([src, dst]).astype(np.int32)
    dst2_np = np.concatenate([dst, src]).astype(np.int32)
    src2 = torch.from_numpy(src2_np.astype(np.int64)).to(dev)
    dst2 = torch.from_numpy(dst2_np.astype(np.int64)).to(dev)
    cost2 = torch.from_numpy(np.concatenate([cost, -cost]).astype(np.int32)).to(dev)
    resid = np.concatenate([cap.astype(np.int64), np.zeros(E, np.int64)])

    total_cost = 0
    total_flow = 0
    augmentations = iterations = syncs = 0
    while True:
        dist, parent, iters, reads = _bellman_ford(
            src2, dst2, cost2, torch.from_numpy(resid.astype(np.int32)).to(dev),
            source, n_nodes,
        )
        iterations += iters
        # One read back: the sink's distance, then every node's parent arc.
        host = torch.cat([dist[sink:sink + 1], parent]).cpu().numpy()
        syncs += reads + 1
        d_sink, parent = int(host[0]), host[1:]
        if d_sink >= INT_INF:
            break
        # Walk the shortest path backwards, find the bottleneck, augment.
        path = []
        v = sink
        while v != source:
            e = int(parent[v])
            path.append(e)
            v = int(src2_np[e])
        bottleneck = min(int(resid[e]) for e in path)
        for e in path:
            resid[e] -= bottleneck
            mate = e + E if e < E else e - E
            resid[mate] += bottleneck
        total_cost += bottleneck * d_sink
        total_flow += bottleneck
        augmentations += 1

    obs.add("mcmf.augmentations", augmentations)
    obs.add("mcmf.bf_iterations", iterations)
    obs.add("mcmf.host_syncs", syncs)
    flow = cap.astype(np.int64) - resid[:E]
    return FlowResult(flow=flow, total_cost=int(total_cost), total_flow=int(total_flow))

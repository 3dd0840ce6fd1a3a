"""Carry the reference package's state across to this package.

`lm_params_from_reference` carries an LM's parameter pytree across,
`train_state_from_reference` an optimizer's `TrainState` (params, mu, nu,
step).

The scheduler has no weights; its state is the perf LUT, the `Topology`,
the `PolicyParams`, the `LatencyPlane` (topology, series, seed, dynamic
events) and the `Workload` job list. `from_reference` builds this
package's object from a reference object's plain fields (numpy arrays,
ints, floats, tuples), read duck-typed by class name and attribute: this
module imports nothing of the reference package, so the tests can replay
one workload on one plane through both.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import latency, policy, topology, workload


def _topology(o) -> topology.Topology:
    return topology.Topology(
        n_machines=int(o.n_machines),
        machines_per_rack=int(o.machines_per_rack),
        racks_per_pod=int(o.racks_per_pod),
        slots_per_machine=int(o.slots_per_machine),
    )


def _hotspot(o) -> latency.DriftingHotspot:
    return latency.DriftingHotspot(
        start_s=float(o.start_s),
        end_s=float(o.end_s),
        rack0=int(o.rack0),
        drift_racks_per_s=float(o.drift_racks_per_s),
        width_racks=int(o.width_racks),
        multiplier=float(o.multiplier),
    )


def _regime(o) -> latency.RegimeSchedule:
    return latency.RegimeSchedule(
        times=tuple(float(t) for t in o.times), frac=float(o.frac)
    )


def _events(o) -> latency.LatencyEvents:
    return latency.LatencyEvents(
        hotspots=tuple(_hotspot(h) for h in o.hotspots),
        regime=None if o.regime is None else _regime(o.regime),
    )


def _plane(o) -> latency.LatencyPlane:
    return latency.LatencyPlane(
        topo=_topology(o.topo),
        series=np.array(o.series, dtype=np.float32),
        seed=int(o.seed),
        events=_events(o.events),
        allow_wrap=bool(o.allow_wrap),
    )


def _job(o) -> workload.Job:
    return workload.Job(
        job_id=int(o.job_id),
        arrival_s=float(o.arrival_s),
        n_tasks=int(o.n_tasks),
        duration_s=float(o.duration_s),
        perf_idx=int(o.perf_idx),
        ml_arch=o.ml_arch,
    )


def _workload(o) -> workload.Workload:
    return workload.Workload(
        jobs=[_job(j) for j in o.jobs],
        duration_s=int(o.duration_s),
        topo=_topology(o.topo),
    )


def _params(o) -> policy.PolicyParams:
    return policy.PolicyParams(
        **{f.name: getattr(o, f.name) for f in dataclasses.fields(policy.PolicyParams)}
    )


def _round_state(o) -> policy.RoundState:
    return policy.RoundState(
        **{
            f.name: np.asarray(getattr(o, f.name))
            for f in dataclasses.fields(policy.RoundState)
        }
    )


_CONVERTERS = {
    "Topology": _topology,
    "DriftingHotspot": _hotspot,
    "RegimeSchedule": _regime,
    "LatencyEvents": _events,
    "LatencyPlane": _plane,
    "Job": _job,
    "Workload": _workload,
    "PolicyParams": _params,
    "RoundState": _round_state,
}


def from_reference(obj):
    """This package's counterpart of a reference object.

    Dataclasses convert by class name (`Topology`, `LatencyPlane`,
    `Workload`, `Job`, `PolicyParams`, `RoundState`, the latency events);
    anything array-like (the perf LUT) becomes a CPU tensor of its dtype.
    """
    conv = _CONVERTERS.get(type(obj).__name__)
    if conv is not None:
        return conv(obj)
    if hasattr(obj, "__array__"):
        return torch.from_numpy(np.array(obj))
    raise TypeError(f"no repro_torch counterpart for {type(obj).__name__}")


def _tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def lm_params_from_reference(tree, lm=None):
    """The port's LM parameters from the reference's parameter pytree.

    ``tree`` is the reference's nested dict of arrays (numpy, or anything
    ``np.asarray`` takes), keyed as the reference keys it
    (``blocks/pos0_dense/attn/wq`` is ``tree["blocks"]["pos0_dense"]["attn"]
    ["wq"]``, stacked (n_superblocks, ...)). The port keeps the same keys,
    shapes, dtypes and ``x @ W`` layouts (a cross layer's ``gate``, an MoE
    layer's ``router``, ``we1`` / ``we2`` / ``we3`` and ``shared`` FFN
    included), so this is a copy into CPU tensors. With ``lm`` (a `repro_torch.models.LM`), the keys and shapes
    are checked against ``lm.param_specs()``.
    """
    from .models.layers import tree_map

    params = tree_map(_tensor, dict(tree))
    if lm is not None:
        want = tree_map(lambda p: tuple(p.shape), lm.param_specs())
        got = tree_map(lambda t: tuple(t.shape), params)
        if got != want:
            raise ValueError(f"reference parameters do not match {lm.cfg.name}: "
                             f"got {got}, expected {want}")
    return params


def train_state_from_reference(state, lm=None):
    """The port's `TrainState` from the reference's, read duck-typed by its
    fields: params, mu and nu through `lm_params_from_reference` (checked
    against ``lm`` when given), step as a 0-d int32 CPU tensor."""
    from .optim import TrainState

    return TrainState(
        params=lm_params_from_reference(state.params, lm),
        mu=lm_params_from_reference(state.mu, lm),
        nu=lm_params_from_reference(state.nu, lm),
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
    )

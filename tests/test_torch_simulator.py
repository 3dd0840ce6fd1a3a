"""Whole replays: the reference `Simulator` and the repro_torch one
(``device="cpu"``) on the same workload and plane, backend ``auction``,
``fixed_algo_s=0`` — every SimMetrics series and the summary equal."""

import math

import pytest

torch = pytest.importorskip("torch")

from repro.core import latency as r_latency  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import simulator as r_sim  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core import workload as r_workload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402

SERIES = ("algo_runtime_s", "placement_latency_s", "response_time_s",
          "migrated_pct_per_round", "per_job_perf")
SCALARS = ("tasks_placed", "tasks_migrated", "rounds")


def _replay_both(topo, duration_s, params_kw, **cfg_kw):
    plane = r_latency.LatencyPlane.synthesize(topo, duration_s=duration_s, seed=1)
    wl = r_workload.synth_workload(topo, duration_s=duration_s, seed=1,
                                   target_utilisation=0.6)
    common = dict(policy="nomora", backend="auction", seed=5, fixed_algo_s=0.0,
                  migration_interval_s=30, **cfg_kw)
    ref = r_sim.Simulator(
        wl, plane, r_sim.SimConfig(params=r_policy.PolicyParams(**params_kw), **common)
    ).run()
    port = t_sim.Simulator(
        convert.from_reference(wl),
        convert.from_reference(plane),
        t_sim.SimConfig(params=t_policy.PolicyParams(**params_kw), device="cpu", **common),
    ).run()
    return ref, port


def _assert_equal(ref, port):
    for f in SERIES + SCALARS:
        assert getattr(ref, f) == getattr(port, f), f
    a, b = ref.summary(), port.summary()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k


def test_replay_static_matches_reference():
    topo = r_topology.Topology(
        n_machines=32, machines_per_rack=8, racks_per_pod=2, slots_per_machine=4
    )
    ref, port = _replay_both(topo, 90, dict(preemption=True, beta_scale=0.0))
    assert ref.rounds > 0 and ref.tasks_migrated > 0
    _assert_equal(ref, port)


def test_replay_failure_and_stragglers_matches_reference():
    topo = r_topology.Topology(
        n_machines=48, machines_per_rack=8, racks_per_pod=3, slots_per_machine=4
    )
    ref, port = _replay_both(
        topo, 60, dict(preemption=True, beta_scale=1.0),
        failures=((12, 5),), straggler_threshold=0.97, perf_sample_interval_s=5,
    )
    assert ref.rounds > 0 and ref.tasks_placed > 0
    _assert_equal(ref, port)


# The first two cases are paths the port has not got yet (NotImplementedError);
# the other four became code in the migration-path slice and now raise the
# reference's ValueError for a misconfiguration of that code, message for
# message.
@pytest.mark.parametrize(
    "unported",
    [dict(streaming_metrics=True), dict(whatif_betas=(0.0,)), dict(device_latency=True),
     dict(migration_controller=True), dict(backend="mcmf"),
     dict(backend="auction_windowed", migration_controller=True)],
)
def test_unported_paths_raise(unported):
    from repro_torch.core import latency, topology, workload

    topo = topology.Topology(16, 8, 2, slots_per_machine=2)
    wl = workload.synth_workload(topo, 10, seed=0)
    plane = latency.LatencyPlane.synthesize(topo, 10, seed=0)
    if "streaming_metrics" in unported or unported.get("backend") == "mcmf":
        with pytest.raises(NotImplementedError):
            t_sim.Simulator(wl, plane, t_sim.SimConfig(device="cpu", **unported))
        return
    r_topo = r_topology.Topology(16, 8, 2, slots_per_machine=2)
    with pytest.raises(ValueError) as want:
        r_sim.Simulator(r_workload.synth_workload(r_topo, 10, seed=0),
                        r_latency.LatencyPlane.synthesize(r_topo, 10, seed=0),
                        r_sim.SimConfig(**unported))
    with pytest.raises(ValueError) as got:
        t_sim.Simulator(wl, plane, t_sim.SimConfig(device="cpu", **unported))
    assert str(got.value) == str(want.value)

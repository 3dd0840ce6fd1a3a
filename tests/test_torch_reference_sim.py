"""The port's seed per-object loop (`reference_sim`) as the engine's parity
oracle inside repro_torch: the port's vectorized `Simulator` equals the
port's `ReferenceSimulator` bit for bit (mirrors tests/test_engine_parity.py
on the ``auction`` and ``mcmf`` solvers), and the port's loop equals the
reference's on one seed. ``fixed_algo_s=0``, ``device="cpu"``, tolerance 0."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import latency as r_latency  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import reference_sim as r_refsim  # noqa: E402
from repro.core import simulator as r_sim  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core import workload as r_workload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import latency, simulator, topology, workload  # noqa: E402
from repro_torch.core.policy import PolicyParams  # noqa: E402
from repro_torch.core.reference_sim import ReferenceSimulator  # noqa: E402

TOPO = topology.Topology(
    n_machines=48, machines_per_rack=8, racks_per_pod=3, slots_per_machine=4
)


@pytest.fixture(scope="module")
def plane():
    return latency.LatencyPlane.synthesize(TOPO, duration_s=120, seed=0)


@pytest.fixture(scope="module")
def wl():
    return workload.synth_workload(TOPO, duration_s=120, seed=1, target_utilisation=0.4)


def assert_metrics_identical(m_ref, m_vec):
    assert m_ref.tasks_placed == m_vec.tasks_placed
    assert m_ref.tasks_migrated == m_vec.tasks_migrated
    assert m_ref.rounds == m_vec.rounds
    assert m_ref.algo_runtime_s == m_vec.algo_runtime_s
    assert m_ref.placement_latency_s == m_vec.placement_latency_s
    assert m_ref.response_time_s == m_vec.response_time_s
    assert m_ref.migrated_pct_per_round == m_vec.migrated_pct_per_round
    assert m_ref.per_job_perf == m_vec.per_job_perf


def run_both(wl, plane, **kw):
    cfg = simulator.SimConfig(fixed_algo_s=0.0, device="cpu", **kw)
    m_ref = ReferenceSimulator(wl, plane, dataclasses.replace(cfg)).run()
    m_vec = simulator.Simulator(wl, plane, dataclasses.replace(cfg)).run()
    return m_ref, m_vec


@pytest.mark.parametrize(
    "policy", ["random", "load_spreading", "nomora", "random_solver", "spread_solver"]
)
def test_parity_all_policies(wl, plane, policy):
    m_ref, m_vec = run_both(wl, plane, policy=policy, seed=11)
    assert m_vec.tasks_placed > 0
    assert_metrics_identical(m_ref, m_vec)


@pytest.mark.parametrize("solver", ["auction", "mcmf"])
def test_parity_preemption_and_failures(wl, plane, solver):
    m_ref, m_vec = run_both(
        wl, plane, policy="nomora", solver=solver, seed=18, migration_interval_s=20,
        failures=((35, 2), (35, 3), (80, 7)),
        params=PolicyParams(preemption=True, beta_scale=0.0),
    )
    assert m_vec.tasks_migrated > 0
    assert_metrics_identical(m_ref, m_vec)


def test_parity_straggler_migration(wl, plane):
    m_ref, m_vec = run_both(
        wl, plane, policy="nomora", seed=15, perf_sample_interval_s=10,
        migration_interval_s=10_000, straggler_threshold=0.99,
        params=PolicyParams(preemption=True, beta_scale=0.0),
    )
    assert_metrics_identical(m_ref, m_vec)


def test_parity_mcmf_solver(plane):
    small = workload.synth_workload(TOPO, duration_s=60, seed=8, target_utilisation=0.1)
    m_ref, m_vec = run_both(small, plane, policy="nomora", solver="mcmf", seed=16)
    assert m_vec.rounds > 0
    assert_metrics_identical(m_ref, m_vec)


def test_parity_task_state(wl, plane):
    """Beyond metrics: the final per-task state matches record for record."""
    cfg = simulator.SimConfig(policy="nomora", seed=17, fixed_algo_s=0.0, device="cpu")
    ref = ReferenceSimulator(wl, plane, dataclasses.replace(cfg))
    ref.run()
    vec = simulator.Simulator(wl, plane, dataclasses.replace(cfg))
    vec.run()
    jobs_vec = vec.jobs
    assert set(ref.jobs) == set(jobs_vec)
    for jid, rec_ref in ref.jobs.items():
        rec_vec = jobs_vec[jid]
        assert rec_ref.root_machine == rec_vec.root_machine
        assert rec_ref.done == rec_vec.done
        for t_ref, t_vec in zip(rec_ref.tasks, rec_vec.tasks):
            assert dataclasses.asdict(t_ref) == dataclasses.asdict(t_vec)
    assert np.array_equal(ref.free_slots, vec.free_slots)
    assert np.array_equal(ref.task_counts, vec.task_counts)
    assert ref.dead == vec.dead


@pytest.mark.parametrize("solver,policy", [("auction", "nomora"), ("mcmf", "nomora"),
                                           ("auction", "random_solver")])
def test_port_loop_equals_reference_loop(solver, policy):
    topo = r_topology.Topology(n_machines=32, machines_per_rack=8, racks_per_pod=2,
                               slots_per_machine=4)
    plane = r_latency.LatencyPlane.synthesize(topo, duration_s=60, seed=2)
    wl = r_workload.synth_workload(topo, duration_s=60, seed=3, target_utilisation=0.5)
    kw = dict(policy=policy, solver=solver, seed=9, fixed_algo_s=0.0,
              migration_interval_s=20, failures=((30, 4),))
    params = dict(preemption=True, beta_scale=0.0)
    ref = r_refsim.ReferenceSimulator(wl, plane, r_sim.SimConfig(
        params=r_policy.PolicyParams(**params), **kw)).run()
    port = ReferenceSimulator(convert.from_reference(wl), convert.from_reference(plane),
                              simulator.SimConfig(params=PolicyParams(**params),
                                                  device="cpu", **kw)).run()
    assert ref.tasks_placed > 0
    assert_metrics_identical(ref, port)
    assert ref.summary().keys() == port.summary().keys()

"""The §7 migration path, whole replays: the reference `Simulator` and the
repro_torch one (``device="cpu"``) on the three dynamic scenarios
(`drifting_hotspot`, `regime_shifts`, `spike_storms`) with the QoS
migration controller, the device latency oracle and what-if lanes on,
``fixed_algo_s=0``, tolerance 0: every SimMetrics series and scalar,
``summary()``, the deterministic counters and the ``controller_round``
audit events (every field but the measured ``algo_s``). Also the paths
without the controller, and the reference's ValueErrors for
misconfigurations."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as r_obs  # noqa: E402
from repro.core import latency as r_latency  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import scenarios as r_scenarios  # noqa: E402
from repro.core import simulator as r_sim  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core import workload as r_workload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core import scenarios as t_scenarios  # noqa: E402
from repro_torch.core import simulator as t_sim  # noqa: E402

TOPO = r_topology.Topology(
    n_machines=64, machines_per_rack=8, racks_per_pod=4, slots_per_machine=4
)
DURATION = 120
SERIES = ("algo_runtime_s", "placement_latency_s", "response_time_s",
          "migrated_pct_per_round", "per_job_perf", "controller_improvement_per_round",
          "degraded_jobs_per_round")
SCALARS = ("tasks_placed", "tasks_migrated", "rounds", "controller_rounds")
# The migration-quality benchmark's controller settings.
CONTROLLER = dict(migration_controller=True, device_latency=True,
                  whatif_betas=(0.0, 100.0 / 3600.0), qos_threshold=0.95, qos_window=2,
                  qos_hold_s=30.0)


@pytest.fixture(scope="module")
def cluster():
    base = r_latency.LatencyPlane.synthesize(TOPO, duration_s=DURATION, seed=0)
    wl = r_workload.synth_workload(TOPO, duration_s=DURATION, seed=1,
                                   target_utilisation=0.35)
    return base, wl


def _replay(name, cluster, extra):
    """One scenario through both simulators; returns ((metrics, counters,
    audit) of the reference, the same of the port)."""
    base, wl = cluster
    out = []
    for obs_mod, sims, scns, conv in (
        (r_obs, r_sim, r_scenarios, lambda x: x),
        (t_obs, t_sim, t_scenarios, convert.from_reference),
    ):
        scn = scns.get_scenario(name)
        topo = conv(TOPO)
        kw = dict(policy="nomora", backend="auction_windowed", seed=11, fixed_algo_s=0.0,
                  params=scn.policy_params(p_m=105, p_r=110),
                  **scn.sim_config_kwargs(topo, DURATION, 0), **extra)
        if sims is t_sim:
            kw["device"] = "cpu"
        with obs_mod.scope() as tel:
            sim = sims.Simulator(conv(wl), scn.plane(conv(base), DURATION),
                                 sims.SimConfig(**kw))
            m = sim.run()
            counters = obs_mod.deterministic_counters(obs_mod.counters())
            audit = [{k: v for k, v in e.items() if k != "algo_s"} for e in tel.audit]
        out.append((m, counters, audit))
    return out


def _assert_metrics_equal(ref, port):
    for f in SERIES + SCALARS:
        assert getattr(ref, f) == getattr(port, f), f
    a, b = ref.summary(), port.summary()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k


@pytest.mark.parametrize("name", ["drifting_hotspot", "regime_shifts", "spike_storms"])
def test_controller_replay_equals_reference(cluster, name):
    (rm, rc, ra), (pm, pc, pa) = _replay(name, cluster, CONTROLLER)
    assert rm.controller_rounds > 0 and rc.get("whatif.lanes", 0) > 0
    _assert_metrics_equal(rm, pm)
    assert pc == rc
    assert len(pa) == len(ra)
    for got, want in zip(pa, ra):
        assert got == want
    for key in ("oracle.round_uploads", "oracle.uploaded_floats", "controller.rounds",
                "h2d.upload_bytes"):
        assert key in pc, key


def test_controller_migrates_on_drift_and_stays_slot_safe(cluster):
    base, wl = cluster
    scn = t_scenarios.get_scenario("drifting_hotspot")
    topo = convert.from_reference(TOPO)
    cfg = t_sim.SimConfig(
        policy="nomora", backend="auction_windowed", seed=11, device="cpu",
        params=scn.policy_params(p_m=105, p_r=110), migration_budget=2,
        **scn.sim_config_kwargs(topo, DURATION, 0), **CONTROLLER,
    )
    sim = t_sim.Simulator(convert.from_reference(wl),
                          scn.plane(convert.from_reference(base), DURATION), cfg)
    m = sim.run()
    assert m.controller_rounds > 0
    assert all(v >= 0.0 for v in m.controller_improvement_per_round)
    assert m.tasks_migrated <= 2 * len(m.migrated_pct_per_round)
    assert sim.free_slots.min() >= 0 and sim.free_slots.max() <= TOPO.slots_per_machine


def test_whatif_rounds_without_controller_equal_reference(cluster):
    """``whatif_betas`` alone: every migration round picks the variant with
    the lowest true cost, as the reference does."""
    (rm, rc, _), (pm, pc, _) = _replay(
        "drifting_hotspot", cluster, dict(whatif_betas=(0.0, 100.0 / 3600.0, 0.5)))
    assert rc.get("whatif.lanes", 0) > 0
    _assert_metrics_equal(rm, pm)
    assert pc == rc


def test_windowed_with_oracle_equals_auction_with_host_rows(cluster):
    """The controller-OFF replay: ``auction_windowed`` fed by the device
    oracle gives the ``auction`` backend's metrics with host rows."""
    base, wl = cluster
    scn = t_scenarios.get_scenario("regime_shifts")
    topo = convert.from_reference(TOPO)
    plane = scn.plane(convert.from_reference(base), DURATION)
    runs = {}
    for backend, oracle in (("auction", False), ("auction_windowed", True)):
        cfg = t_sim.SimConfig(policy="nomora", backend=backend, device="cpu", seed=5,
                              fixed_algo_s=0.0, device_latency=oracle,
                              params=t_policy.PolicyParams(p_m=105, p_r=110,
                                                           preemption=True),
                              migration_interval_s=30)
        runs[backend] = t_sim.Simulator(convert.from_reference(wl), plane, cfg).run()
    assert runs["auction"].tasks_migrated > 0
    _assert_metrics_equal(runs["auction"], runs["auction_windowed"])


def test_scenario_planes_and_configs_equal_reference(cluster):
    base, _ = cluster
    topo = convert.from_reference(TOPO)
    assert sorted(t_scenarios.SCENARIOS) == sorted(
        n for n in r_scenarios.SCENARIOS if n != "google_trace")
    for name, scn in t_scenarios.SCENARIOS.items():
        ref = r_scenarios.SCENARIOS[name]
        assert scn.is_dynamic == ref.is_dynamic
        assert scn.sim_config_kwargs(topo, DURATION, 3) == ref.sim_config_kwargs(
            TOPO, DURATION, 3)
        assert convert.from_reference(ref.policy_params(p_m=105)) == scn.policy_params(
            p_m=105)
        rp, tp = ref.plane(base, DURATION), scn.plane(convert.from_reference(base), DURATION)
        for t in (0, 40, 90):
            roots = [0, 9, 63]
            assert np.array_equal(tp.latency_rows(roots, t), rp.latency_rows(roots, t)), name


def test_unported_presets_raise():
    with pytest.raises(NotImplementedError, match="M7"):
        t_scenarios.get_scenario("google_trace")
    with pytest.raises(NotImplementedError, match="M9"):
        t_scenarios.SERVING_PRESETS  # noqa: B018
    with pytest.raises(NotImplementedError, match="M9"):
        t_scenarios.get_serving_preset("smoke")
    with pytest.raises(KeyError):
        t_scenarios.get_scenario("nope")


@pytest.mark.parametrize(
    "bad",
    [
        dict(whatif_betas=(0.0,)),
        dict(device_latency=True),
        dict(migration_controller=True, params=dict(preemption=True)),
        dict(backend="auction_windowed", migration_controller=True),
        dict(backend="random", whatif_betas=(0.0, 1.0)),
        dict(backend="auction_host", device_latency=True),
    ],
    ids=["whatif_auction", "oracle_auction", "controller_auction",
         "controller_no_preemption", "whatif_random", "oracle_host"],
)
def test_misconfigurations_raise_the_reference_value_error(bad):
    """The reference's ValueError, message for message."""
    bad = dict(bad)
    params = bad.pop("params", {})
    topo = r_topology.Topology(16, 8, 2, slots_per_machine=2)
    wl = r_workload.synth_workload(topo, 10, seed=0)
    plane = r_latency.LatencyPlane.synthesize(topo, 10, seed=0)
    with pytest.raises(ValueError) as want:
        r_sim.Simulator(wl, plane, r_sim.SimConfig(
            params=r_policy.PolicyParams(**params), **bad))
    with pytest.raises(ValueError) as got:
        t_sim.Simulator(convert.from_reference(wl), convert.from_reference(plane),
                        t_sim.SimConfig(params=t_policy.PolicyParams(**params),
                                        device="cpu", **bad))
    assert str(got.value) == str(want.value)


def test_grouped_migration_config_carries_the_controller_knobs():
    mc = t_sim.MigrationConfig(interval_s=15, controller=True, qos_threshold=0.95,
                               qos_window=3, qos_clear_margin=0.05, qos_hold_s=30.0,
                               budget=7, whatif_betas=(0.0,))
    cfg = t_sim.SimConfig(migration=mc, device="cpu")
    assert (cfg.migration_interval_s, cfg.migration_controller, cfg.qos_threshold,
            cfg.qos_window, cfg.qos_clear_margin, cfg.qos_hold_s, cfg.migration_budget,
            cfg.whatif_betas) == (15, True, 0.95, 3, 0.05, 30.0, 7, (0.0,))
    assert cfg.migration_cfg == mc
    ref_fields = {f for f in r_sim.MigrationConfig.__dataclass_fields__}
    assert set(t_sim.MigrationConfig.__dataclass_fields__) == ref_fields

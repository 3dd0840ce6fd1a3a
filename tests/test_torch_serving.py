"""The online `ScheduleService` in repro_torch (``device="cpu"``).

Against the reference: the ``smoke`` preset's placements and every report
field equal the reference's (the measured wall-clock latencies excepted:
they are measured, never compared), ``verify_replay`` finds 0 mismatches,
and the presets are the reference's. The compile counter that the warm-path
gate reads counts kernel builds and library loads, never a library already
in memory. Then tests/test_serving.py on the port, with `BACKEND_NAMES`
now the reference's tuple.
"""

import dataclasses
import stat
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import scenarios as r_scenarios  # noqa: E402
from repro.core import serving as r_serving  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.policy import PolicyParams  # noqa: E402
from repro_torch.core.scenarios import SERVING_PRESETS, get_serving_preset  # noqa: E402
from repro_torch.core.scheduler_backend import (  # noqa: E402
    BACKEND_NAMES,
    BackendCapabilityError,
    make_backend,
)
from repro_torch.core.serving import (  # noqa: E402
    ScheduleService,
    ServingConfig,
    ServingReport,
    saturation_sweep,
    serve,
)
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.core.trace import OpenLoopCursor, open_loop_trace  # noqa: E402

TOPO = Topology(n_machines=32, machines_per_rack=8, racks_per_pod=2, slots_per_machine=4)

SMOKE = ServingConfig(**{**get_serving_preset("smoke").config_kwargs,
                         "slots_per_machine": 4, "device": "cpu"})
MEASURED = {"decision_p50_ms", "decision_p99_ms", "decision_mean_ms",
            "round_wall_p50_ms", "round_wall_p99_ms", "busy_fraction",
            "jit_compiles_post_warmup"}


def _job_tuples(cursor):
    return [(j.job_id, j.arrival_s, j.n_tasks, j.duration_s, j.perf_idx)
            for j in cursor.jobs]


# --------------------------------------------------------------------- #
# Against the reference


def test_presets_equal_reference():
    assert sorted(SERVING_PRESETS) == sorted(r_scenarios.SERVING_PRESETS)
    for name, preset in SERVING_PRESETS.items():
        ref = r_scenarios.SERVING_PRESETS[name]
        assert (preset.name, preset.description) == (ref.name, ref.description)
        assert dict(preset.config_kwargs) == dict(ref.config_kwargs)
    ref_fields = {f.name for f in dataclasses.fields(r_serving.ServingConfig)}
    assert {f.name for f in dataclasses.fields(ServingConfig)} == ref_fields | {"device"}
    assert [f.name for f in dataclasses.fields(r_serving.ServingReport)] == [
        f.name for f in dataclasses.fields(ServingReport)]


@pytest.mark.parametrize("kw", [
    dict(record_rounds=8),
    dict(record_rounds=6, device_latency=True, warmup_rounds=3),
    dict(backend="mcmf", params=dict(preemption=True, beta_scale=0.0)),
])
def test_smoke_preset_equals_reference(kw):
    kw = dict(kw)
    params = kw.pop("params", {})
    from repro.core.policy import PolicyParams as RParams

    ref_svc = r_serving.ScheduleService(r_serving.ServingConfig(
        **{**r_scenarios.get_serving_preset("smoke").config_kwargs, **kw},
        params=RParams(**params)))
    ref = ref_svc.run()
    svc = ScheduleService(dataclasses.replace(SMOKE, params=PolicyParams(**params), **kw))
    rep = svc.run()
    a, b = dataclasses.asdict(ref), dataclasses.asdict(rep)
    assert {k: v for k, v in a.items() if k not in MEASURED} == {
        k: v for k, v in b.items() if k not in MEASURED}
    assert rep.drained and rep.tasks_placed > 0
    assert np.array_equal(ref_svc.sim.tt.machine[: ref_svc.sim.tt.n],
                          svc.sim.tt.machine[: svc.sim.tt.n])
    assert ref_svc.sim.metrics.placement_latency_s == svc.sim.metrics.placement_latency_s
    if kw.get("record_rounds"):
        assert rep.replay_mismatches == 0 and len(svc.recorder.records) > 0
        for (rs, rc), (ps, pc) in zip(ref_svc.recorder.records, svc.recorder.records):
            assert np.array_equal(rc, pc)
            assert np.array_equal(np.asarray(rs.root_latency), ps.root_latency)


# --------------------------------------------------------------------- #
# The compile counter


def test_compile_counter_counts_builds_and_loads_not_loaded_libraries(tmp_path,
                                                                      monkeypatch):
    """A build adds one, loading the library into the process adds one, a
    library already in memory adds nothing."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "fake.cu").write_text("// a source\n")
    fake_nvcc = tmp_path / "nvcc"
    fake_nvcc.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    fake_nvcc.chmod(fake_nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: str(fake_nvcc))
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: object())
    with obs.scope():
        c0 = obs.jit_compiles()
        build.load("fake.cu", lambda lib: None)
        assert obs.jit_compiles() - c0 == 2  # built, then loaded
        build.load("fake.cu", lambda lib: None)
        assert obs.jit_compiles() - c0 == 2  # in memory: nothing
        build._LIBS.clear()  # as a new process: on disk, not in memory
        build.load("fake.cu", lambda lib: None)
        assert obs.jit_compiles() - c0 == 3  # loaded, not rebuilt
        assert "jit.backend_compiles" not in obs.deterministic_counters(obs.counters())


# --------------------------------------------------------------------- #
# tests/test_serving.py on the port


def test_open_loop_deterministic_given_seed():
    a = open_loop_trace(TOPO, 120, 1.5, seed=7)
    ja = _job_tuples(a)
    assert ja == _job_tuples(open_loop_trace(TOPO, 120, 1.5, seed=7)) and len(ja) > 0
    assert ja == _job_tuples(a)
    assert ja != _job_tuples(open_loop_trace(TOPO, 120, 1.5, seed=8))


def test_open_loop_rate_horizon_and_duration_scale():
    jobs = list(open_loop_trace(TOPO, 400, 2.0, seed=3).jobs)
    assert 800 - 5 * np.sqrt(800) < len(jobs) < 800 + 5 * np.sqrt(800)
    arr = [j.arrival_s for j in jobs]
    assert arr == sorted(arr) and all(0 <= a < 400 for a in arr)
    assert [j.job_id for j in jobs] == list(range(len(jobs)))
    full = open_loop_trace(TOPO, 200, 1.0, seed=0)
    tenth = open_loop_trace(TOPO, 200, 1.0, seed=0, duration_scale=0.1)
    df = np.array([j.duration_s for j in full.jobs])
    dt = np.array([j.duration_s for j in tenth.jobs])
    assert np.all(dt <= df) and np.all(dt >= 1.0)
    assert [j.arrival_s for j in full.jobs] == [j.arrival_s for j in tenth.jobs]


def test_open_loop_windowing_is_prefix_free():
    cursor = OpenLoopCursor(topo=TOPO, duration_s=180, rate_jobs_s=1.0, seed=5,
                            window_s=60)
    streamed = [jobs for _lo, _hi, jobs in cursor.windows()]
    assert [(j.arrival_s, j.n_tasks) for j in streamed[1]] == [
        (j.arrival_s, j.n_tasks) for j in cursor._window_jobs(1)]


def test_serving_drains_at_sub_saturation():
    rep = serve(SMOKE, backend="load_spreading", rate_jobs_s=0.4)
    assert rep.drained and not rep.saturated
    assert rep.final_queue_depth == 0 and rep.tasks_placed > 0 and rep.jobs_admitted > 0
    assert rep.decision_p99_ms >= rep.decision_p50_ms >= 0.0


def test_serving_detects_saturation():
    rep = serve(SMOKE, backend="load_spreading", rate_jobs_s=20.0, duration_scale=1.0,
                queue_limit_tasks=128, max_drain_s=30)
    assert rep.saturated and not rep.drained
    assert rep.saturated_reason in ("queue_limit", "drain_timeout")


def test_serving_deterministic_placements():
    a = ScheduleService(dataclasses.replace(SMOKE, backend="auction_host"))
    ra = a.run()
    b = ScheduleService(dataclasses.replace(SMOKE, backend="auction_host"))
    rb = b.run()
    assert (ra.tasks_placed, ra.ticks) == (rb.tasks_placed, rb.ticks)
    assert np.array_equal(a.sim.tt.machine[: a.sim.tt.n], b.sim.tt.machine[: b.sim.tt.n])


def test_saturation_sweep_orders_rates():
    cfg = dataclasses.replace(SMOKE, backend="random", max_drain_s=40,
                              queue_limit_tasks=200, duration_scale=1.0)
    reports, sustainable = saturation_sweep(cfg, [8.0, 0.3], share_backend=False)
    assert [r.rate_jobs_s for r in reports] == [0.3, 8.0]
    assert reports[0].drained and reports[1].saturated
    assert sustainable == 0.3


def test_saturation_sweep_shares_one_warm_backend():
    cfg = dataclasses.replace(SMOKE, max_drain_s=60, horizon_s=15)
    with obs.scope():
        reports, sustainable = saturation_sweep(cfg, [0.3, 0.6])
    assert all(r.jit_compiles_post_warmup == 0.0 for r in reports)
    assert sustainable > 0


def test_serving_rejects_unservable_backend():
    with pytest.raises(ValueError, match="supports_serving"):
        ScheduleService(dataclasses.replace(SMOKE, backend="auction"))


def test_serving_warm_path_zero_compiles_and_replay_parity():
    with obs.scope():
        svc = ScheduleService(dataclasses.replace(
            SMOKE, backend="auction_windowed", record_rounds=6, device_latency=True,
            warmup_rounds=3))
        rep = svc.run()
    assert rep.drained
    assert rep.jit_compiles_post_warmup == 0.0
    assert rep.replay_mismatches == 0
    assert len(svc.recorder.records) > 0


@pytest.mark.parametrize("name", BACKEND_NAMES)
def test_backend_capability_flags(name):
    topo = Topology(n_machines=8, machines_per_rack=4, racks_per_pod=2, slots_per_machine=2)
    b = make_backend(name, PolicyParams(), topo, device="cpu")
    for flag in ("supports_window", "supports_whatif", "supports_serving",
                 "supports_migration", "selects_movers", "needs_latency",
                 "caps_admission"):
        assert isinstance(getattr(b, flag), bool), (name, flag)
    if not b.supports_window:
        with pytest.raises(BackendCapabilityError):
            b.place_window([])
    if not b.supports_whatif:
        with pytest.raises(BackendCapabilityError):
            b.place_whatif(None, None, [])
        with pytest.raises(BackendCapabilityError):
            b.whatif_result(None, None, [])
    if not b.supports_serving:
        with pytest.raises(BackendCapabilityError):
            b.pin_serving(16, 8)
        with pytest.raises(BackendCapabilityError):
            b.warm_serving(np.full(8, 2, np.int32))
    else:
        b.pin_serving(16, 8)
    assert isinstance(BackendCapabilityError("x"), NotImplementedError)


def test_backend_capability_expectations():
    topo = Topology(n_machines=8, machines_per_rack=4, racks_per_pod=2, slots_per_machine=2)
    caps = {name: make_backend(name, PolicyParams(), topo, device="cpu")
            for name in BACKEND_NAMES}
    assert caps["auction_windowed"].supports_window
    assert caps["auction_windowed"].supports_whatif
    assert caps["auction_windowed"].supports_serving
    assert not caps["auction"].supports_serving
    assert caps["auction_host"].supports_serving
    for host in ("random", "load_spreading", "mcmf", "random_solver", "spread_solver"):
        assert caps[host].supports_serving, host
        assert not caps[host].supports_window, host
        assert not caps[host].supports_whatif, host


def test_serving_presets_build_configs():
    for name, preset in SERVING_PRESETS.items():
        cfg = ServingConfig(**preset.config_kwargs)
        assert cfg.topology().n_machines == cfg.n_machines
        assert cfg.device == "cuda"  # entry points default to the card
        assert get_serving_preset(name) is preset
    with pytest.raises(KeyError):
        get_serving_preset("nope")


def test_simconfig_flat_kwargs_round_trip():
    from repro_torch.core.simulator import MetricsConfig, MigrationConfig, SimConfig

    flat_kwargs = dict(
        policy="nomora", solver="auction", backend="auction_host", round_interval_s=2,
        migration_interval_s=20, perf_sample_interval_s=30, seed=9, max_round_tasks=256,
        failures=((10, 3),), straggler_threshold=0.8, fixed_algo_s=0.0,
        streaming_metrics=True, perf_reservoir_k=4, whatif_betas=(0.0, 1.0),
        device_latency=False, migration_controller=False, qos_threshold=0.85,
        qos_window=3, qos_clear_margin=0.05, qos_hold_s=10.0, migration_budget=32,
    )
    cfg = SimConfig(**flat_kwargs)
    for k, v in flat_kwargs.items():
        assert getattr(cfg, k) == v, k
    grouped = SimConfig(
        policy="nomora", solver="auction", backend="auction_host", round_interval_s=2,
        seed=9, max_round_tasks=256, failures=((10, 3),), device_latency=False,
        migration=MigrationConfig(
            interval_s=20, straggler_threshold=0.8, whatif_betas=(0.0, 1.0),
            controller=False, qos_threshold=0.85, qos_window=3, qos_clear_margin=0.05,
            qos_hold_s=10.0, budget=32),
        metrics=MetricsConfig(streaming=True, perf_reservoir_k=4,
                              perf_sample_interval_s=30, fixed_algo_s=0.0),
    )
    assert grouped == cfg
    assert cfg.migration_cfg == grouped.migration_cfg
    assert cfg.metrics_cfg == grouped.metrics_cfg
    assert dataclasses.replace(cfg, seed=0).migration_interval_s == 20

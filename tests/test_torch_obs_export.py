"""Telemetry export in repro_torch: the Chrome trace-event mapping, its
validator, synthetic sub-slices and the audit JSONL, against
the reference's exporter on the same registry contents (equal documents),
and an instrumented controller replay on ``device="cpu"`` exporting a valid
trace (mirrors tests/test_obs.py)."""

import json

import pytest

torch = pytest.importorskip("torch")

from repro import obs as r_obs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import latency, simulator, topology, workload  # noqa: E402
from repro_torch.core.policy import PolicyParams  # noqa: E402


@pytest.fixture(autouse=True)
def _obs_isolated():
    """Every test starts disabled with an empty registry and leaves no
    state behind (the module flag is process-global)."""
    was = obs.enabled()
    obs.set_enabled(False)
    obs.reset()
    yield
    obs.set_enabled(was)
    obs.reset()


def _fill(tel, epoch):
    tel.epoch_ns = epoch
    tel.record_span("window", epoch + 1000, 8000, {"rounds": 2})
    tel.record_span("round", epoch + 1000, 4000, {"round": 0}, depth=1)
    tel.record_span("round", epoch + 5000, 4000, {"round": 1}, depth=1)
    tel.gauge("queue", 3.0, t_ns=epoch + 2000)
    tel.gauge("queue", 5.0, t_ns=epoch + 6000)
    tel.gauge("free", 7.0, t_ns=epoch + 6000)
    tel.add("hits", 2)
    tel.add("jit.backend_compiles", 3)
    tel.audit_event("controller_round", t=15.0, chosen_lane=2,
                    lanes=[{"lane": 0, "true_cost": 10}])


def test_export_equals_reference_on_the_same_registry(tmp_path):
    port, ref = obs.Telemetry(), r_obs.Telemetry()
    _fill(port, 10**12)
    _fill(ref, 10**12)
    doc, want = obs.export.to_chrome_trace(port), r_obs.export.to_chrome_trace(ref)
    assert json.dumps(doc, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert obs.export.validate_chrome_trace(doc) == []
    p, r = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    assert obs.export.save_audit_jsonl(str(p), port) == r_obs.export.save_audit_jsonl(
        str(r), ref) == 1
    assert p.read_text() == r.read_text()
    for bad in ({"no": "events"}, {"traceEvents": [{"ph": "X", "name": "x"}]}):
        assert obs.export.validate_chrome_trace(bad) == r_obs.export.validate_chrome_trace(
            bad) != []


def test_chrome_trace_export_schema(tmp_path):
    with obs.scope() as tel:
        with obs.span("round", t=1.0):
            with obs.span("phase"):
                pass
        obs.gauge("queue", 3.0)
        obs.gauge("queue", 5.0)
        obs.add("hits", 2)
        doc = obs.export.to_chrome_trace(tel)
        path = tmp_path / "trace.json"
        obs.export.save_chrome_trace(str(path), tel)
    assert obs.export.validate_chrome_trace(doc) == []
    assert obs.export.slice_names(doc) == {"round", "phase"}
    assert obs.export.counter_track_names(doc) == {"queue"}
    assert doc["otherData"]["counters"]["hits"] == 2.0
    assert obs.export.validate_chrome_trace(json.loads(path.read_text())) == []


def test_chrome_trace_validator_rejects_bad_docs():
    assert obs.export.validate_chrome_trace({"no": "events"})
    assert obs.export.validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "x"}]})
    bad = {"traceEvents": [
        {"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0.0, "dur": 10.0},
        {"ph": "X", "name": "b", "pid": 1, "tid": 1, "ts": 5.0, "dur": 10.0},
    ]}
    assert any("overlap" in p for p in obs.export.validate_chrome_trace(bad))


def test_record_span_synthetic_sublices_export():
    with obs.scope() as tel:
        t0 = tel.epoch_ns
        obs.record_span("window", t0 + 1000, 8000, {"rounds": 2})
        obs.record_span("round", t0 + 1000, 4000, {"round": 0}, depth=1)
        obs.record_span("round", t0 + 5000, 4000, {"round": 1}, depth=1)
        doc = obs.export.to_chrome_trace(tel)
    assert obs.export.validate_chrome_trace(doc) == []
    assert obs.export.slice_names(doc) == {"window", "round"}


def test_audit_jsonl_roundtrip(tmp_path):
    with obs.scope() as tel:
        obs.audit_event("controller_round", t=15.0, chosen_lane=2,
                        lanes=[{"lane": 0, "true_cost": 10}])
        obs.audit_event("controller_round", t=30.0, chosen_lane=0, lanes=[])
        path = tmp_path / "audit.jsonl"
        n = obs.export.save_audit_jsonl(str(path), tel)
    assert n == 2
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["t"] for r in recs] == [15.0, 30.0]
    assert recs[0]["kind"] == "controller_round"
    assert recs[0]["lanes"][0]["true_cost"] == 10


def test_jit_counters_stay_out_of_deterministic_snapshots():
    assert obs.NONDETERMINISTIC_PREFIXES == r_obs.NONDETERMINISTIC_PREFIXES
    with obs.scope():
        before = obs.counters()
        obs.add("a", 2)
        obs.add("jit.backend_compiles", 1)
        assert obs.counters_since(before) == {"a": 2.0}
        assert obs.jit_compiles() == 1.0


def test_export_acceptance_controller_replay(tmp_path):
    topo = topology.Topology(n_machines=64, machines_per_rack=8, racks_per_pod=4,
                             slots_per_machine=4)
    events = latency.LatencyEvents(hotspots=(latency.DriftingHotspot(
        start_s=30.0, end_s=220.0, rack0=0, drift_racks_per_s=8.0 / 240.0,
        width_racks=2, multiplier=6.0),))
    plane = latency.LatencyPlane.synthesize(topo, duration_s=240, seed=0, events=events)
    wl = workload.synth_workload(topo, duration_s=240, seed=1, target_utilisation=0.35)
    cfg = simulator.SimConfig(
        policy="nomora", backend="auction_windowed", seed=11, migration_interval_s=15,
        migration_controller=True, qos_threshold=0.95, qos_window=2, qos_hold_s=30.0,
        whatif_betas=(0.0, 100.0 / 3600.0),
        params=PolicyParams(preemption=True, beta_scale=0.0), device="cpu",
    )
    with obs.scope() as tel:
        metrics = simulator.Simulator(wl, plane, cfg).run()
        doc = obs.export.to_chrome_trace(tel)
        audit_path = tmp_path / "audit.jsonl"
        n_audit = obs.export.save_audit_jsonl(str(audit_path), tel)
    assert metrics.rounds >= 16
    assert obs.export.validate_chrome_trace(doc) == []
    tracks = obs.export.counter_track_names(doc)
    assert len(tracks) >= 6, tracks
    assert {"sim.queue_depth", "sim.free_slots", "sim.migrated_pct"} <= tracks
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    rounds = [e for e in slices if e["name"] == "sim.round"]
    assert len(rounds) >= 16

    def inside(parent, e):
        return (e["ts"] >= parent["ts"] - 1e-3
                and e["ts"] + e["dur"] <= parent["ts"] + parent["dur"] + 1e-3)

    phase_names = {"sim.build_state", "sim.apply", "sim.roots"}
    assert {e["name"] for e in slices
            if e["name"] in phase_names and any(inside(r, e) for r in rounds)} == phase_names
    solver = [e for e in slices if e["name"].startswith("solver.")]
    assert solver and any(any(inside(r, e) for r in rounds) for e in solver)
    assert any(e["name"] == "round_program.round" for e in slices)
    assert n_audit > 0
    recs = [json.loads(line) for line in audit_path.read_text().splitlines()]
    assert all(r["kind"] == "controller_round" for r in recs)
    assert recs[0]["lanes"][0]["frozen_baseline"] is True
    c = doc["otherData"]["counters"]
    assert c.get("auction.iterations", 0) > 0 and c.get("qos.triggers", 0) > 0
    assert c.get("sim.tasks_migrated", 0) == metrics.tasks_migrated
    assert c.get("controller.rounds", 0) == metrics.controller_rounds

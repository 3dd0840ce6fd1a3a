"""The sweep runner in repro_torch (``device="cpu"``).

Against the reference: a small grid's `SweepResult` equals the reference's
after `_scrub`, byte for byte as saved JSON once the wall-clock stamps are
dropped (the only fields a re-run may change under ``fixed_algo_s``), so
one merge applies to both packages. Then tests/test_sweep.py's runner
cases on the port: shard/merge equals a single run, and a spawn pool with
``workers=2`` equals ``workers=1``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro.core import sweep as r_sweep  # noqa: E402
from repro_torch.core import scenarios, topology  # noqa: E402
from repro_torch.core.sweep import (  # noqa: E402
    CellSpec,
    SweepResult,
    SweepSpec,
    _workload_for,
    load_sweep_result,
    merge_sweep_results,
    run_sweep,
    shard_cells,
    split_policy,
)

SPEC = dict(n_machines=16, machines_per_rack=8, racks_per_pod=2, duration_s=60,
            target_utilisation=0.5, fixed_algo_s=0.0)


def comparable(result):
    """Saved JSON without the wall-clock stamps."""
    d = result.to_jsonable()
    d.pop("wall_s")
    for c in d["cells"]:
        c.pop("wall_s")
    return json.dumps(d, sort_keys=True)


def test_spec_fields_equal_reference():
    assert [f for f in SweepSpec.__dataclass_fields__] == [
        f for f in r_sweep.SweepSpec.__dataclass_fields__]
    assert SweepSpec() == SweepResult.from_jsonable(
        r_sweep.SweepResult(spec=r_sweep.SweepSpec(), cells=[]).to_jsonable()).spec


@pytest.mark.parametrize("policies,scenario_names", [
    (("nomora:auction", "random", "nomora:mcmf"), ("baseline", "failure_bursts")),
    (("load_spreading", "nomora:auction_host"), ("google_trace",)),
])
def test_grid_equals_reference_after_scrub(policies, scenario_names):
    kw = dict(SPEC, policies=policies, seeds=(0, 1), scenarios=scenario_names)
    ref = r_sweep.run_sweep(r_sweep.SweepSpec(**kw))
    port = run_sweep(SweepSpec(**kw), device="cpu")
    assert comparable(port) == comparable(ref)
    # Cross-package merge: a reference shard and a port shard recombine.
    ref0 = r_sweep.run_sweep(r_sweep.SweepSpec(**kw), shard=(0, 2))
    port1 = run_sweep(SweepSpec(**kw), shard=(1, 2), device="cpu")
    mixed = merge_sweep_results([SweepResult.from_jsonable(ref0.to_jsonable()), port1])
    assert comparable(mixed) == comparable(ref)


def test_run_sweep_grid(tmp_path):
    spec = SweepSpec(n_machines=32, machines_per_rack=8, racks_per_pod=2, duration_s=90,
                     target_utilisation=0.5, policies=("random", "load_spreading"),
                     seeds=(0, 1), scenarios=("baseline", "failure_bursts"),
                     fixed_algo_s=0.0)
    msgs = []
    res = run_sweep(spec, progress=msgs.append, device="cpu")
    assert len(res.cells) == len(spec.cells()) == 8 == len(msgs)
    for cell in res.cells:
        assert cell.summary["tasks_placed"] > 0
        assert 0 < cell.summary["avg_app_perf_area"] <= 100.0
    assert res.cell("baseline", 0, "random").policy == "random"
    with pytest.raises(KeyError):
        res.cell("baseline", 0, "nomora")
    assert "failure_bursts" in res.table()
    path = tmp_path / "sweep.json"
    res.save(str(path))
    assert len(json.loads(path.read_text())["cells"]) == 8


def test_shard_merge_equals_single_run(tmp_path):
    spec = SweepSpec(**SPEC, policies=("random", "load_spreading"), seeds=(0, 1),
                     scenarios=("baseline", "google_trace"))
    cells = spec.cells()
    parts = [shard_cells(cells, (i, 3)) for i in range(3)]
    assert [c for p in parts for c in p] == cells
    assert max(len(p) for p in parts) - min(len(p) for p in parts) <= 1
    full = run_sweep(spec, device="cpu")
    shards = [run_sweep(spec, shard=(i, 3), device="cpu") for i in range(3)]
    merged = merge_sweep_results(shards)
    assert merged.shard is None and comparable(merged) == comparable(full)
    paths = []
    for s in shards:
        p = tmp_path / f"shard{s.shard[0]}.json"
        s.save(str(p))
        paths.append(str(p))
    loaded = [load_sweep_result(p) for p in paths]
    assert [r.shard for r in loaded] == [(i, 3) for i in range(3)]
    assert comparable(merge_sweep_results(loaded)) == comparable(full)


def test_shard_validation_errors():
    spec = SweepSpec(policies=("random",), seeds=(0,), scenarios=("baseline",))
    with pytest.raises(ValueError):
        shard_cells(spec.cells(), (2, 2))
    with pytest.raises(ValueError):
        shard_cells(spec.cells(), (0, 0))
    with pytest.raises(ValueError):
        merge_sweep_results([])
    a = run_sweep(spec, shard=(0, 2), device="cpu")
    with pytest.raises(ValueError):
        merge_sweep_results([a, a])
    with pytest.raises(ValueError):
        merge_sweep_results([run_sweep(spec, device="cpu")])


def test_spawn_pool_equals_sequential():
    """``workers=2`` (a spawn pool, each worker resolving the device from
    its cell's SimConfig) reproduces ``workers=1`` in grid order."""
    spec = SweepSpec(**SPEC, policies=("nomora:auction", "random"), seeds=(0, 1),
                     scenarios=("baseline",))
    seq = run_sweep(spec, device="cpu")
    par = run_sweep(spec, workers=2, device="cpu")
    assert [(c.scenario, c.seed, c.policy) for c in par.cells] == [
        (c.scenario, c.seed, c.label) for c in spec.cells()]
    assert comparable(par) == comparable(seq)


def test_cellspec_and_backend_per_cell():
    spec = SweepSpec(policies=("nomora", "nomora:mcmf"), seeds=(0, 1),
                     scenarios=("baseline",))
    cells = spec.cells()
    assert cells[0] == CellSpec("baseline", 0, "nomora", None)
    assert cells[1] == CellSpec("baseline", 0, "nomora", "mcmf")
    assert cells[1].label == "nomora:mcmf" and cells[2].seed == 1
    for c in cells:
        assert CellSpec.parse(c.scenario, c.seed, c.label) == c
    assert split_policy("nomora:mcmf") == ("nomora", "mcmf")
    res = run_sweep(SweepSpec(n_machines=16, machines_per_rack=8, racks_per_pod=2,
                              duration_s=45, target_utilisation=0.4,
                              policies=("nomora", "nomora:auction_host"), seeds=(0,),
                              scenarios=("baseline",), fixed_algo_s=0.0), device="cpu")
    scrubbed = res.to_jsonable()["cells"]
    assert scrubbed[0]["summary"]["tasks_placed"] > 0
    assert scrubbed[0]["summary"] == scrubbed[1]["summary"]


def test_scenario_workload_override_wins():
    topo = topology.Topology(n_machines=32, machines_per_rack=8, racks_per_pod=2,
                             slots_per_machine=4)
    hot = scenarios.Scenario(name="hot_util", description="utilisation override",
                             workload_kwargs={"target_utilisation": 0.95})
    spec = SweepSpec(n_machines=32, duration_s=60, target_utilisation=0.2)
    wl_hot = _workload_for(spec, topo, hot, seed=0)
    wl_base = _workload_for(spec, topo, scenarios.get_scenario("baseline"), seed=0)
    assert wl_hot.n_tasks_total > wl_base.n_tasks_total
    gt = _workload_for(spec, topo, scenarios.get_scenario("google_trace"), seed=0)
    assert gt.n_jobs_hint > 0  # a streamed cursor, not a Workload

"""repro_torch host modules against the reference, bit for bit: the perf
LUT and lookups, the latency plane (static and dynamic), workload
synthesis and the two baseline placements."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import latency as r_latency  # noqa: E402
from repro.core import perf_model as r_perf  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core import workload as r_workload  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import latency as t_latency  # noqa: E402
from repro_torch.core import perf_model as t_perf  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core import topology as t_topology  # noqa: E402
from repro_torch.core import workload as t_workload  # noqa: E402

TOPO_ARGS = dict(n_machines=96, machines_per_rack=16, racks_per_pod=3, slots_per_machine=4)
BOUNDARY_US = [0.0, 39.9, 44.9, 45.1, 995.0, 1005.0, -3.0]


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.int32)


def test_lut_bit_equal_to_reference():
    got = t_perf.perf_lut_table()
    want = np.asarray(r_perf.perf_lut_table())
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (4, 101)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("model", range(4))
def test_lookup_and_cost_at_boundaries(model):
    lat = np.asarray(BOUNDARY_US, np.float32)
    got_p = t_perf.lookup_perf(t_perf.perf_lut_table(), model, torch.from_numpy(lat))
    want_p = np.asarray(r_perf.lookup_perf(r_perf.perf_lut_table(), model, lat))
    assert np.array_equal(_bits(got_p.numpy()), _bits(want_p))
    got_c = t_perf.perf_to_cost(got_p)
    want_c = np.asarray(r_perf.perf_to_cost(want_p))
    assert got_c.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), want_c)


def _planes(kind):
    topo = r_topology.Topology(**TOPO_ARGS)
    if kind == "static":
        events = None
    else:
        events = r_latency.LatencyEvents(
            hotspots=(r_latency.DriftingHotspot(
                start_s=3, end_s=30, rack0=1, drift_racks_per_s=0.25,
                width_racks=2, multiplier=3.0,
            ),),
            regime=r_latency.RegimeSchedule(times=(10.0, 20.0), frac=0.5),
        )
    ref = r_latency.LatencyPlane.synthesize(topo, 40, seed=7, events=events)
    t_events = None if events is None else convert.from_reference(events)
    port = t_latency.LatencyPlane.synthesize(
        convert.from_reference(topo), 40, seed=7, events=t_events
    )
    return ref, port


@pytest.mark.parametrize("kind", ["static", "drifting_hotspot"])
def test_latency_rows_and_pairs_bit_identical(kind):
    ref, port = _planes(kind)
    assert np.array_equal(ref.series, port.series)
    assert np.array_equal(
        convert.from_reference(ref).series, port.series
    )
    rng = np.random.default_rng(0)
    roots = rng.integers(0, 96, size=5)
    a = rng.integers(0, 96, size=300)
    b = rng.integers(0, 96, size=300)
    for t in (0, 5, 12, 25, 39):
        r_rows, p_rows = ref.latency_rows(roots, t), port.latency_rows(roots, t)
        assert r_rows.dtype == p_rows.dtype == np.float32
        assert np.array_equal(_bits(r_rows), _bits(p_rows))
        assert np.array_equal(_bits(ref.latency_pairs(a, b, t)),
                              _bits(port.latency_pairs(a, b, t)))


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_workload_identical(seed):
    ref = r_workload.synth_workload(r_topology.Topology(**TOPO_ARGS), 120, seed=seed)
    port = t_workload.synth_workload(t_topology.Topology(**TOPO_ARGS), 120, seed=seed)
    assert port.duration_s == ref.duration_s and len(port.jobs) == len(ref.jobs)
    for a, b in zip(ref.jobs, port.jobs):
        assert (a.job_id, a.arrival_s, a.n_tasks, a.duration_s, a.perf_idx) == (
            b.job_id, b.arrival_s, b.n_tasks, b.duration_s, b.perf_idx
        )
    conv = convert.from_reference(ref)
    assert [vars(j) for j in conv.jobs] == [vars(j) for j in port.jobs]


# Below (16 machines) and above (4,096 machines) the dense-scan crossover.
@pytest.mark.parametrize("n_machines,n_tasks", [(16, 20), (4096, 64)])
@pytest.mark.parametrize("seed", [0, 1])
def test_baseline_placements_stream_identical(n_machines, n_tasks, seed):
    assert (n_machines * n_tasks <= r_policy.DENSE_SCAN_OPS) == (n_machines == 16)
    rng = np.random.default_rng(seed)
    free = rng.integers(0, 3, size=n_machines).astype(np.int32)
    counts = rng.integers(0, 6, size=n_machines).astype(np.int64)
    got = t_policy.random_placement(np.random.default_rng(seed + 10), n_tasks, free)
    want = r_policy.random_placement(np.random.default_rng(seed + 10), n_tasks, free)
    assert np.array_equal(got, want)
    got = t_policy.load_spreading_placement(counts, free, n_tasks)
    want = r_policy.load_spreading_placement(counts, free, n_tasks)
    assert np.array_equal(got, want)

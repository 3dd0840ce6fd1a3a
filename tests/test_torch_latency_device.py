"""The device latency oracle: `repro_torch.core.latency_device` against the
reference's `repro.core.latency_device.DeviceLatencyOracle` and the host
`LatencyPlane.latency_rows`, on a dynamic plane (a drifting rack hotspot
and two regime shifts), tolerance 0: rows, `stats()`, the pinned job bucket
and the LRU of per-root decompositions (``device="cpu"``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import latency as r_latency  # noqa: E402
from repro.core import latency_device as r_ld  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import latency_device as t_ld  # noqa: E402

TOPO = r_topology.Topology(
    n_machines=64, machines_per_rack=8, racks_per_pod=4, slots_per_machine=4
)
EVENTS = r_latency.LatencyEvents(
    hotspots=(
        r_latency.DriftingHotspot(start_s=10.0, end_s=80.0, rack0=3,
                                  drift_racks_per_s=0.2, width_racks=2, multiplier=5.0),
    ),
    regime=r_latency.RegimeSchedule(times=(30.0, 60.0), frac=0.5),
)
ROOTS = [0, 17, 33, 63, 17]
# Hotspot drift positions, both regime boundaries, the hotspot's end.
TIMES = (0, 6, 29, 30, 31, 59, 60, 80, 89)


@pytest.fixture(scope="module")
def planes():
    ref = r_latency.LatencyPlane.synthesize(TOPO, duration_s=90, seed=2, events=EVENTS)
    return ref, convert.from_reference(ref)


@pytest.mark.parametrize("t", TIMES)
def test_rows_equal_reference_oracle_and_host_rows(planes, t):
    ref_plane, plane = planes
    oracle = t_ld.DeviceLatencyOracle(plane, device="cpu")
    got = oracle.root_rows(ROOTS, t)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    got = got.numpy()
    assert np.array_equal(got, plane.latency_rows(ROOTS, t))
    want = np.asarray(r_ld.DeviceLatencyOracle(ref_plane).root_rows(ROOTS, t))
    assert got.shape == want.shape and np.array_equal(got, want)


def test_stats_and_lru_equal_reference_over_a_replay(planes):
    """The same query sequence gives the same upload and LRU accounting;
    the per-second upload stays incremental, never the (J, M) block."""
    ref_plane, plane = planes
    ref = r_ld.DeviceLatencyOracle(ref_plane)
    port = t_ld.DeviceLatencyOracle(plane, device="cpu")
    rng = np.random.default_rng(0)
    for t in range(0, 90, 3):
        roots = rng.integers(0, TOPO.n_machines, size=int(rng.integers(1, 12)))
        for _ in range(2):  # a second query in the same second re-uploads nothing
            got = port.root_rows(roots, t).numpy()
            assert np.array_equal(got, np.asarray(ref.root_rows(roots, t))), t
        assert port.stats() == ref.stats(), t
    st = port.stats()
    assert st["round_uploads"] == 30
    assert st["floats_per_round"] < TOPO.n_machines
    assert st["decomp_hits"] > 0 and st["naive_floats"] == st["rows_served"] * 64
    builds = st["decomp_builds"]
    port.root_rows(roots, 89)
    assert port.stats()["decomp_builds"] == builds


def test_pinned_bucket_pads_with_root_zero(planes):
    ref_plane, plane = planes
    ref = r_ld.DeviceLatencyOracle(ref_plane)
    port = t_ld.DeviceLatencyOracle(plane, device="cpu")
    for o in (ref, port):
        o.pin_jobs(9)  # bucket 16
    got = port.root_rows(ROOTS, 45)
    assert tuple(got.shape) == (16, TOPO.n_machines)
    got = got.numpy()
    assert np.array_equal(got, np.asarray(ref.root_rows(ROOTS, 45)))
    assert np.array_equal(got[: len(ROOTS)], plane.latency_rows(ROOTS, 45))
    assert (got[len(ROOTS):] == got[0]).all()
    assert port.stats() == ref.stats()
    # Unpinned, a bucket is cut back to the real rows.
    assert tuple(t_ld.DeviceLatencyOracle(plane, device="cpu").root_rows(ROOTS, 45).shape) == (
        len(ROOTS), TOPO.n_machines)


def test_lru_evicts_the_least_recent_decomposition(planes, monkeypatch):
    ref_plane, plane = planes
    monkeypatch.setattr(t_ld, "_DECOMP_CACHE_MAX", 4)
    monkeypatch.setattr(r_ld, "_DECOMP_CACHE_MAX", 4)
    ref = r_ld.DeviceLatencyOracle(ref_plane)
    port = t_ld.DeviceLatencyOracle(plane, device="cpu")
    for roots, t in (([1, 2], 0), ([3, 1], 1), ([5, 6, 7], 2), ([1, 2], 3), ([2], 31)):
        got = port.root_rows(roots, t).numpy()
        assert np.array_equal(got, np.asarray(ref.root_rows(roots, t)))
        assert port.stats() == ref.stats()
        assert len(port._decomp) == len(ref._decomp) <= 4
        assert list(port._decomp) == list(ref._decomp)
    # The regime epoch is part of the key: t = 31 rebuilt root 2.
    assert (2, 1) in port._decomp


def test_sim_counters_mirror_oracle_stats():
    """The simulator mirrors the oracle's accounting into ``oracle.*``
    counters, as the reference does."""
    from repro_torch import obs
    from repro_torch.core import latency, simulator, topology, workload

    topo = topology.Topology(32, 8, 2, slots_per_machine=4)
    plane = latency.LatencyPlane.synthesize(topo, 30, seed=1)
    wl = workload.synth_workload(topo, 30, seed=1, target_utilisation=0.5)
    cfg = simulator.SimConfig(backend="auction_windowed", device="cpu", device_latency=True,
                              fixed_algo_s=0.0, seed=3)
    with obs.scope():
        sim = simulator.Simulator(wl, plane, cfg)
        sim.run()
        c = obs.counters()
    st = sim.oracle.stats()
    assert st["round_uploads"] > 0
    for key in ("round_uploads", "uploaded_floats", "decomp_builds", "decomp_hits"):
        assert c[f"oracle.{key}"] == float(st[key]), key

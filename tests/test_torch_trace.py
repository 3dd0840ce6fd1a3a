"""Trace replay and streaming metrics in repro_torch.

Against the reference (tolerance 0): every cursor window for window
(synthetic, open-loop, the committed Google cluster-data v2 fixture and
hand-written CSVs), the streaming accumulators' states and summaries on the
same streams, and whole streamed replays' summaries. Then the port's own
contracts, mirroring tests/test_trace.py, tests/test_metrics_stream.py and
tests/test_metrics_stream_property.py at their sizes: a streamed replay
equals a materialised one bit for bit; quantile estimates lie within
``QUANTILE_RTOL`` of the bracketing order statistics (the tolerance the
reference's own tests allow, used here only where they use it); merges are
order-invariant.
"""

import gzip
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import latency as r_latency  # noqa: E402
from repro.core import metrics_stream as r_ms  # noqa: E402
from repro.core import simulator as r_sim  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core import trace as r_trace  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import latency, topology  # noqa: E402
from repro_torch.core.engine import JobTable, TaskTable  # noqa: E402
from repro_torch.core.metrics import SimMetrics, percentiles  # noqa: E402
from repro_torch.core.metrics_stream import (  # noqa: E402
    HIST_HI,
    HIST_LO,
    QUANTILE_RTOL,
    LogHistogram,
    P2Quantile,
    ReservoirSample,
    StreamingSimMetrics,
    StreamSeries,
    Welford,
)
from repro_torch.core.perf_model import APP_MODEL_INDEX  # noqa: E402
from repro_torch.core.policy import PolicyParams  # noqa: E402
from repro_torch.core.simulator import SimConfig, Simulator  # noqa: E402
from repro_torch.core.trace import (  # noqa: E402
    EVENT_FINISH,
    EVENT_SUBMIT,
    CsvTraceCursor,
    materialize,
    open_loop_trace,
    read_task_events,
    synth_trace,
)

R_TOPO = r_topology.Topology(
    n_machines=48, machines_per_rack=8, racks_per_pod=3, slots_per_machine=4
)
TOPO = convert.from_reference(R_TOPO)
FIXTURE = os.path.join(os.path.dirname(__file__), "data", "task_events_fixture.csv.gz")


def job_tuples(jobs):
    return [
        (j.job_id, j.arrival_s, j.n_tasks, j.duration_s, j.perf_idx, j.ml_arch)
        for j in jobs
    ]


def windows(cur):
    return [(lo, hi, job_tuples(jobs)) for lo, hi, jobs in cur.windows()]


def _same_summary(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k


# --------------------------------------------------------------------- #
# Cursors against the reference, window for window


@pytest.mark.parametrize("seed,duration,window", [(0, 600, 120), (3, 600, 150),
                                                  (5, 240, 60), (1, 3600, 3600)])
def test_synth_trace_windows_equal_reference(seed, duration, window):
    ref = r_trace.synth_trace(R_TOPO, duration, seed=seed, window_s=window)
    port = synth_trace(TOPO, duration, seed=seed, window_s=window)
    assert port.n_windows == ref.n_windows
    assert (port.n_jobs_hint, port.n_tasks_hint) == (ref.n_jobs_hint, ref.n_tasks_hint)
    assert windows(port) == windows(ref)
    assert job_tuples(port.jobs) == job_tuples(ref.jobs)


@pytest.mark.parametrize("rate,scale", [(0.5, 0.1), (2.0, 1.0)])
def test_open_loop_windows_equal_reference(rate, scale):
    ref = r_trace.open_loop_trace(R_TOPO, 120, rate, seed=4, duration_scale=scale)
    port = open_loop_trace(TOPO, 120, rate, seed=4, duration_scale=scale)
    assert windows(port) == windows(ref)
    assert job_tuples(port.jobs) == job_tuples(ref.jobs) == job_tuples(port.jobs)


def test_csv_fixture_equals_reference():
    ref = r_trace.CsvTraceCursor(topo=R_TOPO, duration_s=120, paths=(FIXTURE,))
    port = CsvTraceCursor(topo=TOPO, duration_s=120, paths=(FIXTURE,))
    assert job_tuples(port.jobs) == job_tuples(ref.jobs)
    assert (port.n_jobs_hint, port.n_tasks_hint) == (ref.n_jobs_hint, ref.n_tasks_hint)
    assert job_tuples(read_task_events([FIXTURE], trace_duration_s=120)) == job_tuples(
        r_trace.read_task_events([FIXTURE], trace_duration_s=120))


# --------------------------------------------------------------------- #
# Streaming accumulators against the reference, state for state

def adversarial_stream(rng: np.random.Generator, n: int) -> np.ndarray:
    """Zeros, heavy atoms, and 12 orders of magnitude in one stream."""
    kind = rng.integers(0, 4, size=n)
    out = np.zeros(n, np.float64)
    out[kind == 1] = 10.0 ** rng.uniform(-6, 9, size=int((kind == 1).sum()))
    out[kind == 2] = rng.choice([1.0, 2.0, 1e6], size=int((kind == 2).sum()))
    out[kind == 3] = rng.lognormal(0.0, 3.0, size=int((kind == 3).sum()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_accumulators_equal_reference(seed):
    rng = np.random.default_rng(300 + seed)
    v = adversarial_stream(rng, int(rng.integers(1, 400)))
    pairs = [(StreamSeries(), r_ms.StreamSeries()), (LogHistogram(), r_ms.LogHistogram())]
    for port, ref in pairs:
        (port.extend if hasattr(port, "extend") else port.add_many)(v)
        (ref.extend if hasattr(ref, "extend") else ref.add_many)(v)
    s_port, s_ref = pairs[0]
    _same_summary(s_port.summary(), s_ref.summary())
    h_port, h_ref = pairs[1]
    assert np.array_equal(h_port._pos, h_ref._pos)
    assert (h_port.count, h_port.zero_count, h_port.min, h_port.max) == (
        h_ref.count, h_ref.zero_count, h_ref.min, h_ref.max)
    for q in (0, 10, 50, 90, 99, 100):
        assert h_port.quantile(q) == h_ref.quantile(q)
    w, wr = Welford(), r_ms.Welford()
    p2, p2r = P2Quantile(0.9), r_ms.P2Quantile(0.9)
    res, resr = ReservoirSample(16, seed=seed), r_ms.ReservoirSample(16, seed=seed)
    for x in v:
        for acc in (w, wr, p2, p2r, res, resr):
            acc.add(float(x))
    assert (w.count, w.mean, w.var) == (wr.count, wr.mean, wr.var)
    assert p2.value == p2r.value or (math.isnan(p2.value) and math.isnan(p2r.value))
    assert res.values == resr.values


def test_streaming_simmetrics_equal_reference():
    port, ref = StreamingSimMetrics(reservoir_k=8, seed=2), r_ms.StreamingSimMetrics(
        reservoir_k=8, seed=2)
    rng = np.random.default_rng(0)
    for t in range(60):
        jobs = np.arange(6)
        perfs = rng.uniform(0.2, 1.0, size=6)
        for m in (port, ref):
            if t % 2:
                m.record_perf_bulk(jobs, perfs)
            else:
                for j, p in zip(jobs, perfs):
                    m.record_perf_sample(int(j), float(p))
            m.placement_latency_s.append(float(t))
            m.response_time_s.extend([float(t), 2.0 * t])
            m.tasks_placed += 2
    _same_summary(port.summary(), ref.summary())
    assert np.array_equal(port.job_averages(), ref.job_averages())
    assert port.job_reservoir(0).values == ref.job_reservoir(0).values


@pytest.mark.parametrize("policy,kw", [
    ("nomora", dict(backend="auction")),
    ("nomora", dict(backend="mcmf", migration_interval_s=30)),
    ("random", dict(perf_reservoir_k=4)),
])
def test_streamed_replay_summary_equals_reference(policy, kw):
    r_cur = r_trace.synth_trace(R_TOPO, 120, seed=2, window_s=40)
    cur = synth_trace(TOPO, 120, seed=2, window_s=40)
    r_plane = r_latency.LatencyPlane.synthesize(R_TOPO, duration_s=120, seed=1)
    params = dict(preemption=True, beta_scale=0.0) if "mcmf" in kw.values() else {}
    from repro.core.policy import PolicyParams as RParams

    common = dict(policy=policy, seed=3, fixed_algo_s=0.0, streaming_metrics=True, **kw)
    ref = r_sim.Simulator(r_cur, r_plane, r_sim.SimConfig(params=RParams(**params),
                                                          **common)).run()
    port = Simulator(cur, convert.from_reference(r_plane),
                     SimConfig(params=PolicyParams(**params), device="cpu",
                               **common)).run()
    assert isinstance(port, StreamingSimMetrics)
    assert port.tasks_placed > 0
    _same_summary(port.summary(), ref.summary())


def test_google_trace_scenario_replay_equals_reference():
    from repro.core import scenarios as r_scenarios
    from repro_torch.core import scenarios

    scn, r_scn = scenarios.get_scenario("google_trace"), r_scenarios.get_scenario(
        "google_trace")
    assert dict(scn.trace_kwargs) == dict(r_scn.trace_kwargs)
    r_cur = r_trace.synth_trace(R_TOPO, 90, seed=0, target_utilisation=0.6,
                                **r_scn.trace_kwargs)
    cur = synth_trace(TOPO, 90, seed=0, target_utilisation=0.6, **scn.trace_kwargs)
    r_plane = r_latency.LatencyPlane.synthesize(R_TOPO, duration_s=90, seed=0)
    ref = r_sim.Simulator(r_cur, r_plane, r_sim.SimConfig(
        fixed_algo_s=0.0, **r_scn.sim_config_kwargs(R_TOPO, 90, 0))).run()
    port = Simulator(cur, convert.from_reference(r_plane), SimConfig(
        fixed_algo_s=0.0, device="cpu", **scn.sim_config_kwargs(TOPO, 90, 0))).run()
    assert isinstance(port, StreamingSimMetrics)
    _same_summary(port.summary(), ref.summary())


# --------------------------------------------------------------------- #
# tests/test_trace.py on the port


def test_synth_trace_deterministic_and_reiterable():
    cur = synth_trace(TOPO, 600, seed=3, window_s=120)
    first = job_tuples(cur.jobs)
    assert first == job_tuples(cur.jobs)
    assert first == job_tuples(synth_trace(TOPO, 600, seed=3, window_s=120).jobs)
    assert first != job_tuples(synth_trace(TOPO, 600, seed=4, window_s=120).jobs)


def test_synth_trace_stream_shape():
    jobs = list(synth_trace(TOPO, 600, seed=0, window_s=120).jobs)
    assert len(jobs) > 4
    arrivals = [j.arrival_s for j in jobs]
    assert arrivals == sorted(arrivals)
    assert [j.job_id for j in jobs] == list(range(len(jobs)))
    for j in jobs:
        assert j.n_tasks >= 2
        assert 0.0 <= j.arrival_s < 0.9 * 600 or j.arrival_s == 0.0
        assert j.arrival_s + j.duration_s <= 600 + 1e-9
    assert [j for j in jobs if j.arrival_s == 0.0 and j.duration_s == 600.0]


def test_synth_trace_windows_partition_the_stream():
    cur = synth_trace(TOPO, 600, seed=1, window_s=150)
    assert cur.n_windows == 4
    stitched = []
    for lo, hi, jobs in cur.windows():
        for j in jobs:
            assert (lo <= j.arrival_s < hi) or (lo == 0 and j.arrival_s == 0.0)
        stitched.extend(jobs)
    assert job_tuples(stitched) == job_tuples(cur.jobs)


@pytest.mark.parametrize("policy", ["random", "nomora"])
def test_cursor_replay_bit_identical_to_materialized(policy):
    cur = synth_trace(TOPO, 300, seed=0, window_s=60)
    wl = materialize(cur)
    plane = latency.LatencyPlane.synthesize(TOPO, duration_s=300, seed=1)
    cfg = SimConfig(policy=policy, seed=2, fixed_algo_s=0.0, device="cpu")
    a = Simulator(cur, plane, cfg).run()
    b = Simulator(wl, plane, cfg).run()
    assert a.tasks_placed == b.tasks_placed > 0
    assert a.placement_latency_s == b.placement_latency_s
    assert a.response_time_s == b.response_time_s
    assert a.per_job_perf == b.per_job_perf


def test_task_table_grows_preserving_state_and_sentinels():
    tt = TaskTable(capacity=4)
    ids = tt.append_job(0, 3, submit_s=1.0)
    tt.machine[ids] = 7
    tt.append_job(1, 10, submit_s=2.0)
    assert tt.capacity >= 13 and tt.n == 13
    assert (tt.machine[ids] == 7).all()
    assert (tt.machine[3:13] == -1).all()
    assert (tt.start_s[tt.n:] == -1.0).all()
    jt = JobTable(capacity=1)
    for j in range(5):
        jt.append(j, 10.0, 0, 2)
    assert jt.n == 5 and (jt.root_machine[jt.n:] == -1).all()


def test_simulator_survives_understated_hints():
    cur = synth_trace(TOPO, 240, seed=5, window_s=60)

    class TinyHints:
        topo = cur.topo
        duration_s = cur.duration_s
        n_jobs_hint = 1
        n_tasks_hint = 1

        @property
        def jobs(self):
            return cur.jobs

    plane = latency.LatencyPlane.synthesize(TOPO, duration_s=240, seed=1)
    cfg = SimConfig(policy="random", seed=0, fixed_algo_s=0.0, device="cpu")
    a = Simulator(TinyHints(), plane, cfg).run()
    b = Simulator(materialize(cur), plane, cfg).run()
    assert a.placement_latency_s == b.placement_latency_s
    assert a.per_job_perf == b.per_job_perf


def _write_task_events(path, rows, compress=False):
    """rows: (time_us, job_id, task_index, event_type)."""
    lines = []
    for t_us, jid, ti, ev in rows:
        row = [""] * 13
        row[0], row[2], row[3], row[5] = str(t_us), str(jid), str(ti), str(ev)
        lines.append(",".join(row))
    data = ("\n".join(lines) + "\n").encode()
    if compress:
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


TRACE_ROWS = [
    (5_000_000, 1001, 0, EVENT_SUBMIT),
    (5_000_000, 1001, 1, EVENT_SUBMIT),
    (5_000_000, 1001, 2, EVENT_SUBMIT),
    (65_000_000, 1001, 0, EVENT_FINISH),
    (1_000_000, 42, 0, EVENT_SUBMIT),
    (1_000_000, 42, 1, EVENT_SUBMIT),
    (2_000_000, 7, 0, EVENT_SUBMIT),
]


@pytest.mark.parametrize("compress", [False, True])
def test_read_task_events(tmp_path, compress):
    path = tmp_path / ("events.csv.gz" if compress else "events.csv")
    _write_task_events(path, TRACE_ROWS, compress=compress)
    jobs = read_task_events([str(path)], trace_duration_s=120)
    assert [j.job_id for j in jobs] == [0, 1]
    assert [j.n_tasks for j in jobs] == [2, 3]
    assert jobs[0].arrival_s == 1.0 and jobs[1].arrival_s == 5.0
    assert jobs[0].duration_s == 119.0
    assert jobs[1].duration_s == 60.0
    assert all(j.perf_idx in set(APP_MODEL_INDEX.values()) for j in jobs)
    assert job_tuples(jobs) == job_tuples(
        r_trace.read_task_events([str(path)], trace_duration_s=120))


def test_csv_cursor_replays(tmp_path):
    path = tmp_path / "events.csv"
    _write_task_events(path, TRACE_ROWS)
    cur = CsvTraceCursor(topo=TOPO, duration_s=120, paths=(str(path),))
    assert job_tuples(cur.jobs) == job_tuples(cur.jobs)
    plane = latency.LatencyPlane.synthesize(TOPO, duration_s=120, seed=0)
    metrics = Simulator(cur, plane, SimConfig(policy="random", seed=0, fixed_algo_s=0.0,
                                              device="cpu")).run()
    assert metrics.tasks_placed == 5


FIXTURE_GOLDEN = [
    (0, 0.5, 3, 79.5, 3, None),
    (1, 2.0, 4, 93.0, 1, None),
    (2, 5.0, 2, 65.0, 0, None),
    (3, 30.0, 2, 90.0, 0, None),
]


def test_committed_fixture_cursor_end_to_end():
    cur = CsvTraceCursor(topo=TOPO, duration_s=120, paths=(FIXTURE,))
    assert job_tuples(cur.jobs) == FIXTURE_GOLDEN
    assert job_tuples(cur.jobs) == FIXTURE_GOLDEN
    assert cur.n_jobs_hint == len(FIXTURE_GOLDEN)
    assert cur.n_tasks_hint == sum(g[2] for g in FIXTURE_GOLDEN)
    plane = latency.LatencyPlane.synthesize(TOPO, duration_s=120, seed=0)
    cfg = SimConfig(policy="nomora", seed=0, fixed_algo_s=0.0, device="cpu")
    sim = Simulator(cur, plane, cfg)
    metrics = sim.run()
    assert sim.jt.n == len(FIXTURE_GOLDEN)
    assert metrics.tasks_placed == sum(g[2] for g in FIXTURE_GOLDEN)
    m2 = Simulator(materialize(CsvTraceCursor(topo=TOPO, duration_s=120,
                                              paths=(FIXTURE,))), plane, cfg).run()
    assert metrics.placement_latency_s == m2.placement_latency_s
    assert metrics.response_time_s == m2.response_time_s
    assert metrics.per_job_perf == m2.per_job_perf
    r_plane = r_latency.LatencyPlane.synthesize(R_TOPO, duration_s=120, seed=0)
    ref = r_sim.Simulator(r_trace.CsvTraceCursor(topo=R_TOPO, duration_s=120,
                                                 paths=(FIXTURE,)), r_plane,
                          r_sim.SimConfig(policy="nomora", seed=0, fixed_algo_s=0.0)).run()
    _same_summary(metrics.summary(), ref.summary())


# --------------------------------------------------------------------- #
# tests/test_metrics_stream.py on the port


def assert_quantile_bracketed(est: float, values: np.ndarray, q: float) -> None:
    """`est` within QUANTILE_RTOL of the order statistics bracketing q."""
    lo = np.percentile(values, q, method="lower")
    hi = np.percentile(values, q, method="higher")
    assert lo * (1 - QUANTILE_RTOL) - 1e-12 <= est <= hi * (1 + QUANTILE_RTOL) + 1e-12


@pytest.mark.parametrize("seed", range(8))
def test_welford_and_histogram_against_numpy(seed):
    rng = np.random.default_rng(seed)
    v = adversarial_stream(rng, int(rng.integers(1, 400)))
    w = Welford()
    for x in v:
        w.add(float(x))
    assert w.count == len(v)
    np.testing.assert_allclose(w.mean, v.mean(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(w.var, v.var(), rtol=1e-7, atol=1e-9)
    wb = Welford()
    wb.add_many(v)
    np.testing.assert_allclose(wb.mean, w.mean, rtol=1e-9, atol=1e-12)
    h = LogHistogram()
    h.add_many(v)
    assert h.count == len(v) and h.min == v.min() and h.max == v.max()
    for q in (50.0, 90.0, 99.0):
        assert_quantile_bracketed(h.quantile(q), v, q)


@pytest.mark.parametrize("seed", range(6))
def test_stream_series_merge_order_invariant(seed):
    rng = np.random.default_rng(200 + seed)
    v = adversarial_stream(rng, int(rng.integers(2, 400)))
    whole = StreamSeries()
    whole.extend(v)
    bounds = np.sort(rng.integers(0, len(v) + 1, size=int(rng.integers(2, 6)) - 1))
    pieces = np.split(v, bounds)
    rng.shuffle(pieces)
    merged = StreamSeries()
    for p in pieces:
        s = StreamSeries()
        s.extend(p)
        merged.merge(s)
    assert merged.count == whole.count and merged.max == whole.max
    np.testing.assert_allclose(merged.mean, whole.mean, rtol=1e-9, atol=1e-12)
    for q in (50, 90, 99):
        assert merged.quantile(q) == whole.quantile(q)


def test_histogram_domain_edges_and_small_estimators():
    h = LogHistogram()
    h.add_many(np.asarray([HIST_LO / 10, HIST_HI * 10, -3.0, 0.0]))
    assert h.count == 4
    assert h.quantile(0) == -3.0 and h.quantile(100) == HIST_HI * 10
    assert h.quantile(40) == 0.0
    q = P2Quantile(0.5)
    assert np.isnan(q.value)
    for x in (3.0, 1.0, 2.0):
        q.add(x)
    assert q.value == 2.0
    with pytest.raises(ValueError):
        P2Quantile(0.0)
    r1, r2 = ReservoirSample(16, seed=3), ReservoirSample(16, seed=3)
    for x in range(1000):
        r1.add(float(x))
        r2.add(float(x))
    assert len(r1.values) == 16 and r1.count == 1000 and r1.values == r2.values
    exact, stream = percentiles([]), StreamSeries().summary()
    assert set(stream) == set(exact) and all(np.isnan(v) for v in stream.values())


def test_p2_quantile_on_smooth_distributions():
    rng = np.random.default_rng(7)
    for dist in (rng.normal(100.0, 15.0, 5000), rng.lognormal(1.0, 0.5, 5000)):
        for p in (0.5, 0.9, 0.99):
            est = P2Quantile(p)
            for x in dist:
                est.add(float(x))
            exact = np.percentile(dist, 100 * p)
            assert abs(est.value - exact) <= 0.05 * (dist.max() - dist.min())


def test_streaming_simmetrics_merge_matches_whole():
    rng = np.random.default_rng(1)
    whole = StreamingSimMetrics()
    parts = [StreamingSimMetrics() for _ in range(3)]
    for i in range(300):
        j, p, rt = int(rng.integers(0, 12)), float(rng.uniform()), float(
            rng.lognormal(3.0, 1.0))
        for m in (whole, parts[i % 3]):
            m.record_perf_sample(j, p)
            m.response_time_s.append(rt)
            m.tasks_placed += 1
    merged = parts[1]
    merged.merge(parts[2])
    merged.merge(parts[0])
    sw, sm = whole.summary(), merged.summary()
    assert set(sw) == set(sm)
    for k in ("tasks_placed", "jobs_measured", "response_time_s_max",
              "response_time_s_p50", "response_time_s_p90", "response_time_s_p99"):
        assert sm[k] == sw[k], k
    np.testing.assert_allclose(sm["avg_app_perf_area"], sw["avg_app_perf_area"], rtol=1e-9)


def test_simulator_streaming_vs_exact_tolerance():
    """One replay, both metric engines: identical schema; quantiles within
    QUANTILE_RTOL of the bracketing order statistics, the rest within
    float tolerance (the reference test's own bounds)."""
    from repro_torch.core.workload import synth_workload

    wl = synth_workload(TOPO, duration_s=240, seed=5, target_utilisation=0.6)
    plane = latency.LatencyPlane.synthesize(TOPO, duration_s=240, seed=2)
    cfg = dict(policy="nomora", seed=5, fixed_algo_s=0.0, device="cpu")
    m_exact = Simulator(wl, plane, SimConfig(**cfg)).run()
    m_stream = Simulator(wl, plane, SimConfig(streaming_metrics=True, **cfg)).run()
    assert isinstance(m_exact, SimMetrics) and isinstance(m_stream, StreamingSimMetrics)
    se, ss = m_exact.summary(), m_stream.summary()
    assert set(se) == set(ss)
    exact_series = {
        "algo_runtime_s": m_exact.algo_runtime_s,
        "placement_latency_s": m_exact.placement_latency_s,
        "response_time_s": m_exact.response_time_s,
        "migrated_pct": m_exact.migrated_pct_per_round,
        "controller_improvement": m_exact.controller_improvement_per_round,
        "degraded_jobs": m_exact.degraded_jobs_per_round,
    }
    qkeys = {f"{n}_p{q}": (n, q) for n in exact_series for q in (50, 90, 99)}
    for k in se:
        a, b = se[k], ss[k]
        if np.isnan(a):
            assert np.isnan(b), k
        elif k in qkeys:
            name, q = qkeys[k]
            assert_quantile_bracketed(b, np.asarray(exact_series[name]), q)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9, err_msg=k)


def test_streaming_replay_keeps_bounded_accumulators():
    from repro_torch.core.workload import synth_workload

    topo = topology.Topology(n_machines=48, machines_per_rack=8, racks_per_pod=2,
                             slots_per_machine=4)
    plane = latency.LatencyPlane.synthesize(topo, duration_s=180, seed=2)
    wl = synth_workload(topo, duration_s=180, seed=3, target_utilisation=0.5)
    cfg = SimConfig(policy="nomora", params=PolicyParams(preemption=True, beta_scale=0.0),
                    straggler_threshold=0.99, perf_sample_interval_s=10,
                    migration_interval_s=30, seed=4, fixed_algo_s=0.0,
                    streaming_metrics=True, device="cpu")
    sim = Simulator(wl, plane, cfg)
    m = sim.run()
    for name in ("algo_runtime_s", "placement_latency_s", "response_time_s",
                 "migrated_pct_per_round", "controller_improvement_per_round",
                 "degraded_jobs_per_round"):
        assert isinstance(getattr(m, name), StreamSeries), name
    assert m.rounds > 0
    done_ids = {int(sim.jt.job_id[j]) for j in range(sim.jt.n) if sim.jt.done[j]}
    assert done_ids
    assert not (set(sim.straggler._ewma) & done_ids)
    assert not (set(sim.straggler._below) & done_ids)


# --------------------------------------------------------------------- #
# tests/test_metrics_stream_property.py on the port

samples = st.lists(
    st.one_of(st.just(0.0), st.floats(min_value=1e-6, max_value=1e9),
              st.sampled_from([1.0, 1.0, 2.0, 1e6])),
    min_size=1, max_size=300,
)


@given(samples, st.sampled_from([50.0, 90.0, 99.0]))
@settings(max_examples=100, deadline=None)
def test_histogram_quantiles_bracketed_property(xs, q):
    v = np.asarray(xs, np.float64)
    h = LogHistogram()
    h.add_many(v)
    assert h.count == len(xs) and h.min == v.min() and h.max == v.max()
    assert_quantile_bracketed(h.quantile(q), v, q)
    ref = r_ms.LogHistogram()
    ref.add_many(v)
    assert h.quantile(q) == ref.quantile(q)


@given(samples, st.integers(min_value=2, max_value=5), st.randoms())
@settings(max_examples=75, deadline=None)
def test_histogram_merge_order_invariant_property(xs, n_shards, rnd):
    v = np.asarray(xs, np.float64)
    whole = LogHistogram()
    whole.add_many(v)
    bounds = sorted(rnd.randrange(0, len(xs) + 1) for _ in range(n_shards - 1))
    pieces = np.split(v, bounds)
    rnd.shuffle(pieces)
    merged = LogHistogram()
    for p in pieces:
        shard = LogHistogram()
        shard.add_many(p)
        merged.merge(shard)
    assert merged.count == whole.count and merged.zero_count == whole.zero_count
    assert merged.min == whole.min and merged.max == whole.max
    for q in (50, 90, 99):
        assert merged.quantile(q) == whole.quantile(q)


@given(samples)
@settings(max_examples=100, deadline=None)
def test_welford_matches_numpy_property(xs):
    v = np.asarray(xs, np.float64)
    w = Welford()
    for x in xs:
        w.add(x)
    np.testing.assert_allclose(w.mean, v.mean(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(w.var, v.var(), rtol=1e-7, atol=1e-9)

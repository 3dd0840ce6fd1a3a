"""repro_torch auction solver against the reference: assignments, iteration
counts and total cost, host and device solves, production (tie jitter,
inexact) and exact modes, through both conflict-resolution strategies."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import auction as r_auction  # noqa: E402
from repro.core import latency as r_latency  # noqa: E402
from repro.core import perf_model as r_perf  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import auction as t_auction  # noqa: E402
from repro_torch.core import perf_model as t_perf  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402

R_LUT = r_perf.perf_lut_table()
T_LUT = t_perf.perf_lut_table()
TOPO = r_topology.Topology(
    n_machines=52, machines_per_rack=8, racks_per_pod=3, slots_per_machine=4
)
PLANE = r_latency.LatencyPlane.synthesize(TOPO, duration_s=20, seed=0)
MODES = {
    "production": dict(tie_jitter=9, exact=False),
    "exact": dict(tie_jitter=0, exact=True),
}


def _state(rng, T, J):
    roots = rng.integers(0, TOPO.n_machines, size=J)
    return r_policy.RoundState(
        task_job=np.sort(rng.integers(0, J, size=T)),
        perf_idx=rng.integers(0, 4, size=T),
        root_machine=roots,
        root_latency=np.stack([PLANE.latency_from(int(m), 3) for m in roots]),
        wait_s=rng.uniform(0, 100, size=T).astype(np.float32),
        run_s=np.zeros(T, np.float32),
        cur_machine=np.full(T, -1, np.int64),
        free_slots=rng.integers(0, 4, size=TOPO.n_machines).astype(np.int32),
    )


def _same(a, b):
    assert np.array_equal(a.assigned_col, b.assigned_col)
    assert a.total_cost == b.total_cost
    assert a.iterations == b.iterations


# The padded task count Tp picks the strategy: Tp*Tp <= 4*M (= 208) takes
# the (T, T) dominance table (Tp = 8), larger buckets the segment path.
@pytest.mark.parametrize(
    "T,strategy", [(5, "T-space"), (8, "T-space"), (12, "M-space"), (15, "M-space")]
)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", range(2))
def test_solves_match_reference(T, strategy, mode, seed):
    Tp = t_auction._bucket(T)
    assert (Tp * Tp <= 4 * TOPO.n_machines) == (strategy == "T-space")
    rng = np.random.default_rng(100 + 7 * seed + T)
    state = _state(rng, T, J=2)
    params = r_policy.PolicyParams()
    kw = MODES[mode]
    M = TOPO.n_machines
    host = r_policy.dense_costs(state, TOPO, params, R_LUT)
    want = r_auction.solve_transportation(
        host.w, host.col_capacity[:M], M, M + state.task_job,
        slots_per_machine=TOPO.slots_per_machine, **kw,
    )
    r_wm, r_a, *_ = r_policy.device_round_costs(
        state, TOPO, params, R_LUT, n_pad_tasks=Tp, n_pad_jobs=8
    )
    want_dev = r_auction.solve_transportation_device(
        r_wm, r_a, T, state.free_slots, M, state.task_job,
        slots_per_machine=TOPO.slots_per_machine, **kw,
    )
    _same(want, want_dev)

    got = t_auction.solve_transportation(
        host.w, host.col_capacity[:M], M, M + state.task_job,
        slots_per_machine=TOPO.slots_per_machine, device="cpu", **kw,
    )
    _same(want, got)
    t_state, t_topo, t_params = map(convert.from_reference, (state, TOPO, params))
    w_m, a, *_ = t_policy.device_round_costs(
        t_state, t_topo, t_params, T_LUT, n_pad_tasks=Tp, n_pad_jobs=8
    )
    got_dev = t_auction.solve_transportation_device(
        w_m, a, T, state.free_slots, M, state.task_job,
        slots_per_machine=TOPO.slots_per_machine, **kw,
    )
    _same(want, got_dev)
    assert np.array_equal(np.asarray(want_dev.prices), got_dev.prices.numpy())


def test_jitter_matrix_matches_reference():
    for shape in ((8, 52), (33, 100)):
        assert np.array_equal(
            t_auction._jitter_device(*shape, 9, "cpu").numpy(),
            r_auction._jitter_matrix_np(*shape, 9),
        )
    assert [t_auction._bucket(n) for n in (0, 1, 8, 9, 1000, 1025)] == [
        r_auction._bucket(n) for n in (0, 1, 8, 9, 1000, 1025)
    ]


@pytest.mark.parametrize("tie_jitter", [9, 2, 7, 1000, 2**31 - 1])
def test_device_jitter_matches_reference(tie_jitter):
    """The jitter hashed on a device (32-bit halves in int64) gives the
    reference's numpy uint64 bits, across several row chunks."""
    for shape in ((8, 52), (600, 333)):
        got = t_auction._jitter_device(*shape, tie_jitter, "cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), r_auction._jitter_matrix_np(*shape, tie_jitter))

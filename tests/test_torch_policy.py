"""repro_torch cost model against the reference's numpy `dense_costs`, bit
for bit: the host path, the device path on CPU tensors (every field,
dtypes included), and padded round costs sliced back to the real rows."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import latency as r_latency  # noqa: E402
from repro.core import perf_model as r_perf  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import perf_model as t_perf  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402

R_LUT = r_perf.perf_lut_table()
T_LUT = t_perf.perf_lut_table()

# Full racks and a partial last rack (52 = 6.5 racks of 8).
TOPO_FULL = r_topology.Topology(
    n_machines=64, machines_per_rack=8, racks_per_pod=4, slots_per_machine=4
)
TOPO_PARTIAL = r_topology.Topology(
    n_machines=52, machines_per_rack=8, racks_per_pod=3, slots_per_machine=4
)
PLANES = {
    topo.n_machines: r_latency.LatencyPlane.synthesize(topo, duration_s=20, seed=0)
    for topo in (TOPO_FULL, TOPO_PARTIAL)
}
FIELDS = ("w", "col_capacity", "d", "c_rack", "b", "a")


def _state(rng, topo, T=14, J=3, preempt_running=False):
    plane = PLANES[topo.n_machines]
    roots = rng.integers(0, topo.n_machines, size=J)
    cur = np.full(T, -1, np.int64)
    run_s = np.zeros(T, np.float32)
    if preempt_running:
        cur[: T // 2] = rng.integers(0, topo.n_machines, size=T // 2)
        run_s[: T // 2] = rng.uniform(0, 7200, size=T // 2)
    return r_policy.RoundState(
        task_job=np.sort(rng.integers(0, J, size=T)),
        perf_idx=rng.integers(0, 4, size=T),
        root_machine=roots,
        root_latency=np.stack([plane.latency_from(int(m), 3) for m in roots]),
        wait_s=rng.uniform(0, 100, size=T).astype(np.float32),
        run_s=run_s,
        cur_machine=cur,
        free_slots=rng.integers(0, 4, size=topo.n_machines).astype(np.int32),
    )


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(want, got, label):
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), _as_np(getattr(got, f))
        assert w.shape == g.shape, (label, f)
        assert w.dtype == g.dtype, (label, f)
        assert np.array_equal(w, g), f"{label}: {f} diverged"


@pytest.mark.parametrize("topo", [TOPO_FULL, TOPO_PARTIAL], ids=["full", "partial"])
@pytest.mark.parametrize("preempt", [False, True], ids=["nopre", "pre"])
@pytest.mark.parametrize("seed", range(5))
def test_dense_costs_bit_identical(topo, preempt, seed):
    rng = np.random.default_rng(seed)
    T = int(rng.integers(3, 24))
    J = int(rng.integers(1, 5))
    state = _state(rng, topo, T=T, J=J, preempt_running=preempt)
    params = r_policy.PolicyParams(preemption=preempt)
    want = r_policy.dense_costs(state, topo, params, R_LUT)
    t_state, t_topo, t_params = map(convert.from_reference, (state, topo, params))
    _assert_same(want, t_policy.dense_costs(t_state, t_topo, t_params, T_LUT), "host")
    dev = t_policy.dense_costs_device(t_state, t_topo, t_params, T_LUT, device="cpu")
    _assert_same(want, dev, "device")


def test_dense_costs_beta_zero_and_unsched_cap():
    rng = np.random.default_rng(42)
    state = _state(rng, TOPO_PARTIAL, T=12, J=2, preempt_running=True)
    t_state, t_topo = convert.from_reference(state), convert.from_reference(TOPO_PARTIAL)
    for params in (
        r_policy.PolicyParams(preemption=True, beta_scale=0.0),
        r_policy.PolicyParams(unsched_capacity=1),
        r_policy.PolicyParams(p_m=120, p_r=125),
    ):
        want = r_policy.dense_costs(state, TOPO_PARTIAL, params, R_LUT)
        got = t_policy.dense_costs_device(
            t_state, t_topo, convert.from_reference(params), T_LUT, device="cpu"
        )
        _assert_same(want, got, str(params))


@pytest.mark.parametrize("preempt", [False, True], ids=["nopre", "pre"])
def test_padded_device_costs_slice_to_unpadded(preempt):
    """The backend's bucketed pipeline == exact shapes == the reference's
    padded pipeline, on the real rows."""
    rng = np.random.default_rng(3)
    state = _state(rng, TOPO_FULL, T=11, J=3, preempt_running=preempt)
    params = r_policy.PolicyParams(preemption=preempt)
    ref_padded = r_policy.device_round_costs(
        state, TOPO_FULL, params, R_LUT, n_pad_tasks=32, n_pad_jobs=8
    )
    t_state, t_topo, t_params = map(convert.from_reference, (state, TOPO_FULL, params))
    exact = t_policy.device_round_costs(t_state, t_topo, t_params, T_LUT)
    padded = t_policy.device_round_costs(
        t_state, t_topo, t_params, T_LUT, n_pad_tasks=32, n_pad_jobs=8
    )
    T = state.n_tasks
    for e, p, r in zip(exact, padded, ref_padded):
        assert np.array_equal(e.numpy(), p.numpy()[:T])
        assert p.numpy().dtype == np.asarray(r).dtype
        assert np.array_equal(p.numpy(), np.asarray(r))

"""The window program and the what-if lanes: `repro_torch.core.round_program`
against the reference's `repro.core.round_program` (its ``jax.lax.scan``
and ``jax.vmap`` on jax-cpu) and against the port's own per-round path, on
the same seeded rounds, tolerance 0: assignments, iteration counts, per-task
jittered, true and stay costs, lane outcomes, the chained carry's free
slots, and the `WindowedAuctionBackend` entry points (``device="cpu"``: the
plain versions of the kernels)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as r_obs  # noqa: E402
from repro.core import latency as r_latency  # noqa: E402
from repro.core import perf_model as r_perf_model  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import round_program as r_rp  # noqa: E402
from repro.core import scheduler_backend as r_sb  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.core import auction as t_auction  # noqa: E402
from repro_torch.core import latency_device as t_ld  # noqa: E402
from repro_torch.core import perf_model as t_perf_model  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core import round_program as t_rp  # noqa: E402
from repro_torch.core import scheduler_backend as t_sb  # noqa: E402

R_LUT = r_perf_model.perf_lut_table()
T_LUT = t_perf_model.perf_lut_table()
# Full racks (64 = 8 x 8) and a partial last rack (52 = 6.5 racks of 8).
R_TOPO_FULL = r_topology.Topology(
    n_machines=64, machines_per_rack=8, racks_per_pod=4, slots_per_machine=4
)
R_TOPO_PARTIAL = r_topology.Topology(
    n_machines=52, machines_per_rack=8, racks_per_pod=3, slots_per_machine=4
)
PLANES = {
    topo.n_machines: r_latency.LatencyPlane.synthesize(topo, duration_s=20, seed=0)
    for topo in (R_TOPO_FULL, R_TOPO_PARTIAL)
}
TP, JP = 32, 8


def _state(rng, topo, T=14, J=3, preempt_running=False):
    """A reference RoundState (the port's is `convert.from_reference` of it)."""
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


def _window_states(rng, topo, R, free_slots_per_round=None, preempt=False):
    """R random rounds against one cluster (varying T/J per round)."""
    states = []
    for r in range(R):
        s = _state(rng, topo, T=int(rng.integers(4, 20)), J=int(rng.integers(1, 4)),
                   preempt_running=preempt)
        if free_slots_per_round is not None:
            s.free_slots = free_slots_per_round[r].astype(np.int32)
        states.append(s)
    return states


def _programs(topo, params, **kw):
    """The reference's program and the port's on the CPU, same bucket."""
    ref = r_rp.RoundProgram(topo, params, R_LUT, n_pad_tasks=TP, n_pad_jobs=JP,
                            slots_per_machine=topo.slots_per_machine, **kw)
    port = t_rp.RoundProgram(convert.from_reference(topo), convert.from_reference(params),
                             T_LUT, n_pad_tasks=TP, n_pad_jobs=JP,
                             slots_per_machine=topo.slots_per_machine, device="cpu", **kw)
    return ref, port


def _per_round(state, topo, params, **solver_kw):
    """The port's per-round path (`auction` backend's round) on one state."""
    w_m, a, *_ = t_policy.device_round_costs(state, topo, params, T_LUT,
                                             n_pad_tasks=TP, n_pad_jobs=JP)
    return t_auction.solve_transportation_device(
        w_m, a, state.n_tasks, state.free_slots, topo.n_machines, state.task_job,
        slots_per_machine=topo.slots_per_machine, **solver_kw,
    )


def _assert_window_equal(ref, port):
    for f in ("assigned", "iterations", "per_task_cost", "per_task_true_cost"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ref.n_tasks == port.n_tasks


@pytest.mark.parametrize(
    "solver_kw",
    [dict(tie_jitter=9, exact=False), dict(tie_jitter=0, exact=True)],
    ids=["production", "exact"],
)
@pytest.mark.parametrize("preempt", [False, True], ids=["nopre", "pre"])
def test_window_equals_reference_and_sequential_rounds(solver_kw, preempt):
    rng = np.random.default_rng(7)
    topo = R_TOPO_PARTIAL
    states = _window_states(rng, topo, 6, preempt=preempt)
    params = r_policy.PolicyParams(preemption=preempt)
    ref, port = _programs(topo, params, **solver_kw)
    t_states = [convert.from_reference(s) for s in states]
    _, r_res = ref.advance(
        ref.init_state(states[0].free_slots),
        r_rp.stack_round_states(states, n_pad_tasks=TP, n_pad_jobs=JP,
                                exact=solver_kw["exact"]),
    )
    _, t_res = port.advance(
        port.init_state(states[0].free_slots),
        t_rp.stack_round_states(t_states, n_pad_tasks=TP, n_pad_jobs=JP,
                                exact=solver_kw["exact"]),
    )
    _assert_window_equal(r_res, t_res)
    t_topo, t_params = convert.from_reference(topo), convert.from_reference(params)
    for r, s in enumerate(t_states):
        seq = _per_round(s, t_topo, t_params, **solver_kw)
        assert np.array_equal(t_res.round_cols(r), seq.assigned_col), r
        assert t_res.round_objective(r) == seq.total_cost, r
        assert int(t_res.iterations[r]) == seq.iterations, r
        assert t_res.round_true_cost(r) == r_res.round_true_cost(r), r


def test_window_chained_slots_match_host_accounting_and_reference():
    """chain_slots=True: the device-carried occupancy (debited by each
    round's placements, credited by per-round deltas) reproduces a host
    loop that does the same accounting between sequential solves, and the
    reference's scanned carry."""
    rng = np.random.default_rng(11)
    topo = R_TOPO_FULL
    M = topo.n_machines
    free0 = rng.integers(1, 4, size=M).astype(np.int32)
    deltas = [np.zeros(M, np.int32)]
    for _ in range(4):
        d = np.zeros(M, np.int32)
        d[rng.integers(0, M, size=3)] += 1
        deltas.append(d)
    states = _window_states(rng, topo, 5, free_slots_per_round=deltas)
    params = r_policy.PolicyParams()
    ref, port = _programs(topo, params, tie_jitter=9, exact=False, chain_slots=True)
    r_st, r_res = ref.advance(ref.init_state(free0),
                              r_rp.stack_round_states(states, n_pad_tasks=TP, n_pad_jobs=JP))
    t_states = [convert.from_reference(s) for s in states]
    t_st, t_res = port.advance(port.init_state(free0),
                               t_rp.stack_round_states(t_states, n_pad_tasks=TP,
                                                       n_pad_jobs=JP))
    _assert_window_equal(r_res, t_res)
    assert t_st.free_slots.dtype == torch.int32
    assert np.array_equal(np.asarray(r_st.free_slots), t_st.free_slots.numpy())
    assert np.array_equal(np.asarray(r_st.assigned), t_st.assigned.numpy())
    assert np.array_equal(np.asarray(r_st.prices), t_st.prices.numpy())

    free = free0.copy()
    t_topo, t_params = convert.from_reference(topo), convert.from_reference(params)
    for r, s in enumerate(t_states):
        free = free + deltas[r]
        s.free_slots = free.copy().astype(np.int32)
        seq = _per_round(s, t_topo, t_params, tie_jitter=9, exact=False)
        assert np.array_equal(t_res.round_cols(r), seq.assigned_col), r
        cols = seq.assigned_col
        np.subtract.at(free, cols[cols < M], 1)
    assert np.array_equal(t_st.free_slots.numpy(), free)


def _assert_whatif_equal(ref, port):
    for f in ("assigned", "iterations", "per_task_cost", "per_task_true_cost",
              "per_task_stay_cost"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ref.n_tasks == port.n_tasks
    assert np.array_equal(ref.true_costs, port.true_costs)
    assert np.array_equal(ref.lane_outcomes(), port.lane_outcomes())
    assert ref.best_variant() == port.best_variant()


@pytest.mark.parametrize("seed", range(2))
def test_whatif_lanes_equal_reference_and_standalone_solves(seed):
    """Each of K `PolicyParams` lanes equals the reference's vmapped lane
    (iteration count included: its while_loop freezes finished lanes) and
    the port's per-round path run standalone under that variant."""
    rng = np.random.default_rng(13 + seed)
    topo = R_TOPO_PARTIAL
    state = _state(rng, topo, T=14, J=3, preempt_running=True)
    base = r_policy.PolicyParams(preemption=True)
    variants = [
        r_policy.PolicyParams(preemption=True, beta_scale=b)
        for b in (0.0, 100.0 / 3600.0, 400.0 / 3600.0)
    ] + [r_policy.PolicyParams(p_m=120, p_r=125)]
    ref, port = _programs(topo, base, tie_jitter=9, exact=False)
    r_res = ref.what_if(state, variants)
    t_state = convert.from_reference(state)
    t_variants = [convert.from_reference(v) for v in variants]
    t_res = port.what_if(t_state, t_variants)
    _assert_whatif_equal(r_res, t_res)
    assert t_res.active_masks is None
    t_topo = convert.from_reference(topo)
    for k, p in enumerate(t_variants):
        seq = _per_round(t_state, t_topo, p, tie_jitter=9, exact=False)
        assert np.array_equal(t_res.variant_cols(k), seq.assigned_col), k
        assert int(t_res.iterations[k]) == seq.iterations, k
        assert int(t_res.per_task_cost[k, : state.n_tasks].astype(np.int64).sum()) == (
            seq.total_cost), k
    best = t_res.best_variant()
    assert t_res.true_costs[best] == t_res.true_costs.min()


def test_whatif_mask_lanes_equal_reference_and_pin_frozen_rows():
    """Mover-mask lanes (the controller's solve axis): frozen rows charge
    their stay cost, each lane solves against free slots minus the frozen
    runners' re-occupancy, an all-True lane equals the unmasked axis, and
    the all-frozen lane still solves its ready rows."""
    rng = np.random.default_rng(23)
    topo = R_TOPO_PARTIAL
    state = _state(rng, topo, T=14, J=3, preempt_running=True)
    params = r_policy.PolicyParams(preemption=True, beta_scale=0.0)
    ref, port = _programs(topo, params, tie_jitter=9, exact=False)
    T, M = state.n_tasks, topo.n_machines
    state.free_slots = np.full(M, 3, np.int32)
    running = state.cur_machine >= 0
    all_true = np.ones(T, bool)
    frozen_all = ~running
    half = all_true.copy()
    half[np.nonzero(running)[0][::2]] = False
    masks = np.stack([all_true, frozen_all, half])
    r_res = ref.what_if(state, [params] * 3, active_masks=masks)
    t_state = convert.from_reference(state)
    t_params = convert.from_reference(params)
    t_res = port.what_if(t_state, [t_params] * 3, active_masks=masks)
    _assert_whatif_equal(r_res, t_res)
    assert t_res.active_masks.shape == (3, TP)
    assert np.array_equal(t_res.active_masks[:, :T], masks)

    unmasked = port.what_if(t_state, [t_params])
    assert np.array_equal(t_res.variant_cols(0), unmasked.variant_cols(0))
    out = t_res.lane_outcomes()
    true1 = t_res.per_task_true_cost[1, :T].astype(np.int64)
    stay1 = t_res.per_task_stay_cost[1, :T].astype(np.int64)
    assert out[1] == np.where(masks[1], true1, stay1).sum()
    # The all-frozen lane solved its pending rows.
    cols1 = t_res.variant_cols(1)
    assert (cols1[~running] >= 0).all()
    for k in range(3):
        cols = t_res.variant_cols(k)
        lane_placed = masks[k] & (cols >= 0) & (cols < M)
        counts = np.bincount(cols[lane_placed], minlength=M)
        frozen_occ = np.bincount(state.cur_machine[running & ~masks[k]], minlength=M)
        assert (counts + frozen_occ <= state.free_slots).all(), k
    assert not np.array_equal(t_res.variant_cols(2), t_res.variant_cols(0))


def test_whatif_telemetry_counters_equal_reference():
    rng = np.random.default_rng(29)
    topo = R_TOPO_FULL
    state = _state(rng, topo, T=12, J=2, preempt_running=True)
    params = r_policy.PolicyParams(preemption=True)
    ref, port = _programs(topo, params, tie_jitter=9, exact=False)
    variants = [params, r_policy.PolicyParams(preemption=True, beta_scale=0.0)]
    states = _window_states(rng, topo, 3)
    with r_obs.scope() as r_tel:
        ref.what_if(state, variants)
        ref.advance(ref.init_state(states[0].free_slots),
                    r_rp.stack_round_states(states, n_pad_tasks=TP, n_pad_jobs=JP))
        r_counters = r_obs.counters()
        r_spans = [s.name for s in r_tel.spans]
    with t_obs.scope() as t_tel:
        port.what_if(convert.from_reference(state),
                     [convert.from_reference(v) for v in variants])
        t_states = [convert.from_reference(s) for s in states]
        port.advance(port.init_state(states[0].free_slots),
                     t_rp.stack_round_states(t_states, n_pad_tasks=TP, n_pad_jobs=JP))
        t_counters = t_obs.counters()
        t_spans = [s.name for s in t_tel.spans]
    for key in ("h2d.upload_bytes", "whatif.lanes", "window.rounds", "auction.iterations",
                "auction.pad_waste_tasks"):
        assert r_counters[key] == t_counters[key], key
    assert t_spans == r_spans
    assert t_spans.count("round_program.round") == 3


def test_device_latency_rows_stack_like_host_rows():
    """Oracle rows (tensors, pinned to a padded job bucket) stacked into a
    window give the same results as the host's numpy rows; the reference's
    upload-byte count leaves them out."""
    rng = np.random.default_rng(31)
    topo = R_TOPO_FULL
    t_topo = convert.from_reference(topo)
    t_plane = convert.from_reference(PLANES[topo.n_machines])
    oracle = t_ld.DeviceLatencyOracle(t_plane, device="cpu")
    oracle.pin_jobs(5)
    states = [convert.from_reference(s) for s in _window_states(rng, topo, 3)]
    dev_states = []
    for s in states:
        s.root_latency = t_plane.latency_rows(s.root_machine, 3)
        d = t_policy.RoundState(**{**s.__dict__, "root_latency": oracle.root_rows(
            s.root_machine, 3)})
        assert d.root_latency.shape == (8, topo.n_machines)
        dev_states.append(d)
    params = t_policy.PolicyParams()
    port = t_rp.RoundProgram(t_topo, params, T_LUT, n_pad_tasks=TP, n_pad_jobs=JP,
                             device="cpu")
    host_w = t_rp.stack_round_states(states, n_pad_tasks=TP, n_pad_jobs=JP)
    dev_w = t_rp.stack_round_states(dev_states, n_pad_tasks=TP, n_pad_jobs=JP)
    assert isinstance(dev_w.root_latency, torch.Tensor)
    assert port._window_upload_bytes(host_w) - port._window_upload_bytes(dev_w) == (
        host_w.root_latency.nbytes)
    _, a = port.advance(port.init_state(states[0].free_slots), host_w)
    _, b = port.advance(port.init_state(states[0].free_slots), dev_w)
    _assert_window_equal(a, b)


def test_stack_round_states_refuses_what_the_reference_refuses():
    rng = np.random.default_rng(37)
    topo = R_TOPO_FULL
    s = convert.from_reference(_state(rng, topo, T=12, J=3))
    with pytest.raises(ValueError, match="empty round window"):
        t_rp.stack_round_states([], n_pad_tasks=TP, n_pad_jobs=JP)
    with pytest.raises(ValueError, match="exceeds the window bucket"):
        t_rp.stack_round_states([s], n_pad_tasks=8, n_pad_jobs=JP)
    other = convert.from_reference(_state(rng, R_TOPO_PARTIAL, T=4, J=1))
    with pytest.raises(ValueError, match="share the cluster"):
        t_rp.stack_round_states([s, other], n_pad_tasks=TP, n_pad_jobs=JP)
    port = t_rp.RoundProgram(convert.from_reference(topo), t_policy.PolicyParams(), T_LUT,
                             n_pad_tasks=TP, n_pad_jobs=JP, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        port.what_if(s, [])
    with pytest.raises(ValueError, match="active_masks shape"):
        port.what_if(s, [t_policy.PolicyParams()], active_masks=np.ones((2, 12), bool))


def _ctx(topo):
    return t_sb.RoundContext(rng=np.random.default_rng(0),
                             task_counts=np.zeros(topo.n_machines, np.int64), n_ready=0)


def test_windowed_backend_place_window_whatif_match_auction_and_reference():
    """`WindowedAuctionBackend.place` == `AuctionBackend.place` per round,
    `place_window` == the same rounds placed one by one (and the reference's
    windowed backend), `place_whatif` with one variant == `place`."""
    rng = np.random.default_rng(17)
    topo = R_TOPO_PARTIAL
    params = r_policy.PolicyParams(preemption=True)
    t_topo, t_params = convert.from_reference(topo), convert.from_reference(params)
    per_round = t_sb.make_backend("auction", t_params, t_topo, device="cpu")
    windowed = t_sb.make_backend("auction_windowed", t_params, t_topo, device="cpu")
    assert isinstance(windowed, t_sb.WindowedAuctionBackend)
    assert windowed.name == "auction_windowed"
    assert windowed.supports_window and windowed.supports_whatif and windowed.supports_serving
    ref_windowed = r_sb.WindowedAuctionBackend(params, topo, R_LUT)
    states = _window_states(rng, topo, 4, preempt=True)
    t_states = [convert.from_reference(s) for s in states]
    ctx = _ctx(t_topo)
    for s in t_states:
        pa = per_round.place(s, ctx)
        pw = windowed.place(s, ctx)
        assert np.array_equal(pa.cols, pw.cols)
        assert pa.objective == pw.objective
        pi = windowed.place_whatif(s, ctx, [t_params])
        assert np.array_equal(pa.cols, pi.cols) and pa.objective == pi.objective
    batched = windowed.place_window(t_states)
    ref_batched = ref_windowed.place_window(states)
    for s, p, rp in zip(t_states, batched, ref_batched):
        ref = per_round.place(s, ctx)
        assert np.array_equal(ref.cols, p.cols) and ref.objective == p.objective
        assert np.array_equal(np.asarray(rp.cols), p.cols) and rp.objective == p.objective
    assert windowed.place_window([]) == []


def test_windowed_backend_chained_window_equals_reference():
    rng = np.random.default_rng(19)
    topo = R_TOPO_FULL
    M = topo.n_machines
    deltas = [rng.integers(1, 3, size=M).astype(np.int32)]
    for _ in range(3):
        d = np.zeros(M, np.int32)
        d[rng.integers(0, M, size=4)] += 1
        deltas.append(d)
    states = _window_states(rng, topo, 4, free_slots_per_round=deltas, preempt=True)
    params = r_policy.PolicyParams(preemption=True)
    t_topo, t_params = convert.from_reference(topo), convert.from_reference(params)
    windowed = t_sb.WindowedAuctionBackend(t_params, t_topo, device="cpu")
    got = windowed.place_window([convert.from_reference(s) for s in states], chain=True)
    want = r_sb.WindowedAuctionBackend(params, topo, R_LUT).place_window(states, chain=True)
    for p, w in zip(got, want):
        assert np.array_equal(np.asarray(w.cols), p.cols) and w.objective == p.objective
    # A chained window's carry is never cached (it seeds a fresh one).
    assert windowed._states == {}


def test_windowed_backend_serving_pin_and_warmup():
    rng = np.random.default_rng(41)
    topo = R_TOPO_FULL
    t_topo = convert.from_reference(topo)
    windowed = t_sb.WindowedAuctionBackend(t_policy.PolicyParams(), t_topo, device="cpu")
    windowed.pin_serving(20, 3)
    windowed.warm_serving(np.full(topo.n_machines, 4, np.int32))
    s = convert.from_reference(_state(rng, topo, T=5, J=2))
    key, prog = windowed._program(s.n_tasks, s.n_jobs)
    assert key == (32, 8, False) and (prog.n_pad_tasks, prog.n_pad_jobs) == (32, 8)
    per_round = t_sb.AuctionBackend(t_policy.PolicyParams(), t_topo, device="cpu")
    ctx = _ctx(t_topo)
    assert np.array_equal(windowed.place(s, ctx).cols, per_round.place(s, ctx).cols)
    with pytest.raises(t_sb.BackendCapabilityError):
        per_round.place_window([s])

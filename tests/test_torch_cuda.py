"""repro_torch on the card: each CUDA kernel against its plain version on
the same CUDA tensors (the scheduler's kernels exact: tolerance 0, index
included; the attention kernels within 2e-5 in f32 and 2e-2 with 16-bit
inputs, the order of the sums differing; the scans within 1e-5 (RG-LRU)
and 1e-4 (RWKV-6) in f32, as tests/test_kernels_scans.py), the kernels'
input checks, a small replay and small serves on CUDA against the same on
CPU.

Marked ``cuda``; every test skips without a CUDA device. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("T,M", [(1, 1), (3, 7), (17, 300), (64, 513), (256, 1031)])
def test_costmap_kernel_equals_plain(cuda, T, M):
    from repro_torch.core import perf_model
    from repro_torch.kernels.costmap import kernel_cuda, ref

    rng = np.random.default_rng(T * 1000 + M)
    lut = perf_model.perf_lut_table().to(cuda)
    perf_idx = torch.from_numpy(rng.integers(0, 4, size=T).astype(np.int32)).to(cuda)
    lat = rng.uniform(-5, 1400, size=(T, M)).astype(np.float32)
    lat.flat[:8] = [0.0, 39.9, 44.9, 45.0, 45.1, 995.0, 1005.0, -3.0][: lat.size]
    lat = torch.from_numpy(lat).to(cuda)
    got = kernel_cuda.costmap_cuda(lut, perf_idx, lat)
    assert torch.equal(got, ref.costmap_ref(lut, perf_idx, lat))
    # An unaligned (offset) latency view takes the kernel's scalar path.
    if M > 4:
        sub = lat.flatten()[1 : 1 + T * (M - 1)].view(T, M - 1)
        assert torch.equal(
            kernel_cuda.costmap_cuda(lut, perf_idx, sub), ref.costmap_ref(lut, perf_idx, sub)
        )


@pytest.mark.parametrize("T,C", [(1, 1), (1, 2), (5, 17), (8, 12_500), (50, 700)])
@pytest.mark.parametrize("chunk", [None, 1, 256, 512])
def test_bid_kernel_equals_plain(cuda, T, C, chunk):
    from repro_torch.kernels.auction_bid import kernel_cuda, ref

    rng = np.random.default_rng(T * 31 + C)
    values = rng.integers(-40, 0, size=(T, C)).astype(np.float32)  # heavy ties
    p1 = rng.integers(0, 8, size=C).astype(np.float32)
    p2 = np.maximum(p1, rng.integers(0, 16, size=C)).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda) for x in (values, p1, p2)]
    got = kernel_cuda.bid_top2_cuda(*args, chunk_cols=chunk)
    want = ref.bid_top2_ref(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_kernels_refuse_bad_inputs(cuda):
    from repro_torch.kernels.auction_bid.kernel_cuda import bid_top2_cuda
    from repro_torch.kernels.costmap.kernel_cuda import costmap_cuda

    lut = torch.zeros((4, 101), device=cuda)
    with pytest.raises(TypeError):
        costmap_cuda(lut, torch.zeros(2, dtype=torch.int64, device=cuda),
                     torch.zeros((2, 3), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        costmap_cuda(lut, torch.zeros(3, dtype=torch.int32, device=cuda),
                     torch.zeros((2, 3), device=cuda).t())
    with pytest.raises(ValueError):
        bid_top2_cuda(torch.zeros((2, 3), device=cuda), torch.zeros(4, device=cuda),
                      torch.zeros(3, device=cuda))


def test_small_replay_card_equals_cpu(cuda):
    from repro_torch import kernels
    from repro_torch.core import latency, policy, simulator, topology, workload

    topo = topology.Topology(96, 8, 4, slots_per_machine=4)
    plane = latency.LatencyPlane.synthesize(topo, 60, seed=2)
    wl = workload.synth_workload(topo, 60, seed=2, target_utilisation=0.6)
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cuda", "cpu"):
        cfg = simulator.SimConfig(
            backend="auction", device=dev, seed=3, fixed_algo_s=0.0,
            migration_interval_s=20, failures=((15, 4),),
            params=policy.PolicyParams(preemption=True, beta_scale=1.0),
        )
        out[dev] = simulator.Simulator(wl, plane, cfg).run()
    counts = kernels.launch_counts()
    # The card's solves run the persistent phase kernel, never the bid alone.
    assert counts["costmap"] > 0 and counts["auction_phase"] > 0
    assert counts["auction_bid"] == 0
    a, b = out["cuda"], out["cpu"]
    for f in ("tasks_placed", "tasks_migrated", "rounds", "placement_latency_s",
              "response_time_s", "per_job_perf", "migrated_pct_per_round"):
        assert getattr(a, f) == getattr(b, f), f


def _phase_instance(seed, T, Tp, M, S, *, levels=99, jitter=9, exact=False,
                    identical=False, forbid=0.05):
    """(price0, values, value_u, job_col, active) of an auction phase, numpy:
    costs in multiples of 10 (plus tie jitter), forbidden columns, locked
    slots, padding rows past T; exact mode scales by T + 1, identical rows
    make a price war."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(1, levels + 1, size=(T, M)).astype(np.int64) * 10
    if identical:
        cost[:] = cost[0]
    if jitter:
        cost += rng.integers(0, jitter, size=(T, M))
    forbidden = rng.random((T, M)) < forbid
    scale = T + 1 if exact else 1
    values = np.full((Tp, M), -(2.0**40), np.float32)
    values[:T] = np.where(forbidden, np.float32(-(2.0**40)), (-cost * scale).astype(np.float32))
    value_u = np.zeros(Tp, np.float32)
    value_u[:T] = (-rng.integers(400, 1500, size=T) * scale).astype(np.float32)
    job_col = np.full(Tp, M, np.int32)
    job_col[:T] = M + np.sort(rng.integers(0, 3, size=T))
    capacity = rng.integers(0, S + 1, size=M)
    price0 = np.where(np.arange(S)[None, :] >= capacity[:, None], np.float32(2.0**40),
                      np.float32(0.0)).astype(np.float32)
    return price0, values, value_u, job_col, np.arange(Tp) < T


_PHASE_CASES = {
    "round_8": dict(T=8, Tp=8, M=12_500, S=8),
    "round_1024": dict(T=1000, Tp=1024, M=12_500, S=8, levels=20),
    "round_2048": dict(T=1536, Tp=2048, M=12_500, S=8, levels=20),
    "price_war_wide": dict(T=64, Tp=64, M=12_500, S=2, levels=1, jitter=0, exact=True,
                           identical=True, forbid=0.0),
    "price_war": dict(T=16, Tp=16, M=24, S=2, levels=1, jitter=0, exact=True,
                      identical=True, forbid=0.0),
    "m_space": dict(T=27, Tp=32, M=40, S=3),
}


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("case", sorted(_PHASE_CASES))
def test_auction_phase_kernel_equals_step_loop(cuda, case, seed):
    """Bit for bit: price, owner, assigned, iterations and bidder rows,
    against the step-wise loop on the same CUDA tensors (and on the CPU
    where the loop is cheap there)."""
    from repro_torch.kernels.auction_phase import kernel_cuda, ref

    args = _phase_instance(seed, **_PHASE_CASES[case])
    dev = [torch.from_numpy(x).to(cuda) for x in args]
    got = kernel_cuda.auction_phase_cuda(*dev, 1.0, 500_000, return_bidder_rows=True)
    want = ref.auction_phase_ref(*dev, 1.0, 500_000, return_bidder_rows=True)
    assert got[3] == want[3] and got[4] == want[4] and got[3] >= 1
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if args[1].shape[0] <= 64:
        cpu = ref.auction_phase_ref(*map(torch.from_numpy, args), 1.0, 500_000)
        assert cpu[3] == got[3]
        for g, c in zip(got[:3], cpu[:3]):
            assert torch.equal(g.cpu(), c)


def test_auction_phase_stops_at_the_cap(cuda):
    from repro_torch.core import auction
    from repro_torch.kernels.auction_phase import kernel_cuda, ref

    args = [torch.from_numpy(x).to(cuda) for x in _phase_instance(1, **_PHASE_CASES["price_war"])]
    assert kernel_cuda.auction_phase_cuda(*args, 1.0, 500_000)[3] > 3
    got = kernel_cuda.auction_phase_cuda(*args, 1.0, 3)
    want = ref.auction_phase_ref(*args, 1.0, 3)
    assert got[3] == want[3] == 3 and bool((got[2] < 0).any())
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    # Host costs in: a price war among identical rows, card against CPU, and
    # a cap below its iterations raises.
    rng = np.random.default_rng(1)
    T, M = 16, 24
    w = np.zeros((T, M + 1), np.int64)
    w[:, :M] = 10
    w[:, M] = rng.integers(400, 1500, size=T)
    cap = rng.integers(0, 3, size=M)
    kw = dict(slots_per_machine=2, exact=True)
    card = auction.solve_transportation(w, cap, M, np.full(T, M), device=cuda, **kw)
    cpu = auction.solve_transportation(w, cap, M, np.full(T, M), device="cpu", **kw)
    assert np.array_equal(card.assigned_col, cpu.assigned_col)
    assert card.total_cost == cpu.total_cost and np.array_equal(card.prices, cpu.prices)
    assert card.iterations == cpu.iterations > 3
    with pytest.raises(RuntimeError, match="iteration cap"):
        auction.solve_transportation(w, cap, M, np.full(T, M), device=cuda,
                                     max_iters_per_phase=3, **kw)


def test_solve_device_kernel_equals_step_loop(cuda, monkeypatch):
    """`solve_transportation_device` gives the same AuctionResult through the
    kernel and through the step-wise loop."""
    from repro_torch import kernels
    from repro_torch.core import auction, latency, perf_model, policy, topology
    from repro_torch.kernels.auction_phase import ref

    topo = topology.google_topology(1536)
    plane = latency.LatencyPlane.synthesize(topo, 4, seed=1)
    rng = np.random.default_rng(4)
    T, J = 300, 40
    roots = rng.integers(0, topo.n_machines, size=J)
    state = policy.RoundState(
        task_job=np.sort(rng.integers(0, J, size=T)), perf_idx=rng.integers(0, 4, size=T),
        root_machine=roots, root_latency=plane.latency_rows(roots, 2),
        wait_s=rng.uniform(0, 100, size=T).astype(np.float32),
        run_s=np.zeros(T, np.float32), cur_machine=np.full(T, -1, np.int64),
        free_slots=rng.integers(0, 3, size=topo.n_machines).astype(np.int32))
    lut = perf_model.perf_lut_table().to(cuda)
    w_m, a, *_ = policy.device_round_costs(state, topo, policy.PolicyParams(), lut,
                                           n_pad_tasks=auction._bucket(T), n_pad_jobs=64)
    results = {}
    for route in ("kernel", "loop"):
        if route == "loop":
            monkeypatch.setattr(auction.phase_ops, "auction_phase", ref.auction_phase_ref)
        kernels.reset_launch_counts()
        results[route] = auction.solve_transportation_device(
            w_m, a, T, state.free_slots, topo.n_machines, state.task_job,
            slots_per_machine=topo.slots_per_machine, tie_jitter=9, exact=False)
        assert kernels.launch_counts()["auction_phase"] == (route == "kernel")
    k, lp = results["kernel"], results["loop"]
    assert np.array_equal(k.assigned_col, lp.assigned_col)
    assert k.total_cost == lp.total_cost and k.iterations == lp.iterations > 1
    assert torch.equal(k.prices, lp.prices)


def test_device_jitter_on_the_card(cuda):
    from repro_torch.core import auction

    for shape in ((8, 12_500), (2048, 12_500), (300, 7)):
        got = auction._jitter_device(*shape, 9, str(cuda))
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), auction._jitter_device(*shape, 9, "cpu"))


def test_auction_phase_refuses_bad_inputs(cuda):
    from repro_torch.kernels.auction_phase import kernel_cuda

    args = [torch.from_numpy(x).to(cuda) for x in _phase_instance(0, **_PHASE_CASES["m_space"])]
    price0, values, value_u, job_col, active = args
    with pytest.raises(TypeError):
        kernel_cuda.auction_phase_cuda(price0, values.double(), value_u, job_col, active, 1.0, 9)
    with pytest.raises(TypeError):
        kernel_cuda.auction_phase_cuda(price0, values, value_u, job_col.long(), active, 1.0, 9)
    with pytest.raises(ValueError, match="expected"):
        kernel_cuda.auction_phase_cuda(price0, values, value_u.cpu(), job_col, active, 1.0, 9)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_cuda.auction_phase_cuda(price0, values.t().contiguous().t(), value_u, job_col,
                                       active, 1.0, 9)
    for eps in (0.0, -1.0, 1e-46):
        with pytest.raises(ValueError, match="eps"):
            kernel_cuda.auction_phase_cuda(*args, eps, 9)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel_cuda.auction_phase_cuda(*args, 1.0, 9, ctas=kernel_cuda.max_ctas() + 1)
    assert kernel_cuda.auction_phase_cuda(*args, 1.0, 9)[3] > 0  # the card is still usable


def test_auction_phase_stats_left_on_the_card(cuda):
    """``stats_on_device`` returns the counts as CUDA tensors, equal to the
    default call's host ints; the launch is counted once either way."""
    from repro_torch import kernels
    from repro_torch.kernels.auction_phase import kernel_cuda, ops

    args = [torch.from_numpy(x).to(cuda) for x in _phase_instance(3, **_PHASE_CASES["round_8"])]
    want = kernel_cuda.auction_phase_cuda(*args, 1.0, 500_000, return_bidder_rows=True)
    kernels.reset_launch_counts()
    got = kernel_cuda.auction_phase_cuda(*args, 1.0, 500_000, return_bidder_rows=True,
                                         stats_on_device=True)
    assert kernels.launch_counts()["auction_phase"] == 1
    assert got[3].device.type == "cuda" and got[3].dim() == 0
    assert int(got[3]) == want[3] and int(got[4]) == want[4]
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    it = ops.auction_phase(*args, 1.0, 500_000, iters_on_device=True)[3]
    assert it.device.type == "cuda" and int(it) == want[3]


def _migration_rounds(topo, R, seed, n_tasks=40, n_jobs=6):
    from repro_torch.core import latency, policy

    plane = latency.LatencyPlane.synthesize(topo, 8, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for r in range(R):
        roots = rng.integers(0, topo.n_machines, size=n_jobs)
        cur = np.full(n_tasks, -1, np.int64)
        run_s = np.zeros(n_tasks, np.float32)
        k = n_tasks // 3
        cur[:k] = rng.integers(0, topo.n_machines, size=k)
        run_s[:k] = rng.uniform(0, 7200, size=k)
        out.append(policy.RoundState(
            task_job=np.sort(rng.integers(0, n_jobs, size=n_tasks)),
            perf_idx=rng.integers(0, 4, size=n_tasks), root_machine=roots,
            root_latency=plane.latency_rows(roots, r), wait_s=rng.uniform(
                0, 100, size=n_tasks).astype(np.float32), run_s=run_s, cur_machine=cur,
            free_slots=rng.integers(0, 3, size=topo.n_machines).astype(np.int32)))
    return out


@pytest.mark.parametrize("chain", [False, True], ids=["exogenous", "chained"])
def test_window_and_whatif_card_equal_cpu(cuda, chain):
    """`place_window` and the what-if lanes on the card equal the CPU's,
    with one auction_phase launch per round and per lane."""
    from repro_torch import kernels
    from repro_torch.core import policy, scheduler_backend, topology

    topo = topology.google_topology(1536)
    states = _migration_rounds(topo, 4, seed=5)
    params = policy.PolicyParams(preemption=True, beta_scale=1.0)
    variants = [params, policy.PolicyParams(preemption=True, beta_scale=0.0),
                policy.PolicyParams(p_m=120, p_r=125, preemption=True)]
    masks = np.ones((3, states[0].n_tasks), bool)
    masks[0, states[0].n_tasks // 2:] = False
    out = {}
    for dev in ("cuda", "cpu"):
        be = scheduler_backend.WindowedAuctionBackend(params, topo, device=dev)
        kernels.reset_launch_counts()
        win = be.place_window(states, chain=chain)
        res, _ = be.whatif_result(states[0], None, variants, active_masks=masks)
        out[dev] = (win, res, kernels.launch_counts())
    (cw, cr, counts), (pw, pr, _) = out["cuda"], out["cpu"]
    assert counts["auction_phase"] == len(states) + len(variants)
    assert counts["costmap"] == len(states) + len(variants) and counts["auction_bid"] == 0
    for a, b in zip(cw, pw):
        assert np.array_equal(a.cols, b.cols) and a.objective == b.objective
    for f in ("assigned", "iterations", "per_task_cost", "per_task_true_cost",
              "per_task_stay_cost"):
        assert np.array_equal(getattr(cr, f), getattr(pr, f)), f
    assert np.array_equal(cr.lane_outcomes(), pr.lane_outcomes())


def test_oracle_rows_on_the_card_equal_host_rows(cuda):
    from repro_torch.core import latency, latency_device, topology

    topo = topology.google_topology(1536)
    ev = latency.LatencyEvents(
        hotspots=(latency.DriftingHotspot(start_s=5.0, end_s=50.0, rack0=2,
                                          drift_racks_per_s=0.5, width_racks=2,
                                          multiplier=4.0),),
        regime=latency.RegimeSchedule(times=(20.0, 40.0), frac=0.5))
    plane = latency.LatencyPlane.synthesize(topo, 60, seed=3, events=ev)
    oracle = latency_device.DeviceLatencyOracle(plane, device=cuda)
    roots = np.random.default_rng(0).integers(0, topo.n_machines, size=37)
    for t in (0, 5, 19, 20, 33, 40, 59):
        got = oracle.root_rows(roots, t)
        assert got.device.type == "cuda"
        assert np.array_equal(got.cpu().numpy(), plane.latency_rows(roots, t)), t


def test_small_controller_replay_card_equals_cpu(cuda):
    """The controller with the oracle and what-if lanes on the card gives
    the CPU's metrics, counters and audit events."""
    from repro_torch import kernels, obs
    from repro_torch.core import latency, scenarios, simulator, topology, workload

    topo = topology.Topology(96, 8, 4, slots_per_machine=4)
    scn = scenarios.get_scenario("drifting_hotspot")
    plane = scn.plane(latency.LatencyPlane.synthesize(topo, 90, seed=2), 90)
    wl = workload.synth_workload(topo, 90, seed=2, target_utilisation=0.5)
    out = {}
    for dev in ("cuda", "cpu"):
        cfg = simulator.SimConfig(
            backend="auction_windowed", device=dev, seed=3, fixed_algo_s=0.0,
            params=scn.policy_params(p_m=105, p_r=110), migration_controller=True,
            device_latency=True, whatif_betas=(0.0, 100.0 / 3600.0), qos_threshold=0.95,
            qos_hold_s=30.0, **scn.sim_config_kwargs(topo, 90, 0))
        kernels.reset_launch_counts()
        with obs.scope() as tel:
            m = simulator.Simulator(wl, plane, cfg).run()
            audit = [{k: v for k, v in e.items() if k != "algo_s"} for e in tel.audit]
            out[dev] = (m, obs.counters(), audit, kernels.launch_counts())
    (a, ca, aa, counts), (b, cb, ab, _) = out["cuda"], out["cpu"]
    assert a.controller_rounds > 0 and counts["auction_phase"] > 0
    assert counts["auction_bid"] == 0
    for f in ("tasks_placed", "tasks_migrated", "rounds", "placement_latency_s",
              "response_time_s", "per_job_perf", "migrated_pct_per_round",
              "controller_improvement_per_round", "degraded_jobs_per_round",
              "controller_rounds"):
        assert getattr(a, f) == getattr(b, f), f
    assert ca == cb and aa == ab


_ATT_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}


def _att_tol(*dtypes):
    return 2e-5 if all(d == "f32" for d in dtypes) else 2e-2


@pytest.mark.parametrize(
    "B,H,KVH,S,D,dt,causal",
    [
        (1, 2, 2, 128, 64, "f32", True),
        (2, 4, 2, 100, 128, "f32", True),  # ragged tail
        (1, 8, 1, 64, 128, "f32", False),  # MQA, full
        (2, 4, 2, 1, 16, "f32", True),
        (2, 4, 2, 257, 32, "bf16", True),
        (1, 4, 4, 130, 64, "f16", False),
        (2, 16, 8, 1024, 128, "f32", True),  # qwen3-0.6b per-layer prefill
        (2, 10, 1, 203, 256, "bf16", True),  # head_dim 256, S not a multiple of the tiles
        (1, 4, 2, 77, 256, "f16", False),
        (2, 4, 2, 77, 128, "bf16", True),
        (1, 10, 1, 2048, 256, "f32", True),  # recurrentgemma-2b per-layer prefill
    ],
)
def test_flash_kernel_equals_plain(cuda, B, H, KVH, S, D, dt, causal):
    from repro_torch.kernels.flash_attention import kernel_cuda, ref

    rng = np.random.default_rng(B * 1000 + S + D)
    q, k, v = (
        torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda, _ATT_DTYPES[dt])
        for shape in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))
    )
    got = kernel_cuda.flash_attention_cuda(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = _att_tol(dt)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_takes_strided_heads(cuda):
    """q, k, v as the (B, S, H, D) -> (B, H, S, D) views the blocks pass."""
    from repro_torch.kernels.flash_attention import kernel_cuda, ref

    rng = np.random.default_rng(11)
    B, S, H, KVH, D = 2, 96, 4, 2, 64
    q = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32)).to(cuda)
    kv = torch.from_numpy(rng.normal(0, 1, (B, S, 2 * KVH, D)).astype(np.float32)).to(cuda)
    qv, kt, vt = q.transpose(1, 2), kv[:, :, :KVH].transpose(1, 2), kv[:, :, KVH:].transpose(1, 2)
    got = kernel_cuda.flash_attention_cuda(qv, kt, vt)
    want = ref.attention_ref(qv.contiguous(), kt.contiguous(), vt.contiguous())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize(
    "B,H,KVH,S,D,q_dt,c_dt",
    [
        (3, 8, 2, 256, 64, "f32", "f32"),
        (8, 16, 8, 1088, 128, "f32", "bf16"),  # qwen3-0.6b serving
        (2, 4, 1, 100, 128, "bf16", "bf16"),
        (2, 4, 2, 64, 16, "f32", "f32"),
        (1, 4, 4, 300, 32, "f16", "f16"),
        (8, 10, 1, 2048, 256, "f32", "bf16"),  # recurrentgemma-2b serving
        (2, 48, 1, 100, 64, "f32", "bf16"),  # G = 48: four head blocks
        (3, 6, 2, 77, 42, "f32", "bf16"),  # head_dim of --reduce 3: element path
        (3, 6, 2, 77, 18, "f32", "f32"),
        (2, 4, 2, 33, 85, "bf16", "f16"),
    ],
)
def test_decode_kernel_equals_plain(cuda, B, H, KVH, S, D, q_dt, c_dt):
    from repro_torch.kernels.decode_attention import kernel_cuda, ref

    rng = np.random.default_rng(B * 100 + S + D)
    q = torch.from_numpy(rng.normal(0, 1, (B, H, D)).astype(np.float32)).to(cuda, _ATT_DTYPES[q_dt])
    kc, vc = (
        torch.from_numpy(rng.normal(0, 1, (B, KVH, S, D)).astype(np.float32)).to(
            cuda, _ATT_DTYPES[c_dt])
        for _ in range(2)
    )
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0], lengths[-1] = 1, S
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(cuda)
    got = kernel_cuda.decode_attention_cuda(q, kc, vc, lengths)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = _att_tol(q_dt) if q_dt != "f32" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    # The kernel keeps no state between calls: a second call agrees bit for bit.
    torch.testing.assert_close(kernel_cuda.decode_attention_cuda(q, kc, vc, lengths), got,
                               atol=0, rtol=0)


def test_attention_kernels_refuse_bad_inputs(cuda):
    from repro_torch.kernels.decode_attention.kernel_cuda import decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel_cuda import flash_attention_cuda

    from repro_torch.kernels.flash_attention.ref import attention_ref

    # head_dim 48 runs zero-padded to 64 (it was refused before).
    x = torch.from_numpy(np.random.default_rng(48).normal(0, 1, (1, 2, 8, 48))
                         .astype(np.float32)).to(cuda)
    torch.testing.assert_close(flash_attention_cuda(x, x, x), attention_ref(x, x, x),
                               atol=2e-5, rtol=2e-5)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_cuda(*(torch.zeros((1, 2, 8, 320), device=cuda),) * 3)
    y = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention_cuda(y, y.half(), y)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        decode_attention_cuda(y[:, :, 0], y, y, lengths.long())
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention_cuda(y[:, :, 0], y.transpose(2, 3).contiguous().transpose(2, 3),
                              y, lengths)


def test_flash_kernel_refuses_misaligned_views(cuda):
    """K/V tiles arrive in 16-byte cp.async copies: a view one element off
    a 16-byte boundary, or with a sequence stride that is not a multiple of
    16 bytes, is copied to contiguous storage first (it was refused before)
    and gives the plain version's result."""
    from repro_torch.kernels.flash_attention.kernel_cuda import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(16)
    x = _randn(rng, (1, 2, 8, 64), cuda)
    off = _randn(rng, (2 * 8 * 64 + 1,), cuda)[1:].view(1, 2, 8, 64)
    assert off.storage_offset() == 1
    wide = _randn(rng, (1, 2, 8, 66), cuda)[..., :64]
    launches = flash_attention_cuda.launches
    for q, k, v in ((off, x, x), (x, x, wide), (off, off, wide)):
        torch.testing.assert_close(flash_attention_cuda(q, k, v),
                                   attention_ref(q.contiguous(), k.contiguous(),
                                                 v.contiguous()), atol=2e-5, rtol=2e-5)
    assert flash_attention_cuda.launches == launches + 3


@pytest.mark.parametrize("D", [42, 18])
def test_attention_kernels_at_any_head_dim(cuda, D):
    """The head_dims that --reduce 3 and 7 give (42, 18): flash zero-pads to
    the next compiled head_dim, decode takes its element path; both also on
    a view that is off a 16-byte boundary."""
    from repro_torch.kernels.decode_attention import kernel_cuda as dec_k
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel_cuda as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref

    rng = np.random.default_rng(D)
    B, H, KVH, S = 2, 6, 2, 70
    q, k, v = (_randn(rng, shape, cuda) for shape in ((B, H, S, D), (B, KVH, S, D),
                                                      (B, KVH, S, D)))
    torch.testing.assert_close(fa_k.flash_attention_cuda(q, k, v), fa_ref.attention_ref(q, k, v),
                               atol=2e-5, rtol=2e-5)
    qs = _randn(rng, (B, S, H, D + 3), cuda)[..., 1:D + 1].transpose(1, 2)  # strided, off
    torch.testing.assert_close(fa_k.flash_attention_cuda(qs, k, v, causal=False),
                               fa_ref.attention_ref(qs.contiguous(), k, v, causal=False),
                               atol=2e-5, rtol=2e-5)
    lengths = torch.tensor([S, 31], dtype=torch.int32, device=cuda)
    qd = _randn(rng, (B, H, D + 1), cuda)[..., 1:]  # strided q, off a 16-byte boundary
    for dt in (torch.float32, torch.bfloat16):
        n = B * KVH * S * D
        kc, vc = (_randn(rng, (n + 1,), cuda, dt)[1:].view(B, KVH, S, D) for _ in range(2))
        torch.testing.assert_close(dec_k.decode_attention_cuda(qd, kc, vc, lengths),
                                   dec_ref.decode_attention_ref(qd, kc, vc, lengths),
                                   atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch,reduce", [("qwen3-0.6b", 3), ("recurrentgemma-2b", 6),
                                         ("recurrentgemma-2b", 7)])
def test_serve_main_odd_head_dim_card_equals_cpu(cuda, arch, reduce):
    """--reduce 3 gives qwen3-0.6b head_dim 42, 6 and 7 give recurrentgemma-2b
    42 and 36, which the card's attention path refused before: the card now
    serves them, with the CPU's tokens. (recurrentgemma-2b at --reduce 3 and
    5 has an odd head_dim, 85 and 51, which rope splits unevenly on every
    device, in the reference too.)"""
    from repro_torch.launch import serve

    args = ["--arch", arch, "--reduce", str(reduce), "--requests", "2", "--prompt-len", "24",
            "--gen", "6"]
    card = serve.main(args + ["--device", "cuda"])
    np.testing.assert_array_equal(card, serve.main(args + ["--device", "cpu"]))


def test_small_serve_card_equals_cpu(cuda):
    import dataclasses

    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM, layers

    cfg = dataclasses.replace(serve.reduce_config(configs.get_config("qwen3-0.6b"), 8),
                              n_heads=4, n_kv_heads=2)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(5), dtype=torch.float32)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 40))
    cpu_tokens, cpu_logits = serve.serve_batch(lm, params, prompts, 6, return_logits=True)
    kernels.reset_launch_counts()
    card = layers.tree_map(lambda t: t.to(cuda), params)
    tokens, logits = serve.serve_batch(lm, card, prompts, 6, return_logits=True)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["decode_attention"] == cfg.n_layers * 5
    np.testing.assert_array_equal(tokens, cpu_tokens)
    np.testing.assert_allclose(logits, cpu_logits, atol=2e-3, rtol=2e-3)


def _randn(rng, shape, cuda, dtype=torch.float32):
    return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda, dtype)


@pytest.mark.parametrize(
    "B,T,D,dt,with_h0",
    [
        (8, 2048, 2560, "f32", False),  # recurrentgemma-2b prefill
        (2, 37, 100, "f32", True),  # ragged T and D
        (3, 1, 64, "f32", True),
        (2, 300, 33, "bf16", False),
    ],
)
def test_rglru_kernel_equals_plain(cuda, B, T, D, dt, with_h0):
    from repro_torch.kernels.rglru_scan import kernel_cuda, ref

    rng = np.random.default_rng(B * 1000 + T + D)
    la = torch.from_numpy(-rng.uniform(0.001, 2.0, (B, T, D)).astype(np.float32)).to(
        cuda, _ATT_DTYPES[dt])
    gx = _randn(rng, (B, T, D), cuda, _ATT_DTYPES[dt])
    h0 = _randn(rng, (B, D), cuda) * 0.3 if with_h0 else None
    got_o, got_h = kernel_cuda.rglru_scan_cuda(la, gx, h0)
    want_o, want_h = ref.rglru_scan_ref(la, gx, h0)
    assert got_o.dtype == gx.dtype and got_h.dtype == torch.float32
    tol = 1e-5 if dt == "f32" else 1e-2
    torch.testing.assert_close(got_o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got_h, want_h, atol=1e-5, rtol=1e-5)


def _rglru_chunk() -> int:
    """The f32 tile's kChunk in csrc/rglru_scan.cu (steps per ring stage)."""
    src = Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/rglru_scan.cu"
    return int(re.search(r"struct Tile<float> \{[^}]*kChunk = (\d+)", src.read_text()).group(1))


@pytest.mark.parametrize(
    "B,T_of,D,dt",
    [
        (2, "C-1", 100, "f32"),  # one ragged chunk
        (2, "C+1", 100, "f32"),  # a chunk and one step
        (3, "1000", 2500, "f32"),  # chip_smoke.py's ragged row
        (2, "C+1", 33, "f16"),  # one ragged 64-channel group of 16-bit channels
        (3, "1000", 33, "f16"),
    ],
)
def test_rglru_kernel_chunk_edges(cuda, B, T_of, D, dt):
    """T at the ring's chunk edges and D of no channel-group multiple, with
    h0: within 1e-5 of the plain version (f32 final state; 1e-2 for 16-bit
    states), and bit-equal in f32."""
    from repro_torch.kernels.rglru_scan import kernel_cuda, ref

    C = _rglru_chunk()
    T = {"C-1": C - 1, "C+1": C + 1, "1000": 1000}[T_of]
    rng = np.random.default_rng(B * 1000 + T + D)
    la = torch.from_numpy(-rng.uniform(0.001, 2.0, (B, T, D)).astype(np.float32)).to(
        cuda, _ATT_DTYPES[dt])
    gx = _randn(rng, (B, T, D), cuda, _ATT_DTYPES[dt])
    h0 = _randn(rng, (B, D), cuda) * 0.3
    got_o, got_h = kernel_cuda.rglru_scan_cuda(la, gx, h0)
    want_o, want_h = ref.rglru_scan_ref(la, gx, h0)
    assert got_o.dtype == gx.dtype and got_h.dtype == torch.float32
    tol = 1e-5 if dt == "f32" else 1e-2
    torch.testing.assert_close(got_o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got_h, want_h, atol=1e-5, rtol=1e-5)
    if dt == "f32":
        assert torch.equal(got_o, want_o) and torch.equal(got_h, want_h)


@pytest.mark.parametrize("B,T,D,with_h0", [(8, 2048, 2560, False), (2, 200, 100, True),
                                           (1, 1, 33, True)])
def test_rglru_kernel_bit_equal_in_f32(cuda, B, T, D, with_h0):
    """The kernel computes a and the product with gx with the plain
    version's functions, and the recurrence as a rounded product then a
    rounded sum, so its f32 states equal the plain version's bit for bit."""
    from repro_torch.kernels.rglru_scan import kernel_cuda, ref

    rng = np.random.default_rng(B + T + D)
    la = torch.from_numpy(-rng.uniform(0.001, 2.0, (B, T, D)).astype(np.float32)).to(cuda)
    gx = _randn(rng, (B, T, D), cuda)
    h0 = _randn(rng, (B, D), cuda) * 0.3 if with_h0 else None
    got_o, got_h = kernel_cuda.rglru_scan_cuda(la, gx, h0)
    want_o, want_h = ref.rglru_scan_ref(la, gx, h0)
    assert torch.equal(got_o, want_o) and torch.equal(got_h, want_h)


@pytest.mark.parametrize(
    "B,H,T,N,dt",
    [
        (2, 3, 37, 64, "f32"),  # ragged T
        (2, 4, 1, 64, "f32"),  # decode
        (1, 2, 200, 16, "f32"),
        (2, 16, 64, 32, "bf16"),  # rwkv6-7b reduced 8x: 32-wide heads
        # T a multiple of neither the chunk (8 steps) nor the ring (4 chunks),
        # at each head size's tile
        (2, 3, 33, 16, "f32"),
        (1, 4, 9, 32, "f32"),
        (3, 2, 1000, 64, "f32"),
        (2, 2, 7, 64, "f32"),
        (2, 2, 23, 16, "bf16"),
        (1, 3, 45, 32, "f16"),
        (1, 2, 17, 64, "bf16"),
        (2, 2, 1, 16, "f32"),
    ],
)
def test_rwkv6_kernel_equals_plain(cuda, B, H, T, N, dt):
    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ref

    rng = np.random.default_rng(B * 100 + T + N)
    r, k, v = (_randn(rng, (B, H, T, N), cuda, _ATT_DTYPES[dt]) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.2, 0.999, (B, H, T, N)).astype(np.float32)).to(cuda)
    u = _randn(rng, (H, N), cuda) * 0.5
    s0 = _randn(rng, (B, H, N, N), cuda) * 0.1
    want_o, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    got_o, got_s = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, s0)
    tol = 1e-4 if dt == "f32" else 2e-2
    torch.testing.assert_close(got_o.float(), want_o.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)
    # The state updated in place (decode hands its cache as both).
    state = s0.clone()
    o2, s2 = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state)
    assert s2.data_ptr() == state.data_ptr()
    torch.testing.assert_close(o2, got_o, atol=0, rtol=0)
    torch.testing.assert_close(state, got_s, atol=0, rtol=0)


def test_rwkv6_kernel_takes_strided_heads(cuda):
    """r, k, v, w as the (B, S, H, N) -> (B, H, S, N) views the block passes."""
    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ref

    rng = np.random.default_rng(3)
    B, S, H, N = 2, 50, 4, 64
    r, k, v = (_randn(rng, (B, S, H, N), cuda).transpose(1, 2) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.2, 0.99, (B, S, H, N)).astype(np.float32)).to(
        cuda).transpose(1, 2)
    u = _randn(rng, (H, N), cuda)
    got_o, got_s = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u)
    want_o, want_s = ref.rwkv6_scan_ref(r, k, v, w, u)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)


def test_rwkv6_kernel_takes_misaligned_views(cuda):
    """Views whose pointer or time stride is not a multiple of 16 bytes (the
    kernel's copies need both) are copied by the wrapper, not refused."""
    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ref

    rng = np.random.default_rng(5)
    B, H, T, N = 2, 3, 21, 32
    big = [_randn(rng, (B, H, T, N + 1), cuda) for _ in range(4)]
    r, k, v = (x[..., 1:] for x in big[:3])  # pointer 4 bytes off, time stride N + 1
    w = torch.sigmoid(big[3][..., :N])
    u = _randn(rng, (H, N), cuda)
    got_o, got_s = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u)
    want_o, want_s = ref.rwkv6_scan_ref(r, k, v, w, u)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)


def test_rwkv6_kernel_takes_mixed_layouts(cuda):
    """Each operand's tensor map follows its own strides: r and w contiguous,
    k and v heads split out of a (B, T, H N) projection, T a multiple of
    neither the chunk nor the ring."""
    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ref

    rng = np.random.default_rng(6)
    B, S, H, N = 3, 45, 5, 64
    r = _randn(rng, (B, H, S, N), cuda)
    k, v = (_randn(rng, (B, S, H, N), cuda).transpose(1, 2) for _ in range(2))
    w = torch.from_numpy(rng.uniform(0.2, 0.99, (B, H, S, N)).astype(np.float32)).to(cuda)
    u = _randn(rng, (H, N), cuda)
    s0 = _randn(rng, (B, H, N, N), cuda) * 0.1
    got_o, got_s = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, s0)
    want_o, want_s = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)


def test_attention_kernels_at_recurrentgemma_shapes(cuda):
    """head_dim 256 with MQA: flash (ragged S, f32) and decode with G = 10
    against a bf16 ring cache."""
    from repro_torch.kernels.decode_attention import kernel_cuda as dec_k
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel_cuda as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref

    rng = np.random.default_rng(256)
    B, H, KVH, S, D = 2, 10, 1, 200, 256
    q, k, v = (_randn(rng, shape, cuda) for shape in ((B, H, S, D), (B, KVH, S, D),
                                                      (B, KVH, S, D)))
    torch.testing.assert_close(fa_k.flash_attention_cuda(q, k, v), fa_ref.attention_ref(q, k, v),
                               atol=2e-5, rtol=2e-5)
    qd = _randn(rng, (B, H, D), cuda)
    kc, vc = (_randn(rng, (B, KVH, 2048, D), cuda, torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([2048, 77], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(dec_k.decode_attention_cuda(qd, kc, vc, lengths),
                               dec_ref.decode_attention_ref(qd, kc, vc, lengths),
                               atol=2e-5, rtol=2e-5)


def test_scan_kernels_refuse_bad_inputs(cuda):
    from repro_torch.kernels.rglru_scan.kernel_cuda import rglru_scan_cuda
    from repro_torch.kernels.rwkv6_scan.kernel_cuda import rwkv6_scan_cuda

    x = torch.zeros((2, 5, 8), device=cuda)
    with pytest.raises(TypeError):
        rglru_scan_cuda(x, x.half())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan_cuda(x.transpose(0, 1), x.transpose(0, 1))
    y = torch.zeros((1, 2, 4, 48), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_scan_cuda(y, y, y, y, torch.zeros((2, 48), device=cuda))
    z = torch.zeros((1, 2, 4, 16), device=cuda)
    with pytest.raises(TypeError):
        rwkv6_scan_cuda(z, z, z, z.half(), torch.zeros((2, 16), device=cuda))


@pytest.mark.parametrize("arch,prompt,tol", [("recurrentgemma-2b", 150, 2e-3),
                                             ("rwkv6-7b", 40, 2e-2)])
def test_small_recurrent_serve_card_equals_cpu(cuda, arch, prompt, tol):
    """Reduced 8x; recurrentgemma's prompt is longer than its window (128).
    rwkv6's decode re-rounds its token shifts to the bf16 cache at every
    step, so the sums' order compounds further (tests/test_torch_lm_recurrent.py)."""
    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM, layers

    cfg = serve.reduce_config(configs.get_config(arch), 8)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(5), dtype=torch.float32)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, prompt))
    cpu_tokens, cpu_logits = serve.serve_batch(lm, params, prompts, 4, return_logits=True)
    kernels.reset_launch_counts()
    card = layers.tree_map(lambda t: t.to(cuda), params)
    tokens, logits = serve.serve_batch(lm, card, prompts, 4, return_logits=True)
    counts = kernels.launch_counts()
    kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
    if arch == "rwkv6-7b":
        assert counts["rwkv6_scan"] == cfg.n_layers * 4
    else:
        assert counts["rglru_scan"] == kinds.count("rec")
        assert counts["decode_attention"] == kinds.count("local_attn") * 3
    np.testing.assert_array_equal(tokens, cpu_tokens)
    np.testing.assert_allclose(logits, cpu_logits, atol=tol, rtol=tol)


# --- the rest of the scheduler on the card: MCMF, streamed replays, serving --


@pytest.mark.parametrize("seed", range(3))
def test_bellman_ford_card_equals_cpu(cuda, seed):
    """int32 `amin` scatters on the card give the CPU's dist and parent,
    unreachable nodes and negative-cost reverse arcs included."""
    from repro_torch.core import mcmf

    rng = np.random.default_rng(seed)
    n, E = 400, 3000
    src = rng.integers(0, n - 20, size=E)
    dst = rng.integers(0, n - 20, size=E)
    resid = rng.integers(0, 2, size=2 * E).astype(np.int32)
    cost = rng.integers(0, 500, size=E)
    src2 = np.concatenate([src, dst]).astype(np.int64)
    dst2 = np.concatenate([dst, src]).astype(np.int64)
    cost2 = np.concatenate([cost, -cost]).astype(np.int32)
    out = {}
    for dev in ("cpu", cuda):
        args = [torch.from_numpy(a).to(dev) for a in (src2, dst2, cost2, resid)]
        d, p, it, _reads = mcmf._bellman_ford(*args, 0, n)
        out[str(dev)] = (d.cpu(), p.cpu(), it)
    a, b = out.values()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2]


def _scheduler_pair(streamed):
    from repro_torch.core import latency, topology, trace, workload

    topo = topology.Topology(n_machines=96, machines_per_rack=8, racks_per_pod=3,
                             slots_per_machine=4)
    plane = latency.LatencyPlane.synthesize(topo, duration_s=60, seed=1)
    wl = (trace.synth_trace(topo, 60, seed=2, window_s=20) if streamed
          else workload.synth_workload(topo, duration_s=60, seed=1, target_utilisation=0.6))
    return wl, plane


def test_mcmf_replay_card_equals_cpu(cuda):
    from repro_torch.core import policy, simulator

    wl, plane = _scheduler_pair(streamed=False)
    runs = [simulator.Simulator(wl, plane, simulator.SimConfig(
        policy="nomora", backend="mcmf", seed=5, fixed_algo_s=0.0, migration_interval_s=30,
        params=policy.PolicyParams(preemption=True, beta_scale=0.0), device=dev)).run()
        for dev in ("cpu", "cuda")]
    assert runs[0].rounds > 0 and runs[0].tasks_migrated > 0
    for f in ("placement_latency_s", "response_time_s", "migrated_pct_per_round",
              "per_job_perf", "tasks_placed", "tasks_migrated", "rounds"):
        assert getattr(runs[0], f) == getattr(runs[1], f), f


def test_streamed_replay_card_equals_cpu(cuda):
    import math

    from repro_torch.core import simulator

    cur, plane = _scheduler_pair(streamed=True)
    runs = [simulator.Simulator(cur, plane, simulator.SimConfig(
        policy="nomora", seed=5, fixed_algo_s=0.0, streaming_metrics=True,
        device=dev)).run().summary() for dev in ("cpu", "cuda")]
    assert runs[0].keys() == runs[1].keys() and runs[0]["tasks_placed"] > 0
    for k in runs[0]:
        assert runs[0][k] == runs[1][k] or (math.isnan(runs[0][k]) and math.isnan(runs[1][k]))


def test_schedule_service_on_the_card_zero_compiles(cuda):
    import dataclasses

    from repro_torch import obs
    from repro_torch.core import scenarios, serving

    cfg = serving.ServingConfig(**scenarios.get_serving_preset("smoke").config_kwargs,
                                record_rounds=8)
    with obs.scope():
        card = serving.ScheduleService(cfg)
        rep = card.run()
    assert rep.drained and rep.jit_compiles_post_warmup == 0.0
    assert rep.replay_mismatches == 0
    cpu = serving.ScheduleService(dataclasses.replace(cfg, device="cpu"))
    cpu.run()
    assert np.array_equal(card.sim.tt.machine[: card.sim.tt.n],
                          cpu.sim.tt.machine[: cpu.sim.tt.n])

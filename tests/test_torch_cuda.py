"""repro_torch on the card: each CUDA kernel against its plain version on
the same CUDA tensors (the scheduler's kernels exact: tolerance 0, index
included; the attention kernels within 2e-5 in f32 and 2e-2 with 16-bit
inputs, the order of the sums differing; flash's backward within 1e-5 of
each gradient's largest magnitude in f32; the scans within 1e-5 (RG-LRU)
and 1e-4 (RWKV-6) in f32, as tests/test_kernels_scans.py), the kernels'
input checks, a small replay and small serves on CUDA against the same on
CPU, and two spawned ranks on the card (gloo, host-staged; NCCL where two
cards exist) against the same ranks on the CPU.

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
        (2, 48, 8, 1024, 128, "f32", True),  # dbrx-132b: G = 6
        (2, 40, 8, 1024, 128, "f32", True),  # llama4-scout: G = 5
        (2, 32, 8, 1024, 128, "f32", True),  # llama-3.2-vision: G = 4
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
        (8, 48, 8, 1088, 128, "f32", "bf16"),  # dbrx-132b serving: G = 6
        (8, 40, 8, 1088, 128, "f32", "bf16"),  # llama4-scout serving: G = 5
        (8, 32, 8, 1088, 128, "f32", "bf16"),  # llama-3.2-vision self-attention: G = 4
        (8, 32, 8, 1601, 128, "f32", "bf16"),  # its image cache: odd S
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


def test_decode_kernel_against_a_full_image_cache(cuda):
    """The VLM's cross layers: every row attends to all 1,601 image
    positions (lengths = S), the cache a view of the stacked layers'."""
    from repro_torch.kernels.decode_attention import kernel_cuda, ref

    rng = np.random.default_rng(1601)
    B, H, KVH, S, D = 8, 32, 8, 1601, 128
    q = _randn(rng, (B, H, D), cuda)
    stacked = _randn(rng, (2, 2, B, KVH, S, D), cuda, torch.bfloat16)
    kc, vc = stacked[1, 0], stacked[1, 1]
    lengths = torch.full((B,), S, dtype=torch.int32, device=cuda)
    got = kernel_cuda.decode_attention_cuda(q, kc, vc, lengths)
    torch.testing.assert_close(got, ref.decode_attention_ref(q, kc, vc, lengths),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e", "llama-3.2-vision-11b"])
def test_small_moe_and_vlm_greedy_card_equals_cpu(cuda, arch):
    """reduce 8 (MoE at capacity factor 1.25: pairs are dropped), the VLM
    with image embeddings and non-zero gates: greedy tokens equal, logits
    within 2e-3, exact launches."""
    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM, layers

    cfg = serve.reduce_config(configs.get_config(arch), 8)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(6), dtype=torch.float32)
    kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
    for key in params["blocks"]:
        if key.endswith("cross"):
            params["blocks"][key]["attn"]["gate"].fill_(0.7)
    rng = np.random.default_rng(6)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 40)))
    batch = {"tokens": prompts}
    if cfg.n_image_tokens:
        batch["images"] = torch.from_numpy(
            rng.normal(0, 1, (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))

    def greedy(p, device):
        b = {k: v.to(device) for k, v in batch.items()}
        logits, cache, lengths = lm.prefill(p, b, s_max=46)
        out, seen = [logits.argmax(-1)], [logits]
        for _ in range(5):
            logits, cache, lengths = lm.decode_step(p, {"tokens": out[-1][:, None]}, cache,
                                                    lengths)
            out.append(logits.argmax(-1))
            seen.append(logits)
        return torch.stack(out, 1).cpu().numpy(), torch.stack(seen, 1).cpu().numpy()

    cpu_tokens, cpu_logits = greedy(params, "cpu")
    kernels.reset_launch_counts()
    tokens, logits = greedy(layers.tree_map(lambda t: t.to(cuda), params), cuda)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == len(kinds) - kinds.count("cross")
    assert counts["decode_attention"] == len(kinds) * 5
    np.testing.assert_array_equal(tokens, cpu_tokens)
    np.testing.assert_allclose(logits, cpu_logits, atol=2e-3, rtol=2e-3)


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


# --------------------------------------------------------------------- training:
# gradients through the kernels. Each op on CUDA tensors that require grad
# launches its kernel in the forward and must give the plain path's
# gradients: flash's backward is a kernel of its own, RG-LRU's recomputes
# the plain version, RWKV-6's the plain version chunk by chunk; decode
# raises.


def _grads_through(fn, inputs, cot):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*ins)
    loss = sum((o * c).sum() for o, c in zip(out, cot)) if isinstance(out, tuple) \
        else (out * cot).sum()
    loss.backward()
    return [t.grad for t in ins]


# The backward kernel against autograd through the plain version: within
# FLASH_GRAD_TOL of the larger of each gradient's largest magnitude and 1
# (at S = 1 dq and dk are 0: one key takes all the weight) in f32 (the two
# differ by the order of their sums and by P recomputed from the saved
# log-sum-exp; the CPU twin, tests/test_torch_flash_bwd_twin.py, reads a few
# 1e-7; one TF32 pass reads ~1e-4 there and misses), 2e-2 with 16-bit inputs
# (Δ comes from the output as stored).
FLASH_GRAD_TOL = {"f32": 1e-5, "bf16": 2e-2, "f16": 2e-2}


def _grad_err(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max() / max(float(b.abs().max()), 1.0))
               for a, b in zip(got, want))


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
        (2, 48, 8, 1024, 128, "f32", True),  # dbrx-132b: G = 6
        (2, 40, 8, 1024, 128, "f32", True),  # llama4-scout: G = 5
        (2, 32, 8, 1024, 128, "f32", True),  # llama-3.2-vision: G = 4
        (1, 16, 8, 4096, 128, "f32", True),  # qwen3-0.6b train-4k's layer at batch 1
    ],
)
def test_flash_backward_equals_plain_on_card(cuda, B, H, KVH, S, D, dt, causal):
    """The Function's gradients: one forward launch and one backward call
    (a set of launches), within FLASH_GRAD_TOL of autograd through the
    plain version, and the same bits from a second backward."""
    from repro_torch.kernels.flash_attention import kernel_cuda, ops, ref

    rng = np.random.default_rng(B * 1000 + S + D)
    q, k, v, cot = (
        torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda, _ATT_DTYPES[dt])
        for shape in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D), (B, H, S, D))
    )
    fwd, bwd = kernel_cuda.flash_attention_cuda, kernel_cuda.flash_attention_backward_cuda
    before = fwd.launches, bwd.launches
    got = _grads_through(lambda *a: ops.flash_attention(*a, causal=causal), (q, k, v), cot)
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    again = _grads_through(lambda *a: ops.flash_attention(*a, causal=causal), (q, k, v), cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = _grads_through(lambda *a: ref.attention_ref(*a, causal=causal), (q, k, v), cot)
    assert all(a.dtype == b.dtype and a.shape == b.shape for a, b in zip(got, want))
    assert _grad_err(got, want) <= FLASH_GRAD_TOL[dt]


def test_flash_backward_one_tf32_pass_misses_the_tolerance(cuda):
    """The plain version with its products in TF32 misses FLASH_GRAD_TOL at
    train-4k's layer shape (batch 1), where the kernel meets it."""
    from repro_torch.kernels.flash_attention import ref

    rng = np.random.default_rng(7)
    q, k, v, cot = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(cuda)
                    for shape in ((1, 16, 4096, 128), (1, 8, 4096, 128), (1, 8, 4096, 128),
                                  (1, 16, 4096, 128)))
    want = _grads_through(lambda *a: ref.attention_ref(*a), (q, k, v), cot)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = _grads_through(lambda *a: ref.attention_ref(*a), (q, k, v), cot)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert _grad_err(tf32, want) > FLASH_GRAD_TOL["f32"]


def test_flash_backward_takes_strided_heads_and_odd_head_dims(cuda):
    """q, k, v as the (B, S, H, D) -> (B, H, S, D) views the blocks pass,
    a cotangent that is not contiguous, and head_dim 42 (zero-padded to 64
    as the forward pads it)."""
    from repro_torch.kernels.flash_attention import ops, ref

    rng = np.random.default_rng(12)
    for D in (64, 42):
        B, S, H, KVH = 2, 96, 4, 2
        q = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32)).to(cuda)
        kv = torch.from_numpy(rng.normal(0, 1, (B, S, 2 * KVH, D)).astype(np.float32)).to(cuda)
        cot = torch.from_numpy(rng.normal(0, 1, (B, S, H, D)).astype(np.float32)).to(cuda)

        def views(q, kv):
            return q.transpose(1, 2), kv[:, :, :KVH].transpose(1, 2), kv[:, :, KVH:].transpose(1, 2)

        got = _grads_through(lambda q, kv: ops.flash_attention(*views(q, kv)), (q, kv),
                             cot.transpose(1, 2))
        want = _grads_through(lambda q, kv: ref.attention_ref(*views(q, kv)), (q, kv),
                              cot.transpose(1, 2))
        assert _grad_err(got, want) <= FLASH_GRAD_TOL["f32"]


def test_rglru_backward_equals_plain_on_card(cuda):
    from repro_torch.kernels.rglru_scan import kernel_cuda, ops, ref

    g = torch.Generator(device=cuda).manual_seed(1)
    la = -torch.rand((2, 70, 96), device=cuda, generator=g) * 2 - 1e-3
    gx = torch.randn((2, 70, 96), device=cuda, generator=g)
    h0 = torch.randn((2, 96), device=cuda, generator=g)
    cot = (torch.randn(gx.shape, device=cuda, generator=g),
           torch.randn((2, 96), device=cuda, generator=g))
    before = kernel_cuda.rglru_scan_cuda.launches
    got = _grads_through(lambda *a: ops.rglru_scan(*a), (la, gx, h0), cot)
    assert kernel_cuda.rglru_scan_cuda.launches == before + 1
    want = _grads_through(lambda *a: ref.rglru_scan_ref(*a), (la, gx, h0), cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_rwkv6_backward_equals_plain_on_card(cuda):
    """The chunked op (3 chunks of 8) against plain autograd through the
    whole scan: the chunk states come from the kernel (within the forward's
    1e-4), the carried gradients sum in another order."""
    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ops, ref

    g = torch.Generator(device=cuda).manual_seed(2)
    B, H, T, N = 2, 3, 24, 32
    r, k, v = (torch.randn((B, H, T, N), device=cuda, generator=g) for _ in range(3))
    w = torch.rand((B, H, T, N), device=cuda, generator=g) * 0.8 + 0.199
    u = torch.randn((H, N), device=cuda, generator=g) * 0.5
    s0 = torch.randn((B, H, N, N), device=cuda, generator=g) * 0.1
    cot = (torch.randn((B, H, T, N), device=cuda, generator=g),
           torch.randn((B, H, N, N), device=cuda, generator=g))
    before = kernel_cuda.rwkv6_scan_cuda.launches
    got = _grads_through(lambda *a: ops.rwkv6_scan(*a, chunk=8), (r, k, v, w, u, s0), cot)
    assert kernel_cuda.rwkv6_scan_cuda.launches == before + 3
    want = _grads_through(lambda *a: ref.rwkv6_scan_ref(*a), (r, k, v, w, u, s0), cot)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_decode_attention_raises_under_grad_on_card(cuda):
    from repro_torch.kernels.decode_attention import ops

    q = torch.zeros((1, 2, 64), device=cuda, requires_grad=True)
    cache = torch.zeros((1, 1, 16, 64), device=cuda)
    lengths = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q, cache, cache, lengths)


def test_small_train_step_card_equals_cpu(cuda):
    """qwen3-0.6b and rwkv6-7b at reduce 8: one step's loss (rtol 1e-4) and
    gradients on the card equal the CPU's, each leaf within 1e-3 (qwen3)
    and 1e-2 (rwkv6) of its largest value. rwkv6's group norm divides each
    head's outputs by their spread and enlarges rounding differences (its
    logits already need 1e-3 where qwen3's need 1e-4,
    tests/test_torch_lm_recurrent.py)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import loss_and_grads

    for arch, S, tol in (("qwen3-0.6b", 64, 1e-3), ("rwkv6-7b", 64, 1e-2)):
        lm = LM(serve.reduce_config(configs.get_config(arch), 8))
        params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
        toks = torch.from_numpy(np.random.default_rng(0).integers(0, lm.cfg.vocab_size, (2, S)))
        cpu = loss_and_grads(lm, params, {"tokens": toks})
        card = loss_and_grads(lm, tree_map(lambda t: t.to(cuda), params),
                              {"tokens": toks.to(cuda)})
        torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=1e-4, atol=0)
        for a, b in zip(leaves(card[1]), leaves(cpu[1])):
            torch.testing.assert_close(a.cpu(), b, rtol=0,
                                       atol=tol * float(b.abs().max()) + 1e-6)


def _rank_runs(device, backend):
    """Two ranks of a 2x1 mesh: the collectives, 2 FSDP steps, a
    compressed-DP step, the 2-stage pipeline's loss and gradients and a
    ``--mesh 2x1`` serve of a tiny dbrx (straddling MoE groups)."""
    import torch_rank_programs as progs
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed.comm import run_ranks, summed_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    tiny = dict(arch="qwen3-0.6b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128, vocab_size=512)
    moe = dict(tiny, arch="dbrx-132b", n_experts=4, experts_per_token=2, d_ff=96)
    params = {k: layers.tree_map(lambda t: t.numpy(), progs.lm_of(**kw).init(
        torch.Generator().manual_seed(0), torch.float32)) for k, kw in (("tiny", tiny),
                                                                        ("moe", moe))}
    data = SyntheticLMData(DataConfig(vocab_size=512, seq_len=64, global_batch=4))
    batches = [data.batch(i) for i in range(2)]
    prompts = [np.random.default_rng(1).integers(0, 512, (2, 45))]
    jobs = [("collectives", {}),
            ("fsdp", dict(program="fsdp_steps", arch_kw=tiny, params=params["tiny"],
                          batches=batches, lr=0.3, eps=1.0)),
            ("compressed", dict(program="compressed_steps", arch_kw=tiny,
                                params=params["tiny"], batches=batches[:1], lr=3e-3)),
            ("pp", dict(program="pp_grads", arch_kw=dict(tiny, n_layers=4),
                        params=layers.tree_map(lambda t: t.numpy(), progs.lm_of(
                            **dict(tiny, n_layers=4)).init(torch.Generator().manual_seed(1),
                                                           torch.float32)),
                        tokens=batches[0]["tokens"], n_microbatches=2,
                        mesh=((2,), ("pod",)))),
            ("serve", dict(program="serve", arch_kw=moe, params=params["moe"],
                           prompts=prompts, gen=4))]
    recs = run_ranks(progs.run_jobs, make_mesh((2, 1), ("data", "model")), jobs,
                     backend=backend, device=device, timeout_s=300)
    return [r["result"] for r in recs], summed_launches(recs)


def _same_runs(card, cpu):
    for a, b in zip(card, cpu):
        assert a["collectives"] == b["collectives"]
        np.testing.assert_allclose(a["fsdp"]["losses"], b["fsdp"]["losses"], rtol=1e-4)
        np.testing.assert_allclose(a["compressed"]["losses"], b["compressed"]["losses"],
                                   rtol=1e-4)
        np.testing.assert_allclose(a["pp"]["loss"], b["pp"]["loss"], rtol=1e-5)
        for g, h in zip(a["pp"]["grads"]["blocks"]["pos0_dense"]["attn"].values(),
                        b["pp"]["grads"]["blocks"]["pos0_dense"]["attn"].values()):
            assert float((g - h).abs().max()) <= 1e-4 * float(h.abs().max()) + 1e-8
        np.testing.assert_array_equal(a["serve"][0]["tokens"], b["serve"][0]["tokens"])
        np.testing.assert_allclose(a["serve"][0]["logits"], b["serve"][0]["logits"],
                                   rtol=2e-3, atol=2e-3)


def test_two_gloo_ranks_on_the_card_equal_cpu_ranks(cuda):
    """Two ranks sharing the card through host-staged gloo against the
    same run with its ranks on the CPU; the kernels ran on the card."""
    card, launches = _rank_runs("cuda", "gloo")
    cpu, cpu_launches = _rank_runs("cpu", "gloo")
    _same_runs(card, cpu)
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0
    assert cpu_launches["flash_attention"] == 0


def test_nccl_ranks_on_two_cards_equal_cpu_ranks(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs one card per rank: fewer than 2 cards")
    card, launches = _rank_runs("cuda", "nccl")
    cpu, _ = _rank_runs("cpu", "gloo")
    _same_runs(card, cpu)
    assert launches["flash_attention"] > 0


@pytest.mark.parametrize("B,H,KVH,S,D,c_dt", [
    (8, 16, 1, 1056, 128, "bf16"),  # a qwen3-0.6b-like cache shard, all H heads
    (8, 10, 1, 1024, 256, "bf16"),  # recurrentgemma-2b's ring shard at model = 2
    (3, 6, 1, 77, 18, "f32"),  # the CUDA cores' element path
])
def test_decode_log_sum_exp_and_shard_merge_equal_plain(cuda, B, H, KVH, S, D, c_dt):
    """``return_lse``: the kernel's output and (B, H) log-sum-exp against
    the plain version's, rows with no valid position included (zeros and
    -inf); two position shards merged by `merge_partials` against the plain
    version over the whole cache."""
    from repro_torch.kernels.decode_attention import kernel_cuda, ref
    from repro_torch.models.attention import merge_partials

    rng = np.random.default_rng(B + S + D)
    q = _randn(rng, (B, H, D), cuda)
    kc, vc = (_randn(rng, (B, KVH, 2 * S, D), cuda, _ATT_DTYPES[c_dt]) for _ in range(2))
    valid = rng.integers(1, 2 * S + 1, size=B)
    valid[0], valid[1], valid[-1] = 1, S, 2 * S
    outs, lses = [], []
    for r in range(2):
        n = torch.from_numpy(np.clip(valid - r * S, 0, S).astype(np.int32)).to(cuda)
        ks, vs = kc[:, :, r * S:(r + 1) * S].contiguous(), vc[:, :, r * S:(r + 1) * S].contiguous()
        before = kernel_cuda.decode_attention_cuda.lse_launches
        o, lse = kernel_cuda.decode_attention_cuda(q, ks, vs, n, return_lse=True)
        assert kernel_cuda.decode_attention_cuda.lse_launches == before + 1
        po, plse = ref.decode_attention_ref(q, ks, vs, n, return_lse=True)
        torch.testing.assert_close(o, po, atol=2e-5, rtol=2e-5)
        empty = n == 0
        assert torch.isneginf(lse[empty]).all() and not o[empty].any()
        torch.testing.assert_close(lse[~empty], plse[~empty], atol=2e-5, rtol=2e-5)
        outs.append(o)
        lses.append(lse)
    merged = merge_partials(torch.stack(outs), torch.stack(lses),
                            lambda t: t.amax(0, keepdim=True), lambda t: t.sum(0, keepdim=True))[0]
    want = ref.decode_attention_ref(q, kc, vc, torch.from_numpy(valid.astype(np.int32)).to(cuda))
    torch.testing.assert_close(merged, want, atol=2e-5, rtol=2e-5)


def _tp_runs(device, backend):
    """A dense config (qwen3-0.6b, KV heads split) and a sequence-sharded
    one (granite-20b, its one KV head: the cache's sequence split, merged
    by the log-sum-exp) served on a 1x2 mesh at reduce 8."""
    import torch_rank_programs as progs
    from repro_torch.distributed.comm import run_ranks, summed_launches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers

    jobs = []
    for i, arch in enumerate(("qwen3-0.6b", "granite-20b")):
        kw = dict(arch=arch, reduce=8)
        params = layers.tree_map(lambda t: t.numpy(), progs.lm_of(**kw).init(
            torch.Generator().manual_seed(i), torch.float32))
        prompts = np.random.default_rng(i).integers(0, 4096, (4, 40))
        jobs.append((arch, dict(program="tp_serve", arch_kw=kw, params=params,
                                batch={"tokens": prompts}, gen=6, prompts=prompts)))
    recs = run_ranks(progs.run_jobs, make_mesh((1, 2), ("data", "model")), jobs,
                     backend=backend, device=device, timeout_s=300)
    return [r["result"] for r in recs], summed_launches(recs), [
        r["decode_lse_launches"] for r in recs]


def _same_tp_runs(card, cpu):
    for a, b in zip(card, cpu):
        for arch in a:
            np.testing.assert_array_equal(a[arch]["tokens"], b[arch]["tokens"])
            np.testing.assert_array_equal(a[arch]["served"], b[arch]["served"])
            torch.testing.assert_close(a[arch]["logits"], b[arch]["logits"], rtol=2e-3, atol=2e-3)


def test_two_gloo_model_ranks_on_the_card_equal_cpu_ranks(cuda):
    card, launches, lse = _tp_runs("cuda", "gloo")
    cpu, _, _ = _tp_runs("cpu", "gloo")
    _same_tp_runs(card, cpu)
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0
    assert all(n > 0 for n in lse)  # granite's sequence-split cache


def test_nccl_model_ranks_on_two_cards_equal_cpu_ranks(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs one card per rank: fewer than 2 cards")
    card, launches, lse = _tp_runs("cuda", "nccl")
    cpu, _, _ = _tp_runs("cpu", "gloo")
    _same_tp_runs(card, cpu)
    assert launches["decode_attention"] > 0 and all(n > 0 for n in lse)

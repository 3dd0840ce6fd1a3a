"""repro_torch on the card: each CUDA kernel against its plain version on
the same CUDA tensors (exact: tolerance 0, index included), the kernels'
input checks, and a small replay on CUDA against the same replay on CPU.

Marked ``cuda``; every test skips without a CUDA device. On the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

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
    assert counts["costmap"] > 0 and counts["auction_bid"] > 0
    a, b = out["cuda"], out["cpu"]
    for f in ("tasks_placed", "tasks_migrated", "rounds", "placement_latency_s",
              "response_time_s", "per_job_perf", "migrated_pct_per_round"):
        assert getattr(a, f) == getattr(b, f), f

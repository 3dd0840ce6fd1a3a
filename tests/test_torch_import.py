"""repro_torch stands alone: importing it pulls in neither jax nor the
reference package, its sources never import them, CUDA is never silently
replaced by the CPU, and CPU tensors take the plain versions without
touching the kernels' launch counters."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys, repro_torch, repro_torch.core.simulator, repro_torch.kernels\n"
        "import repro_torch.launch.serve, repro_torch.models, repro_torch.convert\n"
        "import repro_torch.configs; repro_torch.configs.list_archs()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_migration_path_imports_leave_jax_and_reference_out():
    code = (
        "import sys, repro_torch.core.round_program, repro_torch.core.latency_device\n"
        "import repro_torch.core.scenarios\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scheduler_rest_imports_leave_jax_and_reference_out():
    code = (
        "import sys, repro_torch.core.flow_network, repro_torch.core.mcmf\n"
        "import repro_torch.core.reference_sim, repro_torch.core.trace\n"
        "import repro_torch.core.metrics_stream, repro_torch.core.serving\n"
        "import repro_torch.core.sweep, repro_torch.obs.export\n"
        "from repro_torch.core import perf_model; perf_model.fit_perf_model\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_training_imports_leave_jax_and_reference_out():
    code = (
        "import sys, repro_torch.launch.train, repro_torch.optim, repro_torch.checkpoint\n"
        "import repro_torch.train, repro_torch.data\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_launcher_imports_leave_jax_and_reference_out():
    code = (
        "import sys, repro_torch.launch.schedule, repro_torch.launch.mesh\n"
        "import repro_torch.launch.train, repro_torch.distributed.comm\n"
        "import repro_torch.distributed.sharding, repro_torch.distributed.elastic\n"
        "import repro_torch.optim.compression, repro_torch.train.compressed_dp\n"
        "import repro_torch.train.pipeline, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.rooftool\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


REFERENCE_MODULES = sorted(p.relative_to(ROOT / "src" / "repro").as_posix()
                           for p in (ROOT / "src" / "repro").rglob("*.py"))


def test_the_reference_modules_are_listed():
    assert len(REFERENCE_MODULES) > 80
    assert "launch/dryrun.py" in REFERENCE_MODULES and "core/auction.py" in REFERENCE_MODULES


@pytest.mark.parametrize("module", REFERENCE_MODULES)
def test_every_reference_module_has_a_counterpart(module):
    """The port is whole: each module of the reference has a file of the
    same path in repro_torch; a Pallas kernel (``kernels/*/kernel.py``)
    has its CUDA wrapper, ``kernel_cuda.py``, beside the port's plain
    version."""
    path = Path(module)
    if path.parts[0] == "kernels" and path.name == "kernel.py":
        path = path.with_name("kernel_cuda.py")
    assert (ROOT / "src" / "repro_torch" / path).exists(), module


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def test_sources_never_import_jax_or_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in files
        for m in _FORBIDDEN.finditer(p.read_text())
    ]
    assert not hits, hits


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot be shown")
    from repro_torch.core import simulator, topology, latency, workload
    from repro_torch.device import resolve_device

    topo = topology.Topology(16, 8, 2, slots_per_machine=2)
    wl = workload.synth_workload(topo, 10, seed=0)
    plane = latency.LatencyPlane.synthesize(topo, 10, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        simulator.Simulator(wl, plane, simulator.SimConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_take_plain_versions():
    from repro_torch import kernels
    from repro_torch.core import perf_model
    from repro_torch.kernels.auction_bid import ops as bid_ops
    from repro_torch.kernels.auction_phase import ops as phase_ops
    from repro_torch.kernels.costmap import ops as cm_ops

    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    lat = torch.from_numpy(rng.uniform(0, 900, size=(3, 40)).astype(np.float32))
    cost = cm_ops.costmap(perf_model.perf_lut_table(), torch.zeros(3, dtype=torch.int32), lat)
    assert cost.dtype == torch.int32
    values = torch.from_numpy(-rng.integers(0, 50, size=(3, 40)).astype(np.float32))
    prices = torch.zeros(40)
    idx, best, second = bid_ops.bid_top2(values, prices, prices)
    assert idx.dtype == torch.int32
    price, owner, assigned, iters = phase_ops.auction_phase(
        torch.zeros((40, 1)), values, torch.full((3,), -1e6),
        torch.full((3,), 40, dtype=torch.int32), torch.ones(3, dtype=torch.bool), 1.0, 100)
    assert assigned.dtype == torch.int32 and (assigned >= 0).all() and iters > 0
    assert kernels.launch_counts() == {
        "costmap": 0, "auction_bid": 0, "auction_phase": 0, "flash_attention": 0,
        "flash_attention_bwd": 0, "decode_attention": 0, "rglru_scan": 0, "rwkv6_scan": 0,
    }


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.auction_bid.kernel_cuda import bid_top2_cuda
    from repro_torch.kernels.auction_phase.kernel_cuda import auction_phase_cuda
    from repro_torch.kernels.costmap.kernel_cuda import costmap_cuda

    x = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        costmap_cuda(torch.zeros((4, 101)), torch.zeros(2, dtype=torch.int32), x)
    with pytest.raises(ValueError, match="CUDA"):
        bid_top2_cuda(x, torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA"):
        auction_phase_cuda(torch.zeros((3, 1)), x, torch.zeros(2),
                           torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool),
                           1.0, 10)


def test_serve_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot be shown")
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch import configs

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduce", "8", "--requests", "1", "--prompt-len", "4", "--gen", "2"])
    lm = LM(serve.reduce_config(configs.get_config("qwen3-0.6b"), 8))
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_cache(1, 8)


def test_schedule_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot be shown")
    from repro_torch.launch import mesh, schedule

    with pytest.raises(RuntimeError, match="cuda"):
        schedule.schedule_ml_jobs(32, 2, 20)
    with pytest.raises(RuntimeError, match="cuda"):
        schedule.main(["--machines", "32", "--jobs", "2", "--duration", "20"])
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.nomora_ordered_devices([0, 1], [5.0, 3.0])


def test_scan_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.rglru_scan.kernel_cuda import rglru_scan_cuda
    from repro_torch.kernels.rwkv6_scan.kernel_cuda import rwkv6_scan_cuda

    x = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_cuda(x[0], x[0])
    with pytest.raises(ValueError, match="CUDA"):
        rwkv6_scan_cuda(x, x, x, x, torch.zeros((2, 16)))


def test_attention_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.decode_attention.kernel_cuda import decode_attention_cuda
    from repro_torch.kernels.flash_attention.kernel_cuda import (
        flash_attention_backward_cuda,
        flash_attention_cuda,
    )

    x = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_backward_cuda(x, x, x, x, x, torch.zeros((1, 2, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_cuda(x[:, :, 0], x, x, torch.ones(1, dtype=torch.int32))

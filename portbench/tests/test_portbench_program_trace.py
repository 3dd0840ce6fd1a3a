"""`harness.program_trace` on a hand-made trace (the program's ranges on
two threads, nested ranges, the enqueuing calls paired with the device
operations by order, a ``within`` filter, calls at the start that no
operation answers, a copy whose start the trace puts before an earlier
kernel's, pairings that cannot hold), and the readers of its metrics on
the CPU traced runs, where no device operation exists: no value, no
exception."""

from __future__ import annotations

import math
import types

import pytest

import pb_tiny
from harness import program_trace
from harness.trace import Trace

NEW = ("backward_ms.train", "flash_backward_ms.train", "forward_ms.train",
       "optimizer_ms.train", "prefill_device_ms.prefill", "moe_experts_roofline.chat",
       "moe_overhead_ms.chat")


def _trace(extra_host=(), extra_dev=(), copy_at=1350):
    """Host clock in ns. The main thread's step holds a backward range
    [100, 400]; autograd's thread holds flash_backward [150, 250] and
    launches k1 and k2 inside it and k3 after it; k0 is launched before the
    step, k4 after it; a copy call at 300. Device operations run later, in
    the order enqueued, each kernel lasting 10 * (its index + 1) ns, the
    copy 7 ns."""
    host = [("repro_torch.step", 90, 450), ("repro_torch.lm.train.backward", 100, 400),
            ("repro_torch.lm.attn.flash_backward", 150, 250),
            ("cudaLaunchKernel", 50, 55), ("cudaLaunchKernel", 160, 165),
            ("cuLaunchKernel", 200, 205), ("cudaLaunchKernelExC", 260, 265),
            ("cudaMemcpyAsync", 300, 305), ("cudaLaunchKernel", 500, 505),
            ("cudaMalloc", 170, 180), ("aten::mm", 155, 210)] + list(extra_host)
    dev, t = [], 1000
    for i in range(5):
        dev.append((f"k{i}", t, t + 10 * (i + 1)))
        t += 100
    dev.append(("Memcpy HtoD (Pageable -> Device)", copy_at, copy_at + 7))
    dev += list(extra_dev)
    return Trace(sorted(dev, key=lambda x: x[1]), [], sorted(host, key=lambda x: x[1]))


def test_device_time_by_span_and_within():
    pt = program_trace.read(_trace())
    assert pt.dropped == {}
    assert pt.count("lm.train.backward") == 1 and pt.count("lm.moe.experts") == 0
    ns = 1e-9
    # k1 (20 ns), k2 (30) and k3 (40) were launched inside backward, with the copy (7).
    assert pt.device_s("lm.train.backward") == pytest.approx(97 * ns)
    assert pt.device_s("lm.attn.flash_backward") == pytest.approx(50 * ns)
    assert pt.device_s("lm.attn.flash_backward", within="lm.train.backward") == pytest.approx(
        50 * ns)
    assert pt.device_s("step") == pytest.approx(97 * ns)
    assert pt.device_s("lm.train.backward", within="lm.moe.experts") == 0.0
    assert pt.device_s("absent") == 0.0


def test_calls_the_trace_opens_with_and_no_operation_answers_are_dropped():
    # Two launches and a copy call at the trace's start whose operations the
    # profiler did not record: the pairing counts back from the end.
    early = [("cudaLaunchKernel", 10, 12), ("cuLaunchKernel", 20, 22),
             ("cudaMemcpyAsync", 30, 31)]
    pt = program_trace.read(_trace(extra_host=early))
    assert pt.dropped == {"kernel": 2, "memcpy": 1}
    assert pt.device_s("lm.train.backward") == pytest.approx(97e-9)
    assert pt.device_s("lm.attn.flash_backward") == pytest.approx(50e-9)


def test_a_copy_out_of_order_with_the_kernels_pairs_kind_by_kind():
    # The copy, enqueued after k3, carries a start before k3's.
    pt = program_trace.read(_trace(copy_at=1295))
    assert pt.device_s("lm.train.backward") == pytest.approx(97e-9)
    assert pt.device_s("lm.attn.flash_backward") == pytest.approx(50e-9)


def test_no_device_operation_reads_nothing():
    tr = _trace()
    assert program_trace.read(Trace([], [], tr.host_ops)) is None
    assert program_trace.read(None) is None


def test_ms_per():
    run = types.SimpleNamespace(facts={}, trace_data=_trace())
    assert program_trace.ms_per(run, "lm.train.backward", 2) == pytest.approx(97e-6 / 2)
    # Over the span's own ranges by default: flash_backward has one.
    assert program_trace.ms_per(run, "lm.attn.flash_backward") == pytest.approx(50e-6)
    assert program_trace.ms_per(run, "lm.train.backward", 0) is None
    assert program_trace.ms_per(run, "lm.moe.experts", 2) is None  # no such range


SLACK = program_trace.CLOCK_SLACK_NS


@pytest.mark.parametrize("case, host, dev", [
    # A kernel that no named call launched (a graph's, say): more kernels than calls.
    ("unnamed_launch", [("cudaGraphLaunch", 600, 605)], [("k5", 1500, 1510)]),
    # More calls at the start than a trace may open with.
    ("unanswered", [("cudaLaunchKernel", i, i + 1)
                    for i in range(program_trace.MAX_UNANSWERED + 1)], []),
    # A set that ran before its call, by more than the clocks' drift.
    ("before_call", [("cudaMemsetAsync", 1400 + SLACK + 10 ** 6, 1400 + SLACK + 10 ** 6 + 5)],
     [("Memset (Device)", 1460, 1465)]),
])
def test_a_pairing_that_does_not_hold_reads_nothing(case, host, dev):
    assert program_trace.read(_trace()) is not None
    assert program_trace.read(_trace(extra_host=host, extra_dev=dev)) is None


@pytest.mark.parametrize("cell", ["qwen3-0.6b.train-4k", "qwen3-0.6b.prefill-long",
                                  "dbrx-132b.chat"])
def test_new_readers_read_nothing_on_the_cpu(cell):
    from harness import spec

    listed = {m["name"] for m in spec.load_cell(cell).per_layer}
    assert listed & set(NEW)
    code, res = pb_tiny.execute(cell, trace=1)
    assert code == 0 and res["correct"] is True
    assert not set(res["metrics"]) & set(NEW)
    assert all(math.isfinite(m["value"]) for m in res["metrics"].values())

"""One run of each cell's driver at a tiny size on the CPU, through the
harness (plain kernel versions): the result line's keys, its metrics, and
`correct` against the reference; with the timed path broken underneath,
`correct` comes out false."""

from __future__ import annotations

import math

import pytest

import pb_tiny


@pytest.mark.parametrize("cell", pb_tiny.CELLS)
def test_run_is_correct_and_reports_its_metrics(cell):
    code, res = pb_tiny.execute(cell)
    assert code == 0
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    from harness import spec

    c = spec.load_cell(cell)
    assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
    for name, m in res["metrics"].items():
        assert math.isfinite(m["value"]) and m["value"] > 0, name
    assert res["device"]["count"] == 1


@pytest.mark.parametrize("cell", pb_tiny.CELLS)
def test_traced_run_reads_host_side_metrics(cell):
    code, res = pb_tiny.execute(cell, trace=1)
    assert code == 0 and res["correct"] is True
    # No device on the CPU: the device-trace readers find no kernel and
    # return nothing; the counts-over-spans readers report.
    names = set(res["metrics"])
    assert not any("roofline" in n for n in names)
    assert {n for n in names if n.startswith("mfu.")}
    assert res["device"]["window_s"] > 0
    assert "device_ops" in res["breakdown"] and "idle_gaps" in res["breakdown"]


@pytest.mark.parametrize("cell,fault", [
    ("qwen3-0.6b.train-4k", "half_batch"),
    ("qwen3-0.6b.train-4k", "stale_state"),
    ("qwen3-0.6b.prefill-long", "alter_token"),
    ("dbrx-132b.chat", "alter_token"),
])
def test_planted_fault_is_not_correct(cell, fault):
    code, res = pb_tiny.execute(cell, faults=(fault,))
    assert code == 0
    assert res["correct"] is False, res["checks"]


def test_moe_sample_meets_capacity_drops():
    """The tiny MoE cell's prefill drops pairs, so the check covers them."""
    import run as bench
    from harness import spec
    from harness.bench import Run
    import torch

    from reference import lm as ref

    cell = pb_tiny.shrink(spec.load_cell("dbrx-132b.chat"))
    drv = bench.load_file(bench.HERE / "drivers" / "serve.py", "pb_serve_drops")
    r = Run(cell, pb_tiny.SEED, 0.0, False, torch.device("cpu"), 0.0)
    prog = drv.setup(r)
    drv.measure(r, prog, cycles=1)
    b = [b for b in r.facts["batches"] if b["P"] == 256][0]
    routes = drv._routes_of(r, b, 0)
    moe = ref.kind("moe")
    group = b["B"] * b["P"] // moe.largest_divisor_leq(b["B"] * b["P"], 64)
    dropped = sum(int((~moe.kept(cell.arch, rt[:b["P"]], group)).sum()) for rt in routes)
    assert dropped > 0


@pytest.mark.parametrize("cell", ["qwen3-0.6b.prefill-long", "dbrx-132b.chat"])
def test_reference_server_agrees_with_the_reference_over_its_sequence(cell):
    """The reference's greedy server (the control's place) gives the
    logits and routes that the reference computes over its whole served
    sequence at once, in float32."""
    import numpy as np
    import torch

    from harness import spec, traffic as tr, weights
    from reference import lm as ref

    c = pb_tiny.shrink(spec.load_cell(cell))
    a, t = c.arch, c.traffic
    params = weights.make(a, pb_tiny.SEED, torch.device("cpu"))
    prompt = torch.as_tensor(np.asarray(tr.prompts(pb_tiny.SEED, 1, t, a["vocab_size"])[0]),
                             dtype=torch.long)
    with torch.no_grad(), ref.precision("f32"):
        tokens, logits, routes = ref.serve_greedy(a, params, prompt, t["gen_tokens"], t["batch"])
        whole, _, choices = ref.serve(a, params, torch.cat([prompt, tokens[:-1]]),
                                      prompt.shape[0], t["batch"])
    assert torch.equal(tokens, logits.argmax(-1))
    assert float((whole - logits).abs().max()) < 1e-4
    if routes is not None:
        assert all(torch.equal(r, ch) for r, ch in zip(routes, choices))


def test_missing_dispatch_records_stop_the_check():
    import torch

    import run as bench
    from harness import spec
    from harness.bench import Run

    cell = pb_tiny.shrink(spec.load_cell("dbrx-132b.chat"))
    drv = bench.load_file(bench.HERE / "drivers" / "serve.py", "pb_serve_records")
    r = Run(cell, pb_tiny.SEED, 0.0, False, torch.device("cpu"), 0.0)
    prog = drv.setup(r)
    drv.measure(r, prog, cycles=1)
    b = r.facts["batches"][0]
    assert len(drv._routes_of(r, b, b["rows"][0])) == cell.arch["n_layers"]
    del b["routes"][-1]
    with pytest.raises(RuntimeError, match="dispatch"):
        drv._routes_of(r, b, b["rows"][0])

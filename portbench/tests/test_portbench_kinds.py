"""Layer kinds found by name: a pattern of two kinds (dense and MoE, five
layers: two superblocks and a dense remainder layer) runs through the
train and serve drivers on the CPU with nothing added outside the tests;
its weights have the port's layout, its counts are its layers' counts,
and a kind with no file names the file to add."""

from __future__ import annotations

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import pb_tiny
from harness import counts, kinds, spec, weights
from reference import lm as ref

TWO_KINDS = dict(pattern=["dense", "moe"], n_layers=5, n_experts=4, experts_per_token=2,
                 moe_capacity_factor=1.25)


def _arch(**kw):
    a = copy.deepcopy(pb_tiny.shrink(spec.load_cell("qwen3-0.6b.train-4k"), **TWO_KINDS).arch)
    a.update(kw)
    return a


def test_two_kind_layers_run_in_the_ports_order():
    a = _arch()
    assert kinds.layers(a) == ["dense", "moe", "dense", "moe", "dense"]
    assert [(p, lead) for p, _, lead in kinds.positions(a)] == [
        (("blocks", "pos0_dense"), (2,)), (("blocks", "pos1_moe"), (2,)), (("rem0_dense",), ())]
    assert [(m.__name__.rsplit(".", 1)[1], n) for m, n in kinds.census(a)] == [
        ("dense", 3), ("moe", 2)]


def test_two_kind_layout_is_the_ports_param_specs():
    from harness.bench import check_layout, program_arch

    from repro_torch.models import LM

    a = _arch()
    params = weights.make(a, pb_tiny.SEED, torch.device("cpu"))
    check_layout(LM(program_arch(a)), params)
    assert set(params) == {"embed", "blocks", "rem0_dense", "final_norm"}
    assert params["blocks"]["pos1_moe"]["moe"]["we1"].shape == (2, 4, 64, 128)


def test_two_kind_train_cell_is_correct_and_its_half_batch_is_not():
    code, res = pb_tiny.execute("qwen3-0.6b.train-4k", **TWO_KINDS)
    assert code == 0 and res["correct"] is True, res["checks"]
    code, res = pb_tiny.execute("qwen3-0.6b.train-4k", faults=("half_batch",), **TWO_KINDS)
    assert code == 0 and res["correct"] is False, res["checks"]


def test_two_kind_chat_cell_checks_routes_of_its_moe_layers_only():
    import run as bench
    from harness.bench import Run

    arch = {k: v for k, v in TWO_KINDS.items() if k != "moe_capacity_factor"}
    code, res = pb_tiny.execute("dbrx-132b.chat", **arch)
    assert code == 0 and res["correct"] is True, res["checks"]
    assert "route_gap" in res["checks"]

    cell = pb_tiny.shrink(spec.load_cell("dbrx-132b.chat"), **arch)
    drv = bench.load_file(bench.HERE / "drivers" / "serve.py", "pb_serve_two_kinds")
    r = Run(cell, pb_tiny.SEED, 0.0, False, torch.device("cpu"), 0.0)
    prog = drv.setup(r)
    drv.measure(r, prog, cycles=1)
    for b in r.facts["batches"]:
        assert len(b["routes"]) == 2 * b["gen"]  # two MoE layers a step
        routes = drv._routes_of(r, b, b["rows"][0])
        assert [tuple(x.shape) for x in routes] == [(b["P"] + b["gen"] - 1, 2)] * 2


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_two_kind_counts_are_their_layers_counts():
    # A capacity factor that drops nothing: every token meets K experts.
    a = _arch(moe_capacity_factor=64.0, vocab_size=300, d_ff=96)
    params = weights.make(a, 5, torch.device("cpu"))
    leaves = [t.requires_grad_() for _, t in ref.leaves(params)]
    tok = torch.randint(0, a["vocab_size"], (3, 40))

    def step():
        torch.autograd.grad(ref.train_loss(a, params, tok, remat=False), leaves)

    # Full (non-causal) attention, as the reference multiplies it; its loss
    # scores S - 1 positions, the count's head S.
    want = counts.train_step_flops(a, 3, 40, causal=False) - 6.0 * counts.head_params(a) * 3
    assert _flops(step) == pytest.approx(want, rel=1e-12)
    with torch.no_grad():
        got = _flops(lambda: ref.serve(a, params, tok[0], 40, 1))
    assert got == pytest.approx(counts.prefill_flops(a, 1, 40, causal=False), rel=1e-12)

    ctx = [5, 11, 3]
    kv = 2 * a["n_kv_heads"] * a["head_dim"] * 2 * (sum(ctx) + len(ctx))
    dense, moe = kinds.load("dense"), kinds.load("moe")
    assert counts.decode_step_bytes(a, ctx) == (
        4 * (weights.numel(a) + len(ctx) * (a["d_model"] + a["vocab_size"])) + 5 * kv)
    assert counts.product_params(a) == (3 * dense.product_params(a) + 2 * moe.product_params(a)
                                        + counts.head_params(a))
    assert counts.decode_step_flops(a, ctx) == (
        2.0 * counts.product_params(a) * 3 + 4.0 * a["n_heads"] * a["head_dim"] * 5 * sum(ctx))


def test_a_kind_without_files_names_the_file_to_add():
    a = _arch(pattern=["dense", "nope"])
    with pytest.raises(ValueError, match="portbench/harness/kinds/nope.py"):
        weights.layout(a)
    with pytest.raises(ValueError, match="portbench/harness/kinds/nope.py"):
        counts.prefill_flops(a, 1, 8)
    with pytest.raises(ValueError, match="portbench/reference/kinds/nope.py"):
        ref.kind("nope")
    params = weights.make(_arch(), 5, torch.device("cpu"))
    params["blocks"]["pos1_nope"] = params["blocks"].pop("pos1_moe")
    with pytest.raises(ValueError, match="portbench/reference/kinds/nope.py"):
        ref.train_loss(a, params, torch.zeros(1, 8, dtype=torch.long))

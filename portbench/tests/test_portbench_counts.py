"""The frozen FLOP and byte counts: FLOPs against `FlopCounterMode` over
the plain reference (forward and backward, no remat), bytes against the
shapes of the weights the benchmark makes."""

from __future__ import annotations

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import pb_tiny  # noqa: F401  (paths)
from harness import counts, spec, weights
from reference import lm as ref


def _arch(config, **kw):
    a = copy.deepcopy(spec.load_config(config)["arch"])
    a.update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
             vocab_size=300)
    if a.get("n_experts"):
        a.update(n_experts=4, experts_per_token=2)
    a.update(kw)
    return a


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_train_step_flops_match_the_reference_forward_and_backward():
    a = _arch("qwen3-0.6b")
    params = weights.make(a, 5, "cpu")
    leaves = [t.requires_grad_() for _, t in ref.leaves(params)]
    tok = torch.randint(0, a["vocab_size"], (3, 40))

    def step():
        loss = ref.train_loss(a, params, tok, remat=False)
        torch.autograd.grad(loss, leaves)

    # The reference's attention multiplies every (query, key) pair; the
    # count's causal attention needs about half: compare the full count.
    # Its loss scores S - 1 positions: the head's count is for S.
    want = counts.train_step_flops(a, 3, 40, causal=False)
    want -= 6.0 * counts.head_params(a) * 3
    assert _flops(step) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("config", ["qwen3-0.6b", "dbrx-132b"])
def test_prefill_flops_match_the_reference_forward(config):
    # A capacity factor that drops nothing: every token meets K experts.
    a = _arch(config, moe_capacity_factor=64.0) if config == "dbrx-132b" else _arch(config)
    params = weights.make(a, 6, "cpu")
    tok = torch.randint(0, a["vocab_size"], (48,))
    with torch.no_grad():
        got = _flops(lambda: ref.serve(a, params, tok, 48, 1))
    assert got == pytest.approx(counts.prefill_flops(a, 1, 48, causal=False), rel=1e-12)


def test_decode_flops_are_the_forward_at_one_position():
    a = _arch("qwen3-0.6b")
    ctx = [7, 9]
    per_pos = 4.0 * a["n_heads"] * a["head_dim"] * a["n_layers"]
    assert counts.decode_step_flops(a, ctx) == (2.0 * counts.product_params(a) * 2
                                                + per_pos * 16)


@pytest.mark.parametrize("config", ["qwen3-0.6b", "dbrx-132b"])
def test_decode_bytes_count_every_weight_once(config):
    a = _arch(config)
    # The embedding table is read as rows, unless tied: then whole, as the head.
    n_weights = weights.numel(a)
    if not a.get("tie_embeddings"):
        n_weights -= a["vocab_size"] * a["d_model"]
    ctx = [5, 11, 3]
    B = len(ctx)
    kv = a["n_kv_heads"] * a["head_dim"]
    cache = 2 * a["n_layers"] * kv * 2 * (sum(ctx) + B)
    want = 4 * (n_weights + B * a["d_model"] + B * a["vocab_size"]) + cache
    assert counts.decode_step_bytes(a, ctx) == want


def test_flash_and_decode_attention_counts_from_shapes():
    f, b = counts.flash_call(2, 4, 2, 10, 16)
    assert f == 4.0 * 2 * 4 * 16 * 55
    assert b == 4 * (2 * 2 * 4 * 10 * 16 + 2 * 2 * 2 * 10 * 16)
    assert counts.decode_attn_bytes(4, 2, 16, [3, 5]) == 2 * 2 * 16 * 2 * 8 + 2 * 2 * 4 * 16 * 4

"""Telemetry inside the port's LM path, on the CPU: the spans at its layer
boundaries (serving's prefill and decode steps, the MoE's router,
dispatch, experts and combine, the train step's forward, backward and
optimizer, flash attention's plain backward), the profiler sink (each
span a ``repro_torch.<name>`` range of a `torch.profiler` trace,
telemetry on or off), and that none of it changes a token or a loss."""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import configs, obs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.obs.spans import _NULL_SPAN, PROFILER_PREFIX  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402

GEN = 4
MOE_SPANS = ("lm.moe.router", "lm.moe.dispatch", "lm.moe.experts", "lm.moe.combine")


@pytest.fixture(autouse=True)
def _obs_isolated():
    was = obs.enabled()
    obs.set_enabled(False)
    obs.reset()
    yield
    obs.set_enabled(was)
    obs.reset()


@pytest.fixture(scope="module")
def moe_lm():
    lm = LM(serve.reduce_config(configs.get_config("dbrx-132b"), 16))
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    prompts = np.random.default_rng(0).integers(0, lm.cfg.vocab_size, size=(2, 8))
    return lm, params, prompts


def _serve(moe_lm):
    lm, params, prompts = moe_lm
    return serve.serve_batch(lm, params, prompts, GEN)


def _train(grad_accum=1):
    """Two steps of a reduced qwen3-0.6b from seed 0: the losses."""
    lm = LM(dataclasses.replace(serve.reduce_config(configs.get_config("qwen3-0.6b"), 8),
                                n_layers=2))
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    opt = AdamW(AdamWConfig(lr=1e-3))
    step = build_train_step(lm, opt, remat=True, grad_accum=grad_accum)
    state = opt.init(params)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, lm.cfg.vocab_size, size=(2, 16)))
    losses = []
    for _ in range(2):
        state, m = step(state, {"tokens": tokens})
        losses.append(m["loss"])
    return torch.stack(losses)


def _serve_expected(lm):
    """(name, depth) of every span one `serve_batch` call of GEN tokens
    records: a prefill and GEN - 1 decode steps at depth 0, each with the
    four MoE spans of every layer inside it."""
    calls = collections.Counter({("lm.prefill", 0): 1, ("lm.decode_step", 0): GEN - 1})
    for name in MOE_SPANS:
        calls[(name, 1)] = lm.cfg.n_layers * GEN
    return calls


def _inside(outer, inner):
    return outer.t0_ns <= inner.t0_ns and inner.t0_ns + inner.dur_ns <= outer.t0_ns + outer.dur_ns


def test_serve_batch_records_prefill_decode_and_moe_spans(moe_lm):
    lm = moe_lm[0]
    with obs.scope() as tel:
        _serve(moe_lm)
        spans = list(tel.spans)
    assert collections.Counter((s.name, s.depth) for s in spans) == _serve_expected(lm)
    steps = [s for s in spans if s.name == "lm.decode_step"]
    assert [s.args for s in steps] == [{"step": j} for j in range(1, GEN)]
    calls = [s for s in spans if s.depth == 0]
    for s in spans:
        if s.depth == 1:
            assert sum(_inside(c, s) for c in calls) == 1, s
    # Within each call, each MoE layer runs router, dispatch, experts, combine in order.
    for c in calls:
        names = [s.name for s in sorted(spans, key=lambda s: s.t0_ns) if s.depth == 1
                 and _inside(c, s)]
        assert names == list(MOE_SPANS) * lm.cfg.n_layers


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_records_forward_backward_optimizer(grad_accum):
    with obs.scope() as tel:
        _train(grad_accum)
        names = collections.Counter((s.name, s.depth) for s in tel.spans)
    # Two steps; forward and backward once a microbatch, the optimizer once a step.
    assert names == {("lm.train.forward", 0): 2 * grad_accum,
                     ("lm.train.backward", 0): 2 * grad_accum,
                     ("lm.train.optimizer", 0): 2}


def test_flash_backward_records_a_span_per_backward():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 16, 8, generator=g, requires_grad=True)
    k = torch.randn(1, 2, 16, 8, generator=g, requires_grad=True)
    v = torch.randn(1, 2, 16, 8, generator=g, requires_grad=True)
    with obs.scope() as tel:
        for _ in range(2):
            out = flash_ops.FlashAttention.apply(q, k, v, True, 8 ** -0.5,
                                                 flash_ref.attention_ref)
            out.sum().backward()
        assert [s.name for s in tel.spans] == ["lm.attn.flash_backward"] * 2


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_disabled_records_nothing_and_changes_no_bits(kind, moe_lm):
    run = (lambda: _serve(moe_lm)) if kind == "serve" else _train
    assert obs.span("lm.prefill") is _NULL_SPAN
    off = run()
    assert obs.get().spans == [] and obs.counters() == {}
    with obs.scope() as tel:
        on = run()
        assert tel.spans
    if kind == "serve":
        np.testing.assert_array_equal(off, on)
    else:
        assert torch.equal(off, on)


def _profiled_ranges(prof):
    """(name, depth) of the ``repro_torch.*`` ranges of a CPU trace, the
    depth counted among those ranges on the same thread; every one must be
    a user annotation."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith(PROFILER_PREFIX)]
    assert all(e.is_user_annotation() for e in evs)
    out = collections.Counter()
    for e in evs:
        depth = sum(o is not e and o.start_thread_id() == e.start_thread_id()
                    and o.start_ns() <= e.start_ns()
                    and e.start_ns() + e.duration_ns() <= o.start_ns() + o.duration_ns()
                    for o in evs)
        out[(e.name()[len(PROFILER_PREFIX):], depth)] += 1
    return out


@pytest.mark.parametrize("telemetry", [True, False])
def test_spans_are_profiler_ranges(telemetry, moe_lm):
    """Under a `torch.profiler`, every span is a ``repro_torch.<name>``
    user-annotation range, nested as in the registry; with telemetry off
    the ranges are still there and the registry stays empty."""
    obs.set_enabled(telemetry)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(moe_lm)
    ranges = _profiled_ranges(prof)
    assert ranges == _serve_expected(moe_lm[0])
    registry = collections.Counter((s.name, s.depth) for s in obs.get().spans)
    assert registry == (ranges if telemetry else collections.Counter())


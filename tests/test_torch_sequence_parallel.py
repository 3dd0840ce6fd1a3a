"""repro_torch's sequence-sharded residual stream (``act_seq`` on the
``model`` axis, Megatron-style sequence parallelism) against the
reference's single-device train step on the CPU, with spawned ``gloo``
ranks (one spawn per mesh, run while this process computes the
reference; the ranks import no jax).

Rules are ``train_rules(False)`` with ``act_seq: ("model",)``; the
reference's ``constrain`` changes no arithmetic, so its one-device step
is the yardstick.

- 3 steps at ``reduce_config(…, 16)`` of batches (4, 16) on ``1x2`` for
  granite-20b (MQA: one K/V head, gathered whole at use), rwkv6-7b (token
  shifts across the pieces' boundary), musicgen-medium (``embeds``
  inputs), recurrentgemma-2b (conv and RG-LRU scan on the gathered
  sequence), dbrx-132b (MoE: groups, capacity and drops of the whole
  batch) and llama-3.2-vision-11b (cross layers: the query stream
  gathered, the image K/V whole, the gate's gradient summed), and on
  ``2x2`` for qwen3-0.6b (FSDP over ``data`` too); and on ``1x2`` for
  qwen3-0.6b and rwkv6-7b with rules that leave heads, KV
  heads and mlp whole (``model`` splits the vocab alone, so every block
  runs whole on each rank between the gather and the split): losses
  within rtol 1e-5, grad norms 1e-4, every parameter leaf within 1e-4 of
  its largest magnitude, against the reference and against the same
  ranks' step without ``act_seq``.
- Each rank's residual stream between superblocks is (B_local, S / 2, D),
  and the bytes that ``checkpoint`` saves of it per superblock halve
  (``saved_tensors_hooks``). With S = 15, which 2 does not divide, the
  stream stays whole (the reference's ``spec_for`` fallback) and the steps
  still equal the reference's.
- The leaves that ``model`` does not split have bit-equal gradients (the
  stream's norms after the step's sum over ``model``) and bit-equal
  values after the steps on the two ranks of ``1x2``.
- Prefill and greedy decode of granite-20b (its cache's sequence split
  over ``model``) under ``serve_rules`` with ``act_seq: ("model",)``:
  logits and tokens bit-equal to the same ranks' without it (the
  reference constrains no prefill stream; decode's one position never
  splits).
- The differentiable reduce-scatter's gradient is the all-gather of the
  cotangents, and ``split``'s the same; `sharding.seq_split` splits
  exactly where the reference's ``spec_for`` shards ``act_seq``.
"""

import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_rank_programs as progs  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch.mesh import make_mesh as ref_make_mesh  # noqa: E402
from repro.launch.train import reduce_config as ref_reduce_config  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.comm import DryComm, run_ranks  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

TIMEOUT_S = 450
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}
# (arch, mesh, rules): "split" is train_rules(False), "whole" leaves the
# blocks' leaves whole on the model axis.
RULES = {"split": {}, "whole": {"heads": None, "kv_heads": None, "mlp": None}}
CASES = [("granite-20b", "1x2", "split"), ("rwkv6-7b", "1x2", "split"),
         ("musicgen-medium", "1x2", "split"), ("recurrentgemma-2b", "1x2", "split"),
         ("dbrx-132b", "1x2", "split"), ("llama-3.2-vision-11b", "1x2", "split"),
         ("qwen3-0.6b", "2x2", "split"),
         ("qwen3-0.6b", "1x2", "whole"), ("rwkv6-7b", "1x2", "whole")]
INDIVISIBLE = ("qwen3-0.6b", "1x2", "odd")  # batches (4, 15), train_rules(False)
SERVE_ARCH, PROMPT, GEN = "granite-20b", (2, 12), 3
TRAIN_REDUCE = 16
TRAIN_BATCH = (4, 16)
TRAIN_STEPS = 3
LR, EPS = 3e-3, 1.0  # eps 1: see tests/test_torch_tensor_parallel.py
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_TOL = 1e-4  # of each leaf's largest magnitude
KW = dict(reduce=TRAIN_REDUCE)


def _draw(lm, seed):
    """numpy parameters for ``lm``'s specs, zero-initialised leaves drawn
    small so that every path counts."""
    rng = np.random.default_rng(seed)

    def draw(p):
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init in ("zeros", "ones") else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    return layers.tree_map(draw, lm.param_specs())


def _inputs(arch, i, seq_len):
    cfg = progs.lm_of(arch, **KW).cfg
    rng = np.random.default_rng(300 + i)
    shape = (TRAIN_BATCH[0], seq_len)
    batches = []
    for _ in range(TRAIN_STEPS):
        tokens = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        if cfg.embed_inputs:
            b = {"embeds": rng.normal(0, 1, shape + (cfg.d_model,)).astype(np.float32),
                 "targets": tokens}
        else:
            b = {"tokens": tokens}
        if cfg.n_image_tokens:
            b["images"] = rng.normal(0, 1, (shape[0], cfg.n_image_tokens,
                                            cfg.d_model)).astype(np.float32)
        batches.append(b)
    return {"params": _draw(progs.lm_of(arch, **KW), 30 + i), "batches": batches}


def _serve_inputs():
    lm = progs.lm_of(SERVE_ARCH, reduce=8)
    tokens = np.random.default_rng(9).integers(0, lm.cfg.vocab_size, PROMPT)
    return {"params": _draw(lm, 9), "batch": {"tokens": tokens}}


def _collective_inputs():
    rng = np.random.default_rng(7)
    return dict(x=rng.normal(0, 1, (2, 3, 4, 5)).astype(np.float32),
                cot=rng.normal(0, 1, (2, 3, 2, 5)).astype(np.float32))


def _reference_train(arch, inp):
    rlm = RefLM(ref_reduce_config(ref_configs.get_config(arch), TRAIN_REDUCE))
    opt = RefAdamW(RefAdamWConfig(lr=LR, eps=EPS), ref_cosine(LR, warmup_steps=1,
                                                              total_steps=TRAIN_STEPS))
    step, _, _ = ref_steps.build_train_step(rlm, opt, ref_make_mesh((1, 1), ("data", "model")),
                                            remat=True, multi_pod=False)
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, inp["params"]))
    losses, norms = [], []
    for b in inp["batches"]:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "params": jax.tree_util.tree_map(np.asarray, state.params)}


def _spawn(mesh_name, jobs):
    return run_ranks(progs.run_jobs, make_mesh(*MESHES[mesh_name]), jobs, backend="gloo",
                     device="cpu", timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def runs():
    """{"inputs", "ref": {case: reference}, mesh: [each rank's results]}:
    each case's steps with (``seq``) and without (``tp``) ``act_seq``."""
    inputs = {case: _inputs(case[0], i, TRAIN_BATCH[1]) for i, case in enumerate(CASES)}
    inputs[INDIVISIBLE] = _inputs(INDIVISIBLE[0], len(CASES), TRAIN_BATCH[1] - 1)
    jobs = {m: [] for m in MESHES}
    for case, inp in inputs.items():
        arch, mesh, _ = case
        for act_seq in (True, False):
            if case == INDIVISIBLE and not act_seq:
                continue
            rules = {**RULES.get(case[2], {}), "act_seq": ("model",) if act_seq else None}
            jobs[mesh].append(("-".join(case) + ("-seq" if act_seq else "-tp"), dict(
                program="tp_train", arch_kw=dict(arch=arch, **KW), params=inp["params"],
                batches=inp["batches"], lr=LR, eps=EPS, replicated_grads=mesh == "1x2",
                rules=rules)))
    jobs["1x2"].append(("collectives", dict(program="seq_collectives",
                                            **_collective_inputs())))
    serve = _serve_inputs()
    for act_seq in (True, False):
        rules = {**shd.serve_rules(False), "act_seq": ("model",) if act_seq else None}
        jobs["1x2"].append((f"serve-{act_seq}", dict(
            program="tp_serve", arch_kw=dict(arch=SERVE_ARCH, reduce=8), gen=GEN,
            rules=rules, **serve)))
    with ThreadPoolExecutor(max_workers=2) as pool:
        spawned = {m: pool.submit(_spawn, m, jobs[m]) for m in MESHES}
        ref = {case: _reference_train(case[0], inp) for case, inp in inputs.items()}
        out = {m: [r["result"] for r in f.result()] for m, f in spawned.items()}
    out.update(ref=ref, inputs=inputs)
    return out


def _results(runs, case, kind):
    return [r["-".join(case) + "-" + kind] for r in runs[case[1]]]


def _assert_steps_equal(got, want):
    for r in got:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norms"], want["grad_norms"], rtol=NORM_RTOL)
    for a, b in zip(leaves(got[0]["params"]), leaves(want["params"]), strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert float(np.abs(a - b).max()) <= PARAM_TOL * float(np.abs(b).max()) + 1e-7


# ----------------------------------------------------------------- steps


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_act_seq_train_steps_equal_reference(runs, case):
    ref = runs["ref"][case]
    _assert_steps_equal(_results(runs, case, "seq"),
                        dict(ref, params=layers.tree_map(torch.from_numpy, ref["params"])))


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_act_seq_train_steps_equal_the_ranks_without_it(runs, case):
    tp = _results(runs, case, "tp")
    _assert_steps_equal(_results(runs, case, "seq"), tp[0])


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_stream_is_a_piece_of_the_sequence_and_remat_saves_half(runs, case):
    arch, mesh, _ = case
    lm = progs.lm_of(arch, **KW)
    b_local = TRAIN_BATCH[0] // MESHES[mesh][0][0]
    piece = (b_local, TRAIN_BATCH[1] // 2, lm.cfg.d_model)
    for seq, tp in zip(_results(runs, case, "seq"), _results(runs, case, "tp")):
        # Forward and remat's recompute: one input per superblock each.
        assert seq["stream"]["shapes"] == [piece] * (2 * lm.cfg.n_superblocks)
        assert tp["stream"]["shapes"] == [piece[:1] + (TRAIN_BATCH[1],) + piece[2:]] * (
            2 * lm.cfg.n_superblocks)
        assert len(seq["stream"]["saved"]) == lm.cfg.n_superblocks
        assert all(s > 0 for s in seq["stream"]["saved"])
        assert [2 * s for s in seq["stream"]["saved"]] == tp["stream"]["saved"]


def test_indivisible_sequence_stays_whole_and_equals_reference(runs):
    case = INDIVISIBLE
    got = _results(runs, case, "seq")
    lm = progs.lm_of(case[0], **KW)
    whole = (TRAIN_BATCH[0], TRAIN_BATCH[1] - 1, lm.cfg.d_model)
    for r in got:
        assert r["stream"]["shapes"] == [whole] * (2 * lm.cfg.n_superblocks)
    ref = runs["ref"][case]
    _assert_steps_equal(got, dict(ref, params=layers.tree_map(torch.from_numpy, ref["params"])))


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == "1x2"], ids="-".join)
def test_replicated_leaves_bit_equal_on_both_model_ranks(runs, case):
    """The leaves that ``model`` does not split: the first batch's
    gradients as the step syncs them (the stream's norms summed over
    ``model``), and their values after the steps."""
    a, b = _results(runs, case, "seq")
    assert (a["model_index"], b["model_index"]) == (0, 1)
    n = 0
    for key in ("replicated_grads", "replicated_params"):
        for x, y in zip(leaves(a[key]), leaves(b[key])):
            if x is not None:
                assert torch.equal(x, y)
                n += 1
    assert n > 0


def test_prefill_and_decode_are_unchanged_by_act_seq(runs):
    for r in runs["1x2"]:
        seq, whole = r["serve-True"], r["serve-False"]
        assert torch.equal(seq["tokens"], whole["tokens"])
        assert torch.equal(seq["logits"], whole["logits"])
        assert seq["cache_shapes"] == whole["cache_shapes"]


# ----------------------------------------------------------------- pieces


def test_reduce_scatter_and_split_gradients_are_all_gathers(runs):
    inp = _collective_inputs()
    x, cot = torch.from_numpy(inp["x"]), torch.from_numpy(inp["cot"])
    gathered = torch.cat([cot[0], cot[1]], dim=1)  # the cotangents along dim 1
    total = x[0] + x[1]
    for rank, r in enumerate(runs["1x2"]):
        got = r["collectives"]
        torch.testing.assert_close(got["reduce_scatter"]["y"], total[:, 2 * rank:2 * rank + 2],
                                   rtol=0, atol=0)
        assert torch.equal(got["reduce_scatter"]["grad"], gathered)
        assert torch.equal(got["split"]["y"], x[rank][:, 2 * rank:2 * rank + 2])
        assert torch.equal(got["split"]["grad"], gathered)


@pytest.mark.parametrize("shape,axes,rules_seq", [
    ((1, 2), ("data", "model"), ("model",)), ((2, 2), ("data", "model"), ("model",)),
    ((2, 1), ("data", "model"), ("model",)), ((1, 4), ("data", "model"), ("model",)),
    ((1, 2), ("data", "model"), None)])
def test_seq_split_is_the_reference_spec(shape, axes, rules_seq):
    mesh = make_mesh(shape, axes)
    duck = types.SimpleNamespace(shape=dict(zip(axes, shape)))
    assert shd.seq_split(16) == 1  # no context
    rules = {**shd.train_rules(False), "act_seq": rules_seq}
    ref_rules = {**ref_shd.train_rules(False), "act_seq": rules_seq}
    with shd.activation_ctx(DryComm(mesh), rules):
        for S in (1, 2, 6, 15, 16, 4096):
            spec = ref_shd.spec_for(("batch", "act_seq", "act_embed"), (8, S, 64), duck,
                                    ref_rules)
            entry = spec[1] if len(spec) > 1 else None
            want = shape[1] if entry == "model" and shape[1] > 1 else 1
            assert shd.seq_split(S) == want, S

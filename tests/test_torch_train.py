"""repro_torch's training substrate against the reference on the CPU: the
cosine schedule, AdamW, the synthetic data, checkpoints (written by either
package, restored by the other), the train step and ``launch.train``.

Inputs come from numpy seeds and go to both packages as arrays; the LM is
qwen3-0.6b cut to a tiny size (2 layers, d_model 64, 4 query heads over 2
KV heads, vocab 512). Tolerances: the schedule within 1 ulp (plus one
ulp of cos, whose float32 code differs between XLA and PyTorch); AdamW's
params, mu and nu within rtol 1e-6 / atol 1e-7 (the same float32 order of
operations; XLA may contract a multiply-add); the data equal; train-step
losses within rtol 1e-4 (three steps of products summed in another order);
grad_accum 2 against 1 within rtol 1e-5.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.checkpoint.manager import _flatten_with_paths as ref_flatten  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten_with_paths  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData, pack_documents  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import LM, layers  # noqa: E402
from repro_torch.optim import AdamW, AdamWConfig, TrainState, cosine_schedule  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train import build_train_step  # noqa: E402

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=512)


def _np(tree):
    return layers.tree_map(lambda t: t.detach().numpy(), tree)


def _draw(specs, seed):
    """numpy parameters from specs: normal at the specs' scale, the
    zero-initialised ones at 0.1 (so their paths are exercised)."""
    rng = np.random.default_rng(seed)

    def draw(p):
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init in ("zeros", "ones") else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    return layers.tree_map(draw, specs)


@pytest.fixture(scope="module")
def tiny():
    """(reference LM, port LM, numpy parameters)."""
    rlm = RefLM(dataclasses.replace(ref_configs.get_config("qwen3-0.6b"), **TINY))
    lm = LM(dataclasses.replace(configs.get_config("qwen3-0.6b"), **TINY))
    return rlm, lm, _draw(lm.param_specs(), 0)


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1), (3, 17, 0.0), (0, 5, 0.5)])
def test_cosine_schedule_matches_reference(warmup, total, min_ratio):
    steps = np.arange(total + 3, dtype=np.int32)
    want = np.asarray(ref_cosine(3e-3, warmup, total, min_ratio)(jnp.asarray(steps)))
    got = cosine_schedule(3e-3, warmup, total, min_ratio)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    # Within 1 ulp, plus what one ulp of cos moves the result: cos is the
    # one function that runs other float32 code in XLA and in PyTorch (they
    # differ by an ulp at some inputs), which can move the value before
    # base_lr's product by its scaled ulp plus one rounding step.
    base = np.float32(want / 3e-3)
    tol = np.spacing(want) + 3e-3 * (np.spacing(base) + (1 - min_ratio) * 0.5 * 2.0**-23)
    diff = np.abs(got.numpy().astype(np.float64) - want)
    assert (diff <= tol).all(), diff.max()
    warm = steps < warmup  # no cos in the selected branch: 1 ulp
    np.testing.assert_array_max_ulp(got.numpy()[warm], want[warm], maxulp=1)


# ---------------------------------------------------------------- AdamW


def _adam_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "stack": {"v": rng.normal(0, 1, (2, 3, 4)).astype(np.float32),
                      "b": rng.normal(0, 1, (7,)).astype(np.float32)}}


@pytest.mark.parametrize("clip", [1.0, None, 1e3])
def test_adamw_apply_matches_reference(clip):
    """Two applies (step 1 and 2) with the cosine schedule: clip active
    (1.0 against a gradient norm of ~20), off, and inactive (1e3)."""
    params, g1, g2 = _adam_tree(0), _adam_tree(1), _adam_tree(2)
    g1 = {**g1, "w": 4 * g1["w"]}
    sched = dict(base_lr=0.05, warmup_steps=1, total_steps=4)
    ref = RefAdamW(RefAdamWConfig(grad_clip_norm=clip), ref_cosine(**sched))
    ours = AdamW(AdamWConfig(grad_clip_norm=clip), cosine_schedule(**sched))
    rs = ref.init(jax.tree_util.tree_map(jnp.asarray, params))
    os_ = ours.init(layers.tree_map(torch.from_numpy, params))
    for g in (g1, g2):
        np.testing.assert_allclose(
            float(ours.global_norm(layers.tree_map(torch.from_numpy, g))),
            float(ref.global_norm(jax.tree_util.tree_map(jnp.asarray, g))), rtol=1e-6)
        rs = ref.apply(rs, jax.tree_util.tree_map(jnp.asarray, g))
        os_ = ours.apply(os_, layers.tree_map(torch.from_numpy, g))
        for field in ("params", "mu", "nu"):
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7),
                _np(getattr(os_, field)), getattr(rs, field))
    assert os_.step.dtype == torch.int32 and int(os_.step) == int(rs.step) == 2


def test_adamw_init_and_decay_rule():
    ours = AdamW(AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip_norm=None))
    params = {"w": torch.ones((2, 2)), "b": torch.ones(3)}
    state = ours.init(params)
    assert state.mu["w"].dtype == torch.float32 and float(state.nu["b"].abs().sum()) == 0
    zero = {"w": torch.zeros((2, 2)), "b": torch.zeros(3)}
    state = ours.apply(state, zero)
    assert torch.equal(state.params["b"], torch.ones(3))  # 1-D: no decay
    assert torch.allclose(state.params["w"], torch.full((2, 2), 0.95))


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("mode", ["markov", "uniform"])
def test_synthetic_data_matches_reference(mode):
    kw = dict(vocab_size=100, seq_len=33, global_batch=6, seed=5, mode=mode)
    ref = ref_pipeline.SyntheticLMData(ref_pipeline.DataConfig(**kw))
    ours = SyntheticLMData(DataConfig(**kw))
    for step, host, n in ((0, 0, 1), (7, 0, 1), (7, 1, 2), (123, 2, 3)):
        want, got = ref.batch(step, host, n)["tokens"], ours.batch(step, host, n)["tokens"]
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ours.batch(0, 0, 4)


def test_pack_documents_matches_reference():
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, 50, size=n) for n in (5, 3, 10, 0, 17)]
    for seq_len, pad in ((8, None), (7, -1), (40, 0)):
        np.testing.assert_array_equal(pack_documents(docs, seq_len, 99, pad),
                                      ref_pipeline.pack_documents(docs, seq_len, 99, pad))


# ---------------------------------------------------------------- checkpoint


def _states(tiny):
    """The same TrainState in both packages (moments drawn non-zero)."""
    rlm, lm, tree = tiny
    mu, nu = _draw(lm.param_specs(), 1), _draw(lm.param_specs(), 2)
    ref = RefAdamW(RefAdamWConfig()).init(jax.tree_util.tree_map(jnp.asarray, tree))
    ref = type(ref)(params=ref.params, mu=jax.tree_util.tree_map(jnp.asarray, mu),
                    nu=jax.tree_util.tree_map(jnp.asarray, nu), step=jnp.asarray(3, jnp.int32))
    return ref, convert.train_state_from_reference(ref, lm)


def _equal_leaves(port_state, ref_state):
    got = [(n, t.numpy()) for n, t in _flatten_with_paths(port_state)]
    want = [(n, np.asarray(x)) for n, x in ref_flatten(ref_state)[0]]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_train_state_from_reference_and_leaf_names(tiny):
    ref, ours = _states(tiny)
    assert isinstance(ours, TrainState) and ours.step.dtype == torch.int32
    names = [n for n, _ in _flatten_with_paths(ours)]
    assert names == [n for n, _ in ref_flatten(ref)[0]]
    assert names[0] == "0/blocks/pos0_dense/attn/k_norm" and names[-1] == "3"
    _equal_leaves(ours, ref)


def test_checkpoint_written_by_reference_restores_in_port(tiny, tmp_path):
    ref, ours = _states(tiny)
    RefManager(str(tmp_path)).save(3, ref, blocking=True)
    specs = tiny[1].param_specs()
    got = CheckpointManager(str(tmp_path)).restore(TrainState(specs, specs, specs, 0))
    _equal_leaves(got, ref)
    assert int(got.step) == 3


def test_checkpoint_written_by_port_restores_in_reference(tiny, tmp_path):
    ref, ours = _states(tiny)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, ours)  # async
    mgr.wait()
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["step"] == 3 and manifest["leaves"][-1]["dtype"] == "int32"
    template = jax.eval_shape(lambda: ref)
    _equal_leaves(ours, RefManager(str(tmp_path)).restore(template))


MOE_TINY = dict(TINY, n_experts=4, experts_per_token=2)


@pytest.fixture(scope="module", params=["dbrx-132b", "llama4-scout-17b-a16e"])
def tiny_moe(request):
    """(reference LM, port LM, numpy parameters) of a tiny MoE config:
    router and experts, and for llama4-scout the shared expert too."""
    arch = request.param
    rlm = RefLM(dataclasses.replace(ref_configs.get_config(arch), **MOE_TINY))
    lm = LM(dataclasses.replace(configs.get_config(arch), **MOE_TINY))
    return rlm, lm, _draw(lm.param_specs(), 0)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_moe_checkpoint_crosses_packages(tiny_moe, tmp_path, writer):
    ref, ours = _states(tiny_moe)
    names = [n for n, _ in _flatten_with_paths(ours)]
    assert names == [n for n, _ in ref_flatten(ref)[0]]
    assert "0/blocks/pos0_moe/moe/router" in names and "0/blocks/pos0_moe/moe/we2" in names
    assert ("0/blocks/pos0_moe/moe/shared/w1" in names) == tiny_moe[1].cfg.shared_expert
    if writer == "reference":
        RefManager(str(tmp_path)).save(3, ref, blocking=True)
        specs = tiny_moe[1].param_specs()
        _equal_leaves(CheckpointManager(str(tmp_path)).restore(TrainState(specs, specs, specs, 0)),
                      ref)
    else:
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, ours)
        mgr.wait()
        _equal_leaves(ours, RefManager(str(tmp_path)).restore(jax.eval_shape(lambda: ref)))


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 16), generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.ones(3)}}


def test_checkpoint_roundtrip_and_device(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(5, tree, blocking=True)
    out = mgr.restore(tree, device="cpu")
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["nested"]["b"],
                                                            tree["nested"]["b"])
    assert mgr.latest_step() == 5
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": 0})


def test_checkpoint_save_copies_before_in_place_updates(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = tree["a"].clone()
    mgr.save(1, tree)
    tree["a"].add_(1.0)  # training's next step, while the write may still run
    assert torch.equal(mgr.restore(tree)["a"], want)


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2, keep_every=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.steps() == [2, 4, 5]
    assert torch.equal(mgr.restore(_tree())["a"], _tree(5)["a"])


def test_checkpoint_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    d = tmp_path / "step_00000001"
    victim = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    arr = np.load(d / victim).copy()
    arr.flat[0] += 1
    np.save(d / victim, arr)
    with pytest.raises(IOError):
        mgr.restore(_tree())
    mgr.restore(_tree(), verify=False)


def test_checkpoint_tmp_dir_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_00000099.tmp")
    assert mgr.latest_step() is None  # partial writes are never visible
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tree())


# ---------------------------------------------------------------- train step


def _batches(lm, n, B=4, S=16, seed=7):
    data = SyntheticLMData(DataConfig(vocab_size=lm.cfg.vocab_size, seq_len=S,
                                      global_batch=B, seed=seed))
    return [data.batch(i) for i in range(n)]


def test_train_steps_match_reference(tiny):
    rlm, lm, tree = tiny
    sched = dict(base_lr=3e-3, warmup_steps=1, total_steps=3)
    ref_opt = RefAdamW(RefAdamWConfig(lr=3e-3), ref_cosine(**sched))
    ref_step, _, _ = ref_steps.build_train_step(rlm, ref_opt, make_mesh((1, 1), ("data", "model")),
                                                remat=True, multi_pod=False)
    opt = AdamW(AdamWConfig(lr=3e-3), cosine_schedule(**sched))
    step = build_train_step(lm, opt, remat=True)
    rs = ref_opt.init(jax.tree_util.tree_map(jnp.asarray, tree))
    state = opt.init(layers.tree_map(lambda a: torch.from_numpy(a.copy()), tree))
    for batch in _batches(lm, 3):
        rs, rm = ref_step(rs, {"tokens": jnp.asarray(batch["tokens"])})
        state, m = step(state, {"tokens": torch.from_numpy(batch["tokens"])})
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-3)
        assert int(m["step"]) == int(rm["step"])


def test_grad_accum_matches_single_batch(tiny):
    """Loss, grad norm and updated parameters; eps = 1 keeps Adam's first
    update a smooth function of the gradient (near eps = 1e-8 it is
    sign(g), which turns rounding noise on a tiny gradient into a full step)."""
    _, lm, tree = tiny
    batch = {"tokens": torch.from_numpy(_batches(lm, 1, B=4)[0]["tokens"])}
    out = {}
    for accum in (1, 2):
        opt = AdamW(AdamWConfig(lr=1e-2, eps=1.0))
        state = opt.init(layers.tree_map(lambda a: torch.from_numpy(a.copy()), tree))
        out[accum] = build_train_step(lm, opt, remat=False, grad_accum=accum)(state, batch)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(out[2][1][key]), float(out[1][1][key]), rtol=1e-5)
    for a, b in zip(leaves(out[2][0].params), leaves(out[1][0].params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------- launch.train


def test_train_main_on_cpu_resumes(tmp_path, capsys):
    """4 steps with a checkpoint at 2; then, from that checkpoint alone,
    steps 2 and 3 again: the same losses (the CPU is deterministic)."""
    argv = ["--device", "cpu", "--reduce", "8", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1"]
    record = {}
    losses = train.main(argv + ["--ckpt-dir", str(tmp_path / "a")], record=record)
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert [r["step"] for r in record["steps"]] == [0, 1, 2, 3] and record["n_params"] > 0
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000002", "step_00000004"]
    os.makedirs(tmp_path / "b")
    os.rename(tmp_path / "a" / "step_00000002", tmp_path / "b" / "step_00000002")
    resumed = train.main(argv + ["--ckpt-dir", str(tmp_path / "b"), "--resume"])
    np.testing.assert_allclose(resumed, losses[2:], rtol=1e-6)
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out and "[train] done:" in out


def test_train_main_refuses_meshes_and_absent_card():
    # --mesh 1x2 trains (tensor parallelism) where the transport is named
    # gloo on the CPU; the default nccl moves CUDA tensors only.
    with pytest.raises(ValueError, match="gloo"):
        train.main(["--device", "cpu", "--mesh", "1x2"])
    tp = train.main(["--device", "cpu", "--mesh", "1x2", "--dist-backend", "gloo", "--steps",
                     "1", "--batch", "2", "--seq", "16"])
    np.testing.assert_allclose(tp, train.main(["--device", "cpu", "--steps", "1", "--batch",
                                               "2", "--seq", "16"]), rtol=1e-5)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-CUDA error cannot be shown")
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduce", "8", "--steps", "1"])

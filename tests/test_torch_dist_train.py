"""repro_torch's training and serving across ranks against the reference
on the CPU: two spawned `gloo` ranks (one spawn for the file; ranks import
no jax).

- The FSDP-sharded train step (`build_train_step` with a ``comm``, a 2x1
  mesh) against the reference's `build_train_step` on a 1x1 mesh, from the
  same parameters on the same global batches: 3 steps, losses within rtol
  1e-5 and grad norms within 1e-4, a batch whose ``mask`` leaves the two
  shards different counts included; ``grad_accum=2``; a tiny dbrx whose
  batch of 2 x 45 tokens makes 45 MoE groups, which straddle the ranks
  (all-gathered tokens, gradients back through the gather). Each rank's
  stored shards have the shapes the reference's ``spec_for`` gives.
- The 2-stage GPipe loss (``tests/test_pipeline.py``'s config) within 1e-5
  relative of the reference's serial ``lm.loss``, and its gradients (the
  replicated leaves summed over the stages) against ``jax.grad`` of that
  loss and against the port's serial autograd, within 1e-5 of each leaf's
  largest magnitude.
- ``--mesh 2x1`` serving (`serve_batch` with a ``comm``): greedy tokens
  equal to the reference's `serve_batch` for qwen3-0.6b and dbrx-132b at
  ``reduce_config(…, 8)``, at 4 x 16 prompts (64 MoE groups: each rank
  dispatches its own) and 2 x 45 (45 groups: they straddle the ranks), and
  logits within 1e-5 of the port's own single-process serve.
"""

import dataclasses
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
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch.mesh import make_mesh as ref_make_mesh  # noqa: E402
from repro.launch.train import reduce_config as ref_reduce_config  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.distributed import comm as dist_comm  # noqa: E402
from repro_torch.distributed.comm import run_ranks  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

TIMEOUT_S = 180
TINY = dict(arch="qwen3-0.6b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512)
TINY_MOE = dict(arch="dbrx-132b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                d_ff=96, vocab_size=512, n_experts=4, experts_per_token=2)
PP = dict(TINY, n_layers=4)  # tests/test_pipeline.py's config
LR = 3e-3
SERVE_ARCHS = ("qwen3-0.6b", "dbrx-132b")
SERVE_PROMPTS = ((4, 16), (2, 45))  # 64 MoE groups (even); 45 (odd: straddling)
SERVE_GEN = 4
# job: (config, batches, grad_accum)
JOBS = {"fsdp": (TINY, "batches", 1), "fsdp_accum": (TINY, "batches", 2),
        "fsdp_moe": (TINY_MOE, "moe_batches", 1)}


def _ref_lm(kw, reduce=None):
    cfg = ref_configs.get_config(kw["arch"])
    if reduce:
        cfg = ref_reduce_config(cfg, reduce)
    return RefLM(dataclasses.replace(cfg, **{k: v for k, v in kw.items() if k != "arch"}))


def _draw(lm, seed):
    rng = np.random.default_rng(seed)

    def draw(p):
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init in ("zeros", "ones") else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    return layers.tree_map(draw, lm.param_specs())


def _batches(vocab, n, B, S, seed, mask=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32)}
        if mask:
            # Shard 0 (rows :B/2) keeps far fewer positions than shard 1.
            m = np.ones((B, S), np.int32)
            m[: B // 2, 3:] = 0
            m[B // 2:, -2:] = 0
            b["mask"] = m
        out.append(b)
    return out


@pytest.fixture(scope="module")
def runs():
    lm_tiny = progs.lm_of(**TINY)
    lm_moe = progs.lm_of(**TINY_MOE)
    lm_pp = progs.lm_of(**PP)
    out = {
        "tiny": _draw(lm_tiny, 0), "moe": _draw(lm_moe, 1), "pp": _draw(lm_pp, 2),
        "batches": _batches(512, 3, 4, 16, 7, mask=True),
        "moe_batches": _batches(512, 3, 2, 45, 8),
        "pp_tokens": np.random.default_rng(0).integers(0, 512, (4, 32)).astype(np.int32),
        "serve": {}, "prompts": {},
    }
    jobs = [
        ("fsdp", dict(program="fsdp_steps", arch_kw=TINY, params=out["tiny"],
                      batches=out["batches"], lr=LR)),
        ("fsdp_accum", dict(program="fsdp_steps", arch_kw=TINY, params=out["tiny"],
                            batches=out["batches"][:1], lr=LR, grad_accum=2)),
        ("fsdp_moe", dict(program="fsdp_steps", arch_kw=TINY_MOE, params=out["moe"],
                          batches=out["moe_batches"], lr=LR)),
        ("pp", dict(program="pp_grads", arch_kw=PP, params=out["pp"], tokens=out["pp_tokens"],
                    n_microbatches=2, mesh=((2,), ("pod",)))),
        ("collectives", dict(program="collectives")),
    ]
    for arch in SERVE_ARCHS:
        kw = dict(arch=arch, reduce=8)
        params = _draw(progs.lm_of(**kw), 3)
        prompts = [np.random.default_rng(i).integers(0, 4096, shape)
                   for i, shape in enumerate(SERVE_PROMPTS)]
        out["serve"][arch], out["prompts"][arch] = params, prompts
        jobs.append((f"serve_{arch}", dict(program="serve", arch_kw=kw, params=params,
                                           prompts=prompts, gen=SERVE_GEN)))
    # The ranks run while this process computes the reference's results.
    with ThreadPoolExecutor(max_workers=1) as pool:
        ranks = pool.submit(run_ranks, progs.run_jobs, make_mesh((2, 1), ("data", "model")),
                            jobs, backend="gloo", device="cpu", timeout_s=TIMEOUT_S)
        out["ref"] = _reference(out)
        out["ranks"] = [r["result"] for r in ranks.result()]
    return out


def _reference(runs):
    """The reference's train runs (per job), serial GPipe loss and served
    tokens, and the port's single-process serve logits."""
    ref = {}
    for job, (kw, key, accum) in JOBS.items():
        batches = runs[key][:1] if accum > 1 else runs[key]
        ref[job] = _ref_train(kw, runs["moe" if kw is TINY_MOE else "tiny"], batches, accum)
    rlm = _ref_lm(PP)
    loss, grads = jax.jit(jax.value_and_grad(rlm.loss))(
        jax.tree_util.tree_map(jnp.asarray, runs["pp"]), {"tokens": jnp.asarray(runs["pp_tokens"])})
    ref["pp_loss"] = float(loss)
    ref["pp_grads"] = jax.tree_util.tree_map(np.asarray, grads)
    for arch in SERVE_ARCHS:
        rlm = RefLM(ref_reduce_config(ref_configs.get_config(arch), 8))
        lm = progs.lm_of(arch=arch, reduce=8)
        params = runs["serve"][arch]
        for i, prompts in enumerate(runs["prompts"][arch]):
            ref[f"serve_{arch}_{i}"] = (
                ref_serve.serve_batch(rlm, jax.tree_util.tree_map(jnp.asarray, params), prompts,
                                      SERVE_GEN, ref_make_mesh((1, 1), ("data", "model"))),
                serve.serve_batch(lm, progs.tensors(params, "cpu"), prompts, SERVE_GEN,
                                  return_logits=True)[1])
    return ref


def _ref_train(kw, params, batches, grad_accum=1):
    rlm = _ref_lm(kw)
    opt = RefAdamW(RefAdamWConfig(lr=LR), ref_cosine(LR, warmup_steps=1,
                                                     total_steps=len(batches)))
    step, _, _ = ref_steps.build_train_step(rlm, opt, ref_make_mesh((1, 1), ("data", "model")),
                                            remat=True, grad_accum=grad_accum, multi_pod=False)
    state = opt.init(jax.tree_util.tree_map(jnp.asarray, params))
    losses, norms = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, state


@pytest.mark.parametrize("job", list(JOBS))
def test_fsdp_steps_match_reference_one_device(runs, job):
    want, norms, _ = runs["ref"][job]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[job]["losses"], want, rtol=1e-5)
        np.testing.assert_allclose(r[job]["grad_norms"], norms, rtol=1e-4)


def test_fsdp_mask_counts_differ_between_shards(runs):
    m = runs["batches"][0]["mask"]
    assert m[:2, :-1].sum() != m[2:, :-1].sum()


def test_fsdp_shards_have_reference_spec_shapes(runs):
    """Each rank stores its slice of every leaf as the reference's
    ``spec_for`` under ``train_rules`` splits it over a 2x1 mesh."""
    duck = types.SimpleNamespace(shape={"data": 2, "model": 1})
    rules = ref_shd.train_rules(False)
    rlm = _ref_lm(TINY)
    axes = rlm.logical_axes()
    shapes = jax.tree_util.tree_map(lambda a: a.shape, runs["tiny"])

    def local(ax, shape):
        spec = ref_shd.spec_for(tuple(ax), tuple(shape), duck, rules)
        return tuple(d // (2 if (i < len(spec) and spec[i] == "data") else 1)
                     for i, d in enumerate(shape))

    want = jax.tree_util.tree_map(local, axes, shapes, is_leaf=lambda x: isinstance(x, tuple))
    n_split = 0
    for r in runs["ranks"]:
        got = r["fsdp"]["shard_shapes"]
        assert jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(x, tuple)) == \
            jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple))
    for a, b in zip(jax.tree_util.tree_leaves(want, is_leaf=lambda x: isinstance(x, tuple)),
                    jax.tree_util.tree_leaves(shapes, is_leaf=lambda x: isinstance(x, tuple))):
        n_split += a != b
    assert n_split > 0  # FSDP really splits leaves


def test_fsdp_params_after_steps_match_reference(runs):
    """The gathered params after 3 steps against the reference's (AdamW's
    first steps are near lr * sign(g); rounding-level gradient differences
    on near-zero entries are bounded by 2 * lr per step)."""
    _, _, state = runs["ref"]["fsdp"]
    for a, b in zip(leaves(runs["ranks"][0]["fsdp"]["params"]),
                    jax.tree_util.tree_leaves(state.params)):
        b = np.asarray(b)
        close = np.isclose(a.numpy(), b, rtol=1e-4, atol=1e-6)
        assert close.mean() > 0.999
        assert np.abs(a.numpy() - b).max() <= 2 * LR * 3 + 1e-6


def test_pp_loss_matches_reference_serial(runs):
    want = runs["ref"]["pp_loss"]
    for r in runs["ranks"]:
        assert abs(r["pp"]["loss"] - want) / want < 1e-5


def test_pp_grads_match_serial_autograd(runs):
    lm = progs.lm_of(**PP)
    params = progs.tensors(runs["pp"], "cpu")
    _, serial = loss_and_grads(lm, params, {"tokens": torch.from_numpy(runs["pp_tokens"])},
                               remat=False)
    half = lm.cfg.n_superblocks // 2
    for r in runs["ranks"]:
        s = r["pp"]["stage"]
        want = {**serial, "blocks": layers.tree_map(lambda t: t[s * half:(s + 1) * half],
                                                    serial["blocks"])}
        for a, b in zip(leaves(r["pp"]["grads"]), leaves(want)):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-9


def test_pp_grads_match_reference_grad(runs):
    """Each stage's block slice, and the replicated leaves summed over the
    stages (``ring_permute``'s backward), against ``jax.grad`` of the
    reference's serial ``lm.loss`` on the same parameters and tokens."""
    want_all = runs["ref"]["pp_grads"]
    half = progs.lm_of(**PP).cfg.n_superblocks // 2
    for r in runs["ranks"]:
        s = r["pp"]["stage"]
        want = {**want_all, "blocks": jax.tree_util.tree_map(
            lambda a: a[s * half:(s + 1) * half], want_all["blocks"])}
        got = list(leaves(r["pp"]["grads"]))
        assert len(got) == len(jax.tree_util.tree_leaves(want))
        for a, b in zip(got, jax.tree_util.tree_leaves(want)):
            assert a.shape == b.shape
            assert float(np.abs(a.numpy() - b).max()) <= 1e-5 * float(np.abs(b).max()) + 1e-9


@pytest.mark.parametrize("shape_i", range(len(SERVE_PROMPTS)))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_mesh_serve_tokens_equal_reference(runs, arch, shape_i):
    want, one_logits = runs["ref"][f"serve_{arch}_{shape_i}"]
    for r in runs["ranks"]:
        got = r[f"serve_{arch}"][shape_i]
        np.testing.assert_array_equal(got["tokens"], want)
        np.testing.assert_allclose(got["logits"], one_logits, rtol=1e-5, atol=1e-5)


def test_moe_groups_straddle_only_where_the_reference_leaves_shard_map():
    """The two prompt shapes: 64 groups (each rank dispatches 32 of its
    own), 45 (odd: the reference's global path)."""
    from repro_torch.models.blocks import MOE_GROUPS, _largest_divisor_leq

    groups = [_largest_divisor_leq(b * s, MOE_GROUPS) for b, s in SERVE_PROMPTS]
    assert groups == [64, 45]
    assert _largest_divisor_leq(2 * 45, MOE_GROUPS) == 45  # the MoE train batch


def test_collectives_along_the_data_axis(runs):
    """Sum, max, gather, reduce-scatter and the ring exchange with its
    backward, on two ranks holding r + 1."""
    for r, out in enumerate(runs["ranks"]):
        c = out["collectives"]["data"]
        assert (c["sum"], c["max"], c["gather"]) == (3.0, 2.0, [0, 1])
        assert c["scatter"] == [[0.0, 3.0], [6.0, 9.0]][r]
        # rank r receives 2 * (1 - r); its cotangent (r + 10) goes back to 1 - r.
        assert c["permuted"] == 2.0 * (1 - r) and c["permute_grad"] == 2.0 * (11 - r)


def test_transport_is_named_never_chosen(monkeypatch):
    """nccl needs a card per rank and says to pass gloo; it refuses the
    CPU; an unknown backend is refused. The launchers check before they
    spawn anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="gloo"):
        dist_comm.check_transport("nccl", "cuda", 2)
    dist_comm.check_transport("nccl", "cuda", 1)
    dist_comm.check_transport("gloo", "cuda", 2)
    with pytest.raises(ValueError, match="gloo"):
        dist_comm.check_transport("nccl", "cpu", 2)
    with pytest.raises(ValueError):
        dist_comm.check_transport("mpi", "cpu", 2)
    for main in (train.main, serve.main):
        with pytest.raises(RuntimeError, match="gloo"):
            main(["--mesh", "2x1", "--dist-backend", "nccl"])
    assert dist_comm.transport_name("gloo", "cuda", 2) == "gloo, host-staged, 2 ranks on cuda:0"


def test_ranks_name_their_transport_and_default_to_the_card(monkeypatch):
    """``run_ranks`` and ``Comm`` take no default transport, and compute on
    the card unless asked for the CPU: without a card they raise."""
    from repro_torch.distributed.comm import Comm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = make_mesh((2, 1), ("data", "model"))
    with pytest.raises(TypeError, match="backend"):
        run_ranks(progs.run_jobs, mesh, [])
    with pytest.raises(TypeError, match="backend"):
        Comm(make_mesh((1, 1), ("data", "model")), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_ranks(progs.run_jobs, mesh, [], backend="gloo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Comm(make_mesh((1, 1), ("data", "model")), 0, backend="gloo")


def test_launchers_refuse_the_model_axis():
    """The launchers take ``--mesh 2x2`` (FSDP x tensor parallelism; four
    gloo ranks on the CPU): the losses of the 2x2 run equal the 1x1 run's
    and the served tokens the 1x1 serve's. A mesh whose ranks the
    transport cannot place still raises: NCCL on the CPU."""
    argv = ["--device", "cpu", "--reduce", "8"]
    tr = argv + ["--steps", "2", "--batch", "4", "--seq", "16"]
    np.testing.assert_allclose(train.main(tr + ["--mesh", "2x2", "--dist-backend", "gloo"]),
                               train.main(tr), rtol=1e-5)
    sv = argv + ["--requests", "4", "--prompt-len", "8", "--gen", "3"]
    np.testing.assert_array_equal(serve.main(sv + ["--mesh", "2x2", "--dist-backend", "gloo"]),
                                  serve.main(sv))
    for main in (train.main, serve.main):
        with pytest.raises(ValueError, match="gloo"):
            main(["--device", "cpu", "--mesh", "2x2", "--dist-backend", "nccl"])


def test_serve_steps_on_a_one_rank_mesh_equal_the_model():
    """`build_prefill_step` / `build_decode_step` on a 1x1 mesh (a rank
    with no process group) give `LM.prefill` / `LM.decode_step`'s logits
    and the serve rules' spec trees."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.comm import Comm
    from repro_torch.train.steps import build_decode_step, build_prefill_step, param_shardings

    lm = progs.lm_of(**TINY_MOE)
    params = progs.tensors(_draw(lm, 5), "cpu")
    comm = Comm(make_mesh((1, 1), ("data", "model")), 0, backend="gloo", device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (2, 12)))
    prefill, pinfo = build_prefill_step(lm, comm, s_max=16, batch_size=2)
    decode, dinfo = build_decode_step(lm, comm)
    logits, cache, lengths = prefill(params, {"tokens": tokens})
    want, wcache, wlengths = lm.prefill(params, {"tokens": tokens}, s_max=16)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    nxt = {"tokens": logits.argmax(-1)[:, None]}
    got = decode(params, nxt, cache, lengths)[0]
    torch.testing.assert_close(got, lm.decode_step(params, nxt, wcache, wlengths)[0],
                               rtol=0, atol=0)
    rules = sharding.serve_rules(False)
    assert pinfo["params"] == dinfo["params"] == param_shardings(lm, comm.mesh, rules)
    assert pinfo["cache"] == dinfo["cache"](lm.cache_spec_tree(2, 16))
    assert dinfo["batch"]({"tokens": tokens}) == {"tokens": ("data",)}
    # A 1x2 mesh's steps take its model shards: the serve rules' specs.
    two = make_mesh((1, 2), ("data", "model"))
    _, info = build_decode_step(lm, types.SimpleNamespace(mesh=two))
    assert info["params"] == param_shardings(lm, two, rules)
    assert info["params"]["blocks"]["pos0_moe"]["attn"]["wq"] == (None, None, "model")

"""repro_torch's ``model`` mesh axis (tensor parallelism) against the
reference's single-device results on the CPU, with spawned ``gloo`` ranks
(one spawn per mesh; the ranks import no jax).

- ``--mesh 1x2`` serving of all ten configs at ``reduce_config(…, 8)``
  (command-r-plus-104b at ``reduce_config(…, 16)``: at 8 its 12 heads do
  not group over 8 KV heads, and the reference's own forward fails),
  each rank holding its `spec_for` shards under ``serve_rules``: prefill
  and greedy ``decode_step``s with float32 caches against the reference's
  ``LM.prefill`` / ``decode_step`` (logits within 1e-5 relative to their
  largest magnitude, tokens equal; the VLM with its images, musicgen with
  embeddings), and ``serve_batch``'s tokens (bf16 caches) equal to the
  reference's ``serve_batch``. granite-20b and recurrentgemma-2b shard
  their caches' sequence and merge by the decode kernel's log-sum-exp;
  recurrentgemma-2b's prompt wraps its local ring.
- 3 steps of the sharded train step at ``1x2`` and ``2x2`` (FSDP over
  ``data`` x tensor parallelism over ``model``) for qwen3-0.6b,
  dbrx-132b, recurrentgemma-2b, rwkv6-7b and llama-3.2-vision-11b at
  ``reduce_config(…, 16)`` (dbrx-132b's 3 heads then split inside a head
  at model = 2, so its q/k/v are gathered at use) against
  the reference's jitted single-device step from the same parameters and
  batches: losses within rtol 1e-5, grad norms 1e-4, every parameter
  leaf within 1e-4 of its largest magnitude. AdamW's eps is 1 here: with
  1e-8 its first steps are lr * sign(g), and the sign of a gradient entry
  at rounding level (RWKV-6's zero-initialised decay LoRA) would decide
  the comparison. Leaves replicated over ``model`` get bit-equal
  gradients on the two ranks of the 1x2 mesh.
- Each rank's parameter (both rule sets) and cache shard shapes against
  the reference's ``spec_for``.
- The vocab-parallel argmax (first-index ties, across and within
  shards), cross-entropy and lookup against plain ones.
- A ``2x2`` checkpoint restored on ``1x1``, as the ``1x2`` shards, and by
  the reference's ``CheckpointManager``.
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
from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch.mesh import make_mesh as ref_make_mesh  # noqa: E402
from repro.launch.train import reduce_config as ref_reduce_config  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import cosine_schedule as ref_cosine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.comm import run_ranks  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim import TrainState  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

TIMEOUT_S = 450  # the spawns take ~100 s alone, more beside other test workers
SERVE_ARCHS = ("qwen3-0.6b", "qwen3-1.7b", "command-r-plus-104b", "dbrx-132b",
               "llama4-scout-17b-a16e", "granite-20b", "musicgen-medium",
               "llama-3.2-vision-11b", "recurrentgemma-2b", "rwkv6-7b")
TRAIN_ARCHS = ("qwen3-0.6b", "dbrx-132b", "recurrentgemma-2b", "rwkv6-7b",
               "llama-3.2-vision-11b")
SEQ_SHARDED = ("granite-20b", "recurrentgemma-2b")  # KV heads 1: the sequence splits
PROMPT = (2, 12)  # requests x prompt tokens
RING_PROMPT = 126  # recurrentgemma-2b: past its reduced window of 128 within GEN
GEN = 4
TRAIN_BATCH = (4, 16)
TRAIN_STEPS = 3
LR, EPS = 3e-3, 1.0
LOGIT_RTOL = LOSS_RTOL = 1e-5
NORM_RTOL = 1e-4
PARAM_TOL = 1e-4  # of each leaf's largest magnitude
MESHES = {"1x2": ((1, 2), ("data", "model")), "2x2": ((2, 2), ("data", "model"))}


SERVE_REDUCE, TRAIN_REDUCE = 8, 16


def _reduce(arch, train=False):
    return 16 if train or arch == "command-r-plus-104b" else SERVE_REDUCE


def _kw(arch, train=False):
    return dict(arch=arch, reduce=_reduce(arch, train))


def _ref_lm(arch, train=False):
    return RefLM(ref_reduce_config(ref_configs.get_config(arch), _reduce(arch, train)))


def _draw(lm, seed):
    """numpy parameters for ``lm``'s specs; zero-initialised leaves drawn
    small and cross gates far from 0, so that every path counts."""
    rng = np.random.default_rng(seed)

    def draw(p):
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init in ("zeros", "ones") else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    tree = layers.tree_map(draw, lm.param_specs())
    for p in list(tree["blocks"].values()) + [v for k, v in tree.items() if k.startswith("rem")]:
        if "gate" in p.get("attn", {}):
            p["attn"]["gate"] = np.full(p["attn"]["gate"].shape, 0.8, np.float32)
    return tree


def _serve_inputs(arch, i):
    cfg = progs.lm_of(**_kw(arch)).cfg
    rng = np.random.default_rng(100 + i)
    B, P = PROMPT[0], RING_PROMPT if arch == "recurrentgemma-2b" else PROMPT[1]
    out = {"params": _draw(progs.lm_of(**_kw(arch)), 10 + i), "batch": {}}
    if cfg.embed_inputs:
        out["batch"]["embeds"] = rng.normal(0, 1, (B, P, cfg.d_model)).astype(np.float32)
        out["decode_embeds"] = rng.normal(0, 1, (GEN, B, 1, cfg.d_model)).astype(np.float32)
    else:
        out["batch"]["tokens"] = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int64)
    if cfg.n_image_tokens:
        out["batch"]["images"] = rng.normal(0, 1, (B, cfg.n_image_tokens,
                                                   cfg.d_model)).astype(np.float32)
    elif not cfg.embed_inputs:  # serve_batch takes token prompts without images
        out["prompts"] = out["batch"]["tokens"]
    return out


def _train_inputs(arch, i):
    cfg = progs.lm_of(**_kw(arch, True)).cfg
    rng = np.random.default_rng(200 + i)
    batches = []
    for _ in range(TRAIN_STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, TRAIN_BATCH).astype(np.int32)}
        if cfg.n_image_tokens:
            b["images"] = rng.normal(0, 1, (TRAIN_BATCH[0], cfg.n_image_tokens,
                                            cfg.d_model)).astype(np.float32)
        batches.append(b)
    return {"params": _draw(progs.lm_of(**_kw(arch, True)), 20 + i), "batches": batches}


def _spawn(mesh_name, jobs):
    return run_ranks(progs.run_jobs, make_mesh(*MESHES[mesh_name]), jobs, backend="gloo",
                     device="cpu", timeout_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def inputs():
    return {"serve": {a: _serve_inputs(a, i) for i, a in enumerate(SERVE_ARCHS)},
            "train": {a: _train_inputs(a, i) for i, a in enumerate(TRAIN_ARCHS)}}


def _reference_serve(arch, inp):
    rlm = _ref_lm(arch)
    rp = jax.tree_util.tree_map(jnp.asarray, inp["params"])
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    s_max = next(iter(batch.values())).shape[1] + GEN
    logits, cache, lengths = rlm.prefill(rp, batch, s_max=s_max, cache_dtype=jnp.float32)
    seen, toks = [], []
    for i in range(GEN):
        seen.append(np.asarray(logits))
        tok = jnp.argmax(logits, axis=-1)
        toks.append(np.asarray(tok))
        if i == GEN - 1:
            break
        nxt = ({"embeds": jnp.asarray(inp["decode_embeds"][i])} if "decode_embeds" in inp
               else {"tokens": tok[:, None]})
        logits, cache, lengths = rlm.decode_step(rp, nxt, cache, lengths)
    out = {"logits": np.stack(seen, 1), "tokens": np.stack(toks, 1)}
    if "prompts" in inp:
        out["served"] = ref_serve.serve_batch(rlm, rp, inp["prompts"], GEN,
                                              ref_make_mesh((1, 1), ("data", "model")))
    return out


def _reference_train(arch, inp):
    rlm = _ref_lm(arch, True)
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


def _vocab_inputs():
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 1, (4, 3, 8)).astype(np.float32)
    last = logits[:, -1]
    last[0, 1] = last[0, 5] = 9.0  # tie across the shards: index 1
    last[1, 6] = 9.0  # alone in the second shard
    last[2, 2] = last[2, 3] = 9.0  # tie within the first shard: index 2
    last[3] = 1.0  # all equal: index 0
    return dict(logits=logits, targets=rng.integers(0, 8, (4, 3)),
                table=rng.normal(0, 1, (8, 5)).astype(np.float32),
                tokens=rng.integers(0, 8, (2, 7)))


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The ranks of both meshes, run while this process computes the
    reference's results; {mesh: [each rank's results]}, "ref", "ckpt"."""
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    jobs = {"1x2": [], "2x2": []}
    for arch in SERVE_ARCHS:
        inp = inputs["serve"][arch]
        jobs["1x2"].append((f"serve_{arch}", dict(
            program="tp_serve", arch_kw=_kw(arch), params=inp["params"], batch=inp["batch"],
            gen=GEN, decode_embeds=inp.get("decode_embeds"), prompts=inp.get("prompts"))))
    jobs["1x2"].append(("vocab", dict(program="vocab_parallel", **_vocab_inputs())))
    for mesh in MESHES:
        for arch in TRAIN_ARCHS:
            inp = inputs["train"][arch]
            kw = dict(program="tp_train", arch_kw=_kw(arch, True), params=inp["params"],
                      batches=inp["batches"], lr=LR, eps=EPS, replicated_grads=mesh == "1x2")
            if mesh == "2x2" and arch == "qwen3-0.6b":
                kw["ckpt"] = ckpt
            jobs[mesh].append((f"train_{arch}", kw))
    # The train steps' compiles overlap the eager serves in a thread.
    with ThreadPoolExecutor(max_workers=3) as pool:
        spawned = {m: pool.submit(_spawn, m, jobs[m]) for m in MESHES}
        trains = pool.submit(lambda: {f"train_{a}": _reference_train(a, inputs["train"][a])
                                      for a in TRAIN_ARCHS})
        ref = {f"serve_{a}": _reference_serve(a, inputs["serve"][a]) for a in SERVE_ARCHS}
        ref.update(trains.result())
        out = {m: [r["result"] for r in f.result()] for m, f in spawned.items()}
    out.update(ref=ref, ckpt=ckpt)
    return out


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * float(np.abs(want).max()))


# ----------------------------------------------------------------- serving


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_on_two_model_ranks_equals_reference(runs, arch):
    want = runs["ref"][f"serve_{arch}"]
    for r in runs["1x2"]:
        got = r[f"serve_{arch}"]
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
        _close(got["logits"], want["logits"], LOGIT_RTOL)
        if "served" in want:
            np.testing.assert_array_equal(got["served"], want["served"])


def _duck(mesh_name):
    shape, axes = MESHES[mesh_name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _local_shapes(axes_tree, shape_tree, mesh_name, rules):
    """Each leaf's shape on a rank as the reference's ``spec_for`` splits
    it (the shards are equal)."""
    duck = _duck(mesh_name)

    def local(ax, shape):
        spec = ref_shd.spec_for(tuple(ax), tuple(shape), duck, rules)
        out = []
        for i, d in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            out.append(d // int(np.prod([duck.shape[a] for a in names])))
        return tuple(out)

    return jax.tree_util.tree_map(local, axes_tree, shape_tree,
                                  is_leaf=lambda x: isinstance(x, tuple))


def _tuples(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_shards_are_the_reference_spec_shapes(runs, inputs, arch):
    """Parameters and (float32) caches: each rank's shapes as the
    reference's ``spec_for`` under ``serve_rules`` splits them (the
    cache's batch rows are the rank's own)."""
    rlm = _ref_lm(arch)
    rules = ref_shd.serve_rules(False)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, inputs["serve"][arch]["params"])
    want = _local_shapes(rlm.logical_axes(), shapes, "1x2", rules)
    n = next(iter(inputs["serve"][arch]["batch"].values())).shape[1]
    rcache = rlm.cache_spec_tree(PROMPT[0], n + GEN)
    cshapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), rcache)
    cwant = _local_shapes(ref_shd.cache_axes_tree(rcache), cshapes, "1x2", rules)
    for r in runs["1x2"]:
        got = r[f"serve_{arch}"]
        assert _tuples(got["param_shapes"]) == _tuples(want)
        assert _tuples(got["cache_shapes"]) == _tuples(cwant)
    if arch in SEQ_SHARDED:  # the K/V caches hold half the sequence
        k = next(v["k"] for v in got["cache_shapes"]["blocks"].values() if "k" in v)
        full = next(v["k"] for v in cshapes["blocks"].values() if "k" in v)
        assert k[-2] * 2 == full[-2] and k[-3] == full[-3]


def test_vocab_parallel_argmax_ties_cross_entropy_and_lookup(runs):
    inp = _vocab_inputs()
    logits = torch.from_numpy(inp["logits"])
    targets = torch.from_numpy(inp["targets"])
    want_ce = torch.logsumexp(logits, -1) - logits.gather(-1, targets[..., None])[..., 0]
    for r in runs["1x2"]:
        got = r["vocab"]
        assert got["argmax"].tolist() == [1, 6, 2, 0]
        assert got["argmax"].tolist() == np.asarray(jnp.argmax(inp["logits"][:, -1], -1)).tolist()
        torch.testing.assert_close(got["ce"], want_ce, rtol=1e-6, atol=1e-6)
        assert torch.equal(got["lookup"], torch.from_numpy(inp["table"][inp["tokens"]]))


# ----------------------------------------------------------------- training


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_equal_reference(runs, arch, mesh_name):
    want = runs["ref"][f"train_{arch}"]
    for r in runs[mesh_name]:
        got = r[f"train_{arch}"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=NORM_RTOL)
    params = runs[mesh_name][0][f"train_{arch}"]["params"]
    for a, b in zip(leaves(params), jax.tree_util.tree_leaves(want["params"])):
        assert float(np.abs(a.numpy() - b).max()) <= PARAM_TOL * float(np.abs(b).max()) + 1e-7


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_shards_and_replicated_gradients(runs, inputs, arch, mesh_name):
    """Each rank's state shards as the reference's ``spec_for`` under
    ``train_rules`` gives them; on the 1x2 mesh, the leaves that ``model``
    does not split (norms, router, RWKV-6's ``wA``, ...) have bit-equal
    gradients on the two ranks, with no sync over the axis."""
    rlm = _ref_lm(arch, True)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, inputs["train"][arch]["params"])
    want = _local_shapes(rlm.logical_axes(), shapes, mesh_name, ref_shd.train_rules(False))
    ranks = runs[mesh_name]
    for r in ranks:
        assert _tuples(r[f"train_{arch}"]["shard_shapes"]) == _tuples(want)
    if mesh_name != "1x2":
        return
    n_replicated = 0
    for a in ranks:
        for b in ranks:
            ga, gb = a[f"train_{arch}"], b[f"train_{arch}"]
            if ga["data_index"] != gb["data_index"] or ga["model_index"] >= gb["model_index"]:
                continue
            for x, y in zip(leaves(ga["replicated_grads"]), leaves(gb["replicated_grads"])):
                if x is not None:
                    assert torch.equal(x, y)
                    n_replicated += 1
    assert n_replicated > 0


def test_two_by_two_checkpoint_restores_on_one_rank_on_1x2_and_in_reference(runs, inputs):
    lm = progs.lm_of(**_kw("qwen3-0.6b", True))
    specs = lm.param_specs()
    template = TrainState(specs, specs, specs, 0)
    mgr = CheckpointManager(runs["ckpt"])
    whole = mgr.restore(template)
    assert int(whole.step) == TRAIN_STEPS
    want = runs["ref"]["train_qwen3-0.6b"]["params"]
    for a, b in zip(leaves(whole.params), jax.tree_util.tree_leaves(want)):
        assert float(np.abs(a.numpy() - b).max()) <= PARAM_TOL * float(np.abs(b).max()) + 1e-7
    for a, b in zip(leaves(whole.params), leaves(runs["2x2"][0]["train_qwen3-0.6b"]["params"])):
        assert torch.equal(a, b)

    # As the two ranks of a 1x2 mesh: their shards tile the whole leaves.
    from repro_torch.train.steps import train_state_shardings

    one_two = make_mesh((1, 2), ("data", "model"))
    _, sh = train_state_shardings(lm, None, one_two, shd.train_rules(False))
    parts = []
    for rank in range(2):
        ix = layers.tree_map(lambda p, s: shd.shard_index(s, p.shape, one_two,
                                                           one_two.coords(rank)),
                             specs, sh.params)
        parts.append(mgr.restore(template, shardings=TrainState(ix, ix, ix, ())))
    n_split = 0
    for spec, a, b, w in zip(leaves(sh.params), leaves(parts[0].nu), leaves(parts[1].nu),
                             leaves(whole.nu)):
        found = shd.sharded_dim(spec, one_two)
        got = torch.cat([a, b], dim=found[0][0]) if found else a
        assert torch.equal(got, w) and (found or torch.equal(a, b))
        n_split += bool(found)
    assert n_split > 0

    rlm = _ref_lm("qwen3-0.6b", True)
    ref_opt = RefAdamW(RefAdamWConfig())
    rtemplate = jax.eval_shape(lambda k: ref_opt.init(rlm.init(k, dtype=jnp.float32)),
                               jax.random.PRNGKey(0))
    ref = RefManager(runs["ckpt"]).restore(rtemplate)
    assert int(np.asarray(ref.step)) == TRAIN_STEPS
    for mine, theirs in ((whole.params, ref.params), (whole.mu, ref.mu), (whole.nu, ref.nu)):
        for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

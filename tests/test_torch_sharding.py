"""repro_torch's meshes, sharding rules and elastic restart against the
reference on the CPU.

``spec_for``, ``tree_shardings``, ``batch_spec_tree`` and
``cache_axes_tree`` equal the reference's (tolerance: none, specs compare
as tuples) on the full-size qwen3-0.6b, dbrx-132b, recurrentgemma-2b and
rwkv6-7b parameter and cache trees (shapes only: nothing is allocated),
for meshes 2x1, 4x1, 2x2, 16x16 and 2x16x16, under both rule sets. The
reference is called with a duck mesh that has ``.shape``, all its
``spec_for`` reads, and its ``NamedSharding`` replaced by the spec it
wraps (a real 16x16 jax mesh would need 256 devices). ``elastic_mesh``
shapes equal the reference's. A checkpoint written by a 2-rank
``--mesh 2x1`` run restores on one rank (``elastic_mesh(1, 1)``), as two
ranks' shards, and in the reference, leaf for leaf.
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro.distributed import elastic as ref_elastic  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch.train import reduce_config as ref_reduce_config  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.elastic import elastic_mesh, survivors  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import reduce_config  # noqa: E402
from repro_torch.models import LM, layers  # noqa: E402
from repro_torch.optim import TrainState  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train.steps import param_shardings, train_state_shardings  # noqa: E402

ARCHS = ("qwen3-0.6b", "dbrx-132b", "recurrentgemma-2b", "rwkv6-7b")
MESHES = {"2x1": ((2, 1), ("data", "model")), "4x1": ((4, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE = (8, 4096)  # batch, s_max


def _duck(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)))


def _specs(tree):
    """A nested dict of PartitionSpecs (or port specs) as tuples."""
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.fixture
def ref_specs_only(monkeypatch):
    """The reference's NamedSharding(mesh, spec) reduced to its spec."""
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)


@functools.lru_cache(maxsize=None)
def _ref_lm(arch):
    lm = RefLM(ref_configs.get_config(arch))
    shapes = jax.eval_shape(functools.partial(lm.init, dtype=jnp.float32), jax.random.PRNGKey(0))
    return lm, shapes


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch, mesh_name, ref_specs_only):
    shape, axes = MESHES[mesh_name]
    duck, mesh = _duck(shape, axes), mesh_mod.make_mesh(shape, axes)
    rlm, rshapes = _ref_lm(arch)
    lm = LM(configs.get_config(arch))
    multi_pod = "pod" in axes
    for rules_of in (shd.train_rules, shd.serve_rules):
        rules = rules_of(multi_pod)
        want = _specs(ref_shd.tree_shardings(rlm.logical_axes(), rshapes, duck, rules))
        assert _specs(param_shardings(lm, mesh, rules)) == want
    # The train state: mu and nu share the params' layout, the step replicated.
    _, state_specs = train_state_shardings(lm, None, mesh, shd.train_rules(multi_pod))
    assert state_specs.mu == state_specs.params == state_specs.nu and state_specs.step == ()


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_axes_and_shardings_match_reference(arch, mesh_name, ref_specs_only):
    shape, axes = MESHES[mesh_name]
    duck, mesh = _duck(shape, axes), mesh_mod.make_mesh(shape, axes)
    rcache = _ref_lm(arch)[0].cache_spec_tree(*CACHE)
    cache = LM(configs.get_config(arch)).cache_spec_tree(*CACHE)
    assert layers.tree_map(lambda t: tuple(t.shape), cache) == jax.tree_util.tree_map(
        lambda s: tuple(s.shape), rcache)
    rax, ax = ref_shd.cache_axes_tree(rcache), shd.cache_axes_tree(cache)
    assert _specs(ax) == _specs(rax)
    rules = shd.serve_rules("pod" in axes)
    assert _specs(shd.tree_shardings(ax, cache, mesh, rules)) == _specs(
        ref_shd.tree_shardings(rax, rcache, duck, rules))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_tree_matches_reference(mesh_name, ref_specs_only):
    shape, axes = MESHES[mesh_name]
    duck, mesh = _duck(shape, axes), mesh_mod.make_mesh(shape, axes)
    for batch_size in (1, 2, 3, 8, 32, 64):
        tree = {"tokens": np.zeros((batch_size, 16), np.int32),
                "mask": np.zeros((batch_size, 16), bool), "scalar": np.zeros((), np.int32)}
        for rules_of in (shd.train_rules, shd.serve_rules):
            rules = rules_of("pod" in axes)
            assert _specs(shd.batch_spec_tree(tree, mesh, rules)) == _specs(
                ref_shd.batch_spec_tree(tree, duck, rules))


def test_spec_for_fallback_no_reuse_and_constrain():
    mesh = mesh_mod.make_mesh((2, 4), ("data", "model"))
    rules = {"a": ("model",), "b": ("model",), "c": ("data", "model"), "d": None}
    assert shd.spec_for(("a", "b"), (8, 8), mesh, rules) == ("model",)  # no reuse
    assert shd.spec_for(("a",), (6,), mesh, rules) == ()  # 6 % 4: replicated
    assert shd.spec_for(("c", "d"), (16, 3), mesh, rules) == (("data", "model"),)
    x = torch.ones(4, 4)
    assert shd.constrain(x, ("batch", None)) is x


def test_shard_index_tiles_every_leaf():
    """Every rank's slices of a leaf tile it exactly once, a-major over a
    dim's axes (jax's layout)."""
    mesh = mesh_mod.make_mesh((2, 2, 2), ("pod", "data", "model"))
    full = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = (("pod", "data"), None, "model")
    seen = torch.zeros_like(full)
    for rank in range(mesh.size):
        coords = mesh.coords(rank)
        ix = shd.shard_index(spec, tuple(full.shape), mesh, coords)
        assert full[ix].shape == (2, 6, 2)
        assert ix[0].start == 2 * (2 * coords["pod"] + coords["data"])
        seen[ix] += 1
    assert bool((seen == 1).all())


def test_meshes_as_plain_data():
    m = mesh_mod.make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.size == 256
    m2 = mesh_mod.make_production_mesh(multi_pod=True)
    assert list(m2.shape.items()) == [("pod", 2), ("data", 16), ("model", 16)]
    assert m2.coords(255) == {"pod": 0, "data": 15, "model": 15}
    assert m2.coords(256) == {"pod": 1, "data": 0, "model": 0}
    assert mesh_mod.small_mesh().shape == {"data": 2, "model": 2}
    devs = ["h2", "h0", "h1", "h3"]
    assert mesh_mod.make_mesh((2, 2), ("data", "model"), devs).devices.tolist() == [
        ["h2", "h0"], ["h1", "h3"]]
    assert mesh_mod.parse_mesh("2x1").shape == {"data": 2, "model": 1}
    for bad in ("2", "0x1", "ax1"):
        with pytest.raises(ValueError):
            mesh_mod.parse_mesh(bad)


@pytest.mark.parametrize("n,mp,pod", [(1, 1, None), (4, 1, None), (8, 2, None), (8, 2, 2),
                                      (6, 4, None), (16, 1, 4), (12, 2, 4), (7, 2, None)])
def test_elastic_mesh_matches_reference(n, mp, pod):
    ref = ref_elastic.elastic_mesh(n, mp, pod_axis=pod, devices=jax.devices() * n)
    got = elastic_mesh(n, mp, pod_axis=pod)
    assert list(got.shape.items()) == list(dict(ref.shape).items())
    assert got.axis_names == tuple(ref.axis_names)
    assert got.devices.tolist() == np.arange(got.size).reshape(got.devices.shape).tolist()


def test_elastic_mesh_refuses_and_survivors():
    with pytest.raises(ValueError):
        elastic_mesh(0, 1)
    with pytest.raises(ValueError):
        elastic_mesh(3, 4)
    assert survivors(8, [1, 1, 5]) == ref_elastic.survivors(8, [1, 1, 5]) == 6


def test_sharded_dim_lists_every_split_dim_and_head_boundaries():
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    lm = LM(configs.get_config("qwen3-0.6b"))
    specs = param_shardings(lm, mesh, shd.train_rules(False))
    wq = specs["blocks"]["pos0_dense"]["attn"]["wq"]  # (layers, embed, heads)
    assert wq == (None, "data", "model")
    assert shd.sharded_dim(wq, mesh) == [(1, ("data",)), (2, ("model",))]
    dbrx = param_shardings(LM(configs.get_config("dbrx-132b")), mesh, shd.train_rules(False))
    assert shd.sharded_dim(dbrx["blocks"]["pos0_moe"]["moe"]["we1"], mesh) == [
        (1, ("model",)), (2, ("data",))]  # (layers, experts, embed, None)
    assert shd.sharded_dim((("pod", "data"), None, "model"), mesh_mod.make_mesh(
        (1, 2, 2), ("pod", "data", "model"))) == [(0, ("data",)), (2, ("model",))]
    assert shd.sharded_dim(wq, mesh_mod.make_mesh((1, 1), ("data", "model"))) == []
    # model = 2: qwen3-0.6b's 16 heads of 128 split on a head boundary;
    # recurrentgemma-2b's one KV head of 256 does not.
    assert shd.split_on_heads(16 * 128 // 2, 128)
    assert not shd.split_on_heads(256 // 2, 256)


def test_gather_leaf_over_two_dims_on_four_ranks():
    """A leaf split over data and model on a 2x2 mesh: all-gathered whole,
    gathered over data only (the model shard kept, as the FSDP x TP step
    does) and gathered to rank 0 alone (a checkpoint)."""
    from repro_torch.distributed.comm import run_ranks

    import torch_rank_programs as progs

    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    whole = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    specs = [("data", None, "model"), (None, "model"), ("model", "data"), ()]
    recs = run_ranks(progs.run_jobs, mesh, [("g", dict(program="gather_leaves", whole=whole,
                                                      specs=specs))],
                     backend="gloo", device="cpu", timeout_s=120)
    for r in recs:
        coords = mesh.coords(r["rank"])
        for spec, got in zip(specs, r["result"]["g"]):
            assert got["dims"] == shd.sharded_dim(spec, mesh)
            assert torch.equal(got["all"], torch.from_numpy(whole))
            model_only = tuple("model" if e == "model" else None for e in spec)
            want = whole[shd.shard_index(model_only, whole.shape, mesh, coords)]
            assert torch.equal(got["keep_model"], torch.from_numpy(want))
            if r["rank"] == 0:
                assert torch.equal(got["to_first"], torch.from_numpy(whole))
            else:
                assert got["to_first"] is None


# ----------------------------------------------------------------- elastic restart


@pytest.fixture(scope="module")
def two_rank_checkpoint(tmp_path_factory):
    """A checkpoint at step 2 of ``launch.train --mesh 2x1`` (gloo, CPU)."""
    root = tmp_path_factory.mktemp("ckpt2")
    train.main(["--device", "cpu", "--reduce", "8", "--steps", "2", "--batch", "4", "--seq", "16",
                "--ckpt-every", "2", "--mesh", "2x1", "--dist-backend", "gloo",
                "--ckpt-dir", str(root)])
    assert sorted(os.listdir(root)) == ["step_00000002"]
    return root


def test_two_rank_checkpoint_restores_on_one_rank_and_in_reference(two_rank_checkpoint):
    lm = LM(reduce_config(configs.get_config("qwen3-0.6b"), 8))
    specs = lm.param_specs()
    template = TrainState(specs, specs, specs, 0)
    mgr = CheckpointManager(str(two_rank_checkpoint))
    plain = mgr.restore(template)

    one = elastic_mesh(1, 1)
    _, shardings = train_state_shardings(lm, None, one, shd.train_rules(False))
    index = layers.tree_map(lambda p, s: shd.shard_index(s, p.shape, one, one.coords(0)),
                            specs, shardings.params)
    whole = mgr.restore(template, shardings=TrainState(index, index, index, ()))
    assert int(whole.step) == 2
    for a, b in zip(leaves(whole.params), leaves(plain.params)):
        assert torch.equal(a, b)

    # As the two ranks of a 2x1 mesh: their shards tile the whole leaves.
    two = mesh_mod.make_mesh((2, 1), ("data", "model"))
    _, sh2 = train_state_shardings(lm, None, two, shd.train_rules(False))
    parts = []
    for rank in range(2):
        ix = layers.tree_map(lambda p, s: shd.shard_index(s, p.shape, two, two.coords(rank)),
                             specs, sh2.params)
        parts.append(mgr.restore(template, shardings=TrainState(ix, ix, ix, ())))
    for spec, a, b, w in zip(leaves(sh2.params), leaves(parts[0].mu), leaves(parts[1].mu),
                             leaves(plain.mu)):
        found = shd.sharded_dim(spec, two)
        got = torch.cat([a, b], dim=found[0][0]) if found else a
        assert torch.equal(got, w) and (found or torch.equal(a, b))

    # The reference reads the same files into its own TrainState.
    rlm = RefLM(ref_reduce_config(ref_configs.get_config("qwen3-0.6b"), 8))
    ref_opt = RefAdamW(RefAdamWConfig())
    rtemplate = jax.eval_shape(lambda k: ref_opt.init(rlm.init(k, dtype=jnp.float32)),
                               jax.random.PRNGKey(0))
    ref = RefManager(str(two_rank_checkpoint)).restore(rtemplate)
    assert int(np.asarray(ref.step)) == 2
    for mine, theirs in ((whole.params, ref.params), (whole.mu, ref.mu), (whole.nu, ref.nu)):
        for a, b in zip(leaves(mine), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

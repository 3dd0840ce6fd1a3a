"""repro_torch.launch.dryrun against repro.launch.dryrun on the CPU.

- The cell choices, for all ten archs x four shapes x both production
  meshes, tolerance 0 (pure Python): ``input_specs`` (shapes, dtypes by
  name), ``_train_rules_for`` (rules and ``grad_accum``),
  ``_serve_rules_for``, ``reduced_depth`` and the skipped cells.
- ``arg_bytes_dev`` of every one of those cells (no dry pass) equals the
  sum over the reference's argument leaves (``jax.eval_shape``: nothing
  allocated) of each leaf's bytes over its spec's mesh-axis sizes; the
  reference's specs come from the duck mesh of
  ``tests/test_torch_sharding.py``.
- ``tests/test_distributed.py``'s small-mesh dry run, mirrored: the
  reference's reduced qwen3-0.6b on ``2x4``; train, decode and prefill
  count FLOPs and train has collectives.
- Two points: on reduced qwen3-0.6b (dense) and recurrentgemma-2b
  (recurrent), ``roofline_cell``'s total FLOPs and collective bytes equal
  the full-depth ``lower_cell``'s (integers, exact).
- Work conservation: 8 ranks of ``2x4`` count the FLOPs of one ``1x1``
  rank plus the one product the model axis replicates, named: K and V,
  whose 2 KV heads do not split 4 ways, are projected whole on every
  ``model`` rank.
- The shape-only scans count their formulas' FLOPs.
- Weight-gathered serving: two spawned ``gloo`` ranks on ``2x1`` serve a
  reduced dbrx-132b under ``_serve_rules_for``'s rules for the full
  model (``embed`` on ``data``: each rank holds half of every embed dim)
  and equal the one-device serve: tokens equal, logits within 1e-5.
- The full sweep (``--arch all --shape all --mesh both --roofline``) is
  marked slow.
"""

import dataclasses
import functools
import os
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

# The reference's dryrun sets XLA_FLAGS (512 host devices) when imported;
# jax reads them when its backend starts, which the import does not do.
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as ref_dryrun  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

import torch_rank_programs as progs  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs.base import shapes_for as ref_shapes_for  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.distributed.comm import run_ranks  # noqa: E402
from repro_torch.kernels import shape_only  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.serve import serve_batch  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ARCHS = tuple(configs.list_archs())
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}
# tests/test_distributed.py's reduced qwen3-0.6b
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
            vocab_size=512)
SMALL = (ShapeSpec("t", "train", 64, 8), ShapeSpec("d", "decode", 64, 8),
         ShapeSpec("p", "prefill", 64, 8))


def _tiny(arch="qwen3-0.6b", **kw):
    return dataclasses.replace(configs.get_config(arch), **{**TINY, **kw})


def _dtype(dt) -> str:
    return str(dt).removeprefix("torch.")


def test_archs_and_shapes_are_the_reference_s():
    assert ARCHS == tuple(ref_configs.list_archs())
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_choices_match_reference(arch):
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    for multi_pod in MESHES:
        assert dryrun._serve_rules_for(cfg, multi_pod) == ref_dryrun._serve_rules_for(
            rcfg, multi_pod)
        for name, shape in SHAPES.items():
            rshape = REF_SHAPES[name]
            assert dryrun._train_rules_for(cfg, shape, multi_pod) == \
                ref_dryrun._train_rules_for(rcfg, rshape, multi_pod)
            got = [(k, tuple(v.shape), _dtype(v.dtype))
                   for k, v in dryrun.input_specs(cfg, shape).items()]
            want = [(k, tuple(v.shape), v.dtype.name)
                    for k, v in ref_dryrun.input_specs(rcfg, rshape).items()]
            assert got == want
    for d in (0, 1, 2):
        a, b = dryrun.reduced_depth(cfg, d), ref_dryrun.reduced_depth(rcfg, d)
        assert (a.n_layers, a.n_superblocks, a.remainder) == (b.n_layers, b.n_superblocks,
                                                             b.remainder)
    # Skipped cells: the port's run without a pass, against shapes_for.
    recs = dryrun.run([arch], list(SHAPES), ["single", "multi"], None, roofline=False,
                      full=False)
    skipped = {(r["shape"], r["mesh"]) for r in recs if r.get("status") == "skipped"}
    valid = ref_shapes_for(rcfg)
    assert skipped == {(s, m) for s in REF_SHAPES if s not in valid
                       for m in ("16x16", "2x16x16")}
    assert all(r["reason"] == "long_500k requires sub-quadratic attention"
               for r in recs if r.get("status") == "skipped")


# ------------------------------------------------------------- argument bytes


@functools.lru_cache(maxsize=None)
def _ref_state(arch):
    lm = RefLM(ref_configs.get_config(arch))
    state = jax.eval_shape(
        lambda k: RefAdamW(RefAdamWConfig()).init(lm.init(k, dtype=jnp.bfloat16)),
        jax.random.PRNGKey(0))
    return lm, state


def _pairs(tree, specs):
    """(leaf, spec) of nested dicts (a spec is a leaf, though a tuple)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    else:
        yield tree, specs


def _ref_arg_bytes(arch, shape, multi_pod):
    """Each reference argument leaf's bytes over its spec's axis sizes."""
    axes_shape, axes = MESHES[multi_pod]
    duck = types.SimpleNamespace(shape=dict(zip(axes, axes_shape)))
    lm, state = _ref_state(arch)
    cfg = lm.cfg
    batch = ref_dryrun.input_specs(cfg, shape)
    if shape.kind == "train":
        rules, _ = ref_dryrun._train_rules_for(cfg, shape, multi_pod)
    else:
        rules = ref_dryrun._serve_rules_for(cfg, multi_pod)
    pspecs = ref_shd.tree_shardings(lm.logical_axes(), state.params, duck, rules)
    args = [(state.params, pspecs), (batch, ref_shd.batch_spec_tree(batch, duck, rules))]
    if shape.kind == "train":
        args += [(state.mu, pspecs), (state.nu, pspecs), (state.step, ())]
    if shape.kind == "decode":
        cache = lm.cache_spec_tree(shape.global_batch, shape.seq_len)
        lengths = jax.ShapeDtypeStruct((shape.global_batch,), jnp.int32)
        args += [(cache, ref_shd.tree_shardings(ref_shd.cache_axes_tree(cache), cache, duck,
                                                rules)),
                 (lengths, ref_shd.batch_spec_tree(lengths, duck, rules))]
    total = 0
    for tree, specs in args:
        for leaf, spec in _pairs(tree, specs):
            n = 1
            for entry in tuple(spec):
                for a in (entry,) if isinstance(entry, str) else tuple(entry or ()):
                    n *= duck.shape[a]
            total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // n
    return total


@pytest.mark.parametrize("arch", ARCHS)
def test_arg_bytes_match_reference_leaves(arch, monkeypatch):
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)
    cfg = configs.get_config(arch)
    valid = configs.shapes_for(cfg)
    assert valid == ref_shapes_for(ref_configs.get_config(arch))
    for multi_pod in MESHES:
        mesh = make_production_mesh(multi_pod=multi_pod)
        for name in valid:
            got = dryrun.arg_bytes(cfg, SHAPES[name], mesh, multi_pod=multi_pod)
            assert got == _ref_arg_bytes(arch, REF_SHAPES[name], multi_pod), (name, multi_pod)


# ------------------------------------------------------------- dry passes


def test_small_mesh_dryrun():
    """tests/test_distributed.py's check on the port: 2x4, no subprocess
    (the dry run needs no devices)."""
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for shape in SMALL:
        rec = dryrun.lower_cell(_tiny(), shape, mesh, multi_pod=False)
        out[shape.kind] = {"flops": rec["flops_dev"], "colls": rec["collectives"]["count"]}
        assert rec["chips"] == 8 and rec["mesh"] == "2x4"
        assert rec["temp_bytes_dev"] is None and rec["compile_s"] is None
        assert 0 < rec["arg_bytes_dev"] and 0 < rec["out_bytes_dev"] < rec["bytes_dev"]
    assert set(out) == {"train", "decode", "prefill"}
    for v in out.values():
        assert v["flops"] > 0
    assert out["train"]["colls"] > 0
    # The passes leave no fake tensor behind for real calls (rope caches
    # its frequencies per device).
    x = layers.rope(torch.ones(1, 1, 3, 16), torch.arange(3)[None, None], 1e4)
    assert type(x) is torch.Tensor and float(x.sum()) != 0.0


@pytest.mark.parametrize("arch,layers,kind", [("qwen3-0.6b", 3, "train"),
                                               ("qwen3-0.6b", 3, "decode"),
                                               ("recurrentgemma-2b", 8, "train")])
def test_two_point_totals_equal_full_depth(arch, layers, kind):
    """Depth 0 and 1 against the full depth (3 superblocks; 2 and the two
    remainder rec layers), on 2x2."""
    cfg = _tiny(arch, n_layers=layers, n_kv_heads=1 if arch == "recurrentgemma-2b" else 2)
    assert cfg.n_superblocks >= 2
    mesh = make_mesh((2, 2), ("data", "model"))
    shape = next(s for s in SMALL if s.kind == kind)
    full = dryrun.lower_cell(cfg, shape, mesh, multi_pod=False)
    two = dryrun.roofline_cell(cfg, shape, mesh, multi_pod=False)
    assert two["flops_dev"] == full["flops_dev"]
    assert two["coll_bytes_dev"] == sum(v for k, v in full["collectives"].items() if k != "count")
    assert two["bytes_dev"] == full["bytes_dev"]


def test_work_is_conserved_across_ranks():
    """flops_dev x 8 on 2x4 = the 1x1 count + what ``model`` replicates:
    the K and V projections (2 KV heads of 16 columns over 4 ranks: a
    shard inside a head), whole on each of the 4 model ranks. Each is run
    forward, again by remat, and twice backward (input and weight)."""
    cfg = _tiny()
    shape = SMALL[0]
    one = dryrun.lower_cell(cfg, shape, make_mesh((1, 1), ("data", "model")),
                            multi_pod=False)["flops_dev"]
    eight = dryrun.lower_cell(cfg, shape, make_mesh((2, 4), ("data", "model")),
                              multi_pod=False)["flops_dev"]
    tokens = shape.global_batch * shape.seq_len
    kv_proj = 4 * 2 * (2 * tokens * cfg.d_model * cfg.n_kv_heads * cfg.head_dim) * cfg.n_layers
    assert 8 * eight == one + (4 - 1) * kv_proj


def test_shape_only_scans_count_their_formulas():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan

    B, H, T, N, D = 2, 3, 5, 4, 6
    with FakeTensorMode():
        r, k, v, w = (torch.empty(B, H, T, N, requires_grad=True) for _ in range(4))
        u = torch.empty(H, N, requires_grad=True)
        la, gx = (torch.empty(B, T, D, requires_grad=True) for _ in range(2))
        with FlopCounterMode(display=False, custom_mapping=shape_only.FLOP_FORMULAS) as fwd:
            o, s = rwkv6_scan(r, k, v, w, u)
            h, h_last = rglru_scan(la, gx)
        assert (o.shape, s.shape, h.shape, h_last.shape) == (
            (B, H, T, N), (B, H, N, N), (B, T, D), (B, D))
        assert fwd.get_total_flops() == 7 * B * H * T * N * N + 8 * B * T * D
        with FlopCounterMode(display=False, custom_mapping=shape_only.FLOP_FORMULAS) as bwd:
            grads = torch.autograd.grad((o.sum() + s.sum() + h.sum() + h_last.sum()),
                                        (r, k, v, w, u, la, gx))
        assert [tuple(g.shape) for g in grads] == [(B, H, T, N)] * 4 + [(H, N)] + [(B, T, D)] * 2
        assert bwd.get_total_flops() == 2 * fwd.get_total_flops()


# ------------------------------------------------------------- serving


def test_weight_gathered_serving_equals_one_device():
    full = configs.get_config("dbrx-132b")
    rules = dryrun._serve_rules_for(full, False)
    assert rules["embed"] == ("data",) and rules == ref_dryrun._serve_rules_for(
        ref_configs.get_config("dbrx-132b"), False)
    arch_kw = dict(arch="dbrx-132b", reduce=8)
    lm = progs.lm_of(**arch_kw)
    rng = np.random.default_rng(0)
    def draw(p):  # tests/test_torch_dist_train.py's draw
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init in ("zeros", "ones") else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    params = layers.tree_map(draw, lm.param_specs())
    prompts = rng.integers(0, lm.cfg.vocab_size, (4, 16)).astype(np.int64)
    gen = 4
    mesh = make_mesh((2, 1), ("data", "model"))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, progs.gathered_serve, mesh, arch_kw, params, prompts, gen,
                            rules, backend="gloo", device="cpu", timeout_s=180)
        want_tokens, want_logits = serve_batch(lm, progs.tensors(params, "cpu"), prompts, gen,
                                               return_logits=True)
        recs = ranks.result()
    D = lm.cfg.d_model
    for r, rec in enumerate(recs):
        got = rec["result"]
        assert got["shapes"]["embed"] == (lm.cfg.vocab_size, D // 2)  # half of every embed dim
        rows = slice(2 * r, 2 * r + 2)
        np.testing.assert_array_equal(got["tokens"].numpy(), want_tokens[rows])
        np.testing.assert_allclose(got["logits"].numpy(), want_logits[rows], rtol=1e-5,
                                   atol=1e-5)
        assert rec["comm_bytes"]["all_gather"] > 0


@pytest.mark.slow
def test_full_sweep_is_ok_or_skipped(tmp_path):
    recs = dryrun.main(["--arch", "all", "--shape", "all", "--mesh", "both", "--roofline",
                        "--out", str(tmp_path / "dryrun.json")])
    assert len(recs) == len(ARCHS) * len(SHAPES) * 2
    assert {r["status"] for r in recs} <= {"ok", "skipped"}, [
        (r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs
        if r["status"] == "error"]

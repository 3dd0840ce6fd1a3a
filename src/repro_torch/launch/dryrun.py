"""Dry run: one rank's step of every (arch x shape x mesh) cell, on fake tensors.

Port of `repro.launch.dryrun`. The reference lowers and compiles each
cell's jitted step over the production meshes' host devices and reads
XLA's cost and memory analyses. In the port each rank runs its own
programme, so the dry run runs rank 0's: every rank has the same shapes,
since `spec_for` replicates a dim that does not divide. The step comes
from `repro_torch.train.steps`, unchanged, and runs under
``FakeTensorMode``: CPU fake tensors, whose ops compute shapes and
allocate nothing, with a `repro_torch.distributed.comm.DryComm` whose
collectives return the right shapes and count their bytes. The RWKV-6
and RG-LRU scans run as one shape-only op each
(`repro_torch.kernels.shape_only`), not their plain per-step loops.
Nothing touches a device.

Per cell, `lower_cell` records the reference's keys:

- ``flops_dev``: `torch.utils.flop_counter.FlopCounterMode` over the
  whole step (forward, remat recompute, backward, optimizer). It counts
  products (matmuls, batched matmuls, attention) and the recurrences by
  `shape_only.FLOP_FORMULAS`; XLA's cost analysis also counts elementwise
  work, which this does not.
- ``bytes_dev``: the operand and result bytes of every op of the pass
  that is neither a view nor a metadata query, counted by one dispatch
  mode: eager, unfused traffic (XLA's ``bytes accessed`` is its fused
  programme's).
- ``arg_bytes_dev`` / ``out_bytes_dev``: exact, the rank's shards of the
  step's arguments and results.
- ``temp_bytes_dev``, ``alias_bytes_dev``, ``compile_s``, ``hlo_chars``:
  None (no compiler, no HLO).
- ``lower_s``: the dry pass's seconds.
- ``collectives``: `rooftool.comm_collectives` of the dry `Comm`'s output
  bytes, the reference's convention.
- ``act_seq``: on train cells whose rules shard the activations' sequence
  over ``model`` (`_train_rules_for`): the port does not yet
  (`repro_torch.distributed.sharding.constrain` is a no-op).

Dtypes are the reference's, so the bytes compare: bf16 parameters, the
optimizer's float32 moments, int32 tokens, bf16 embeddings and images,
`LM.cache_spec_tree`'s caches.

Usage (on the CPU; no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both --out build/dryrun.json [--roofline]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .. import configs
from ..configs.base import SHAPES, ArchConfig, ShapeSpec, shapes_for
from ..distributed import sharding as shd
from ..distributed.comm import DryComm
from ..kernels import shape_only
from ..models import LM, layers
from ..models.layers import tree_map
from ..optim import AdamW, AdamWConfig, TrainState
from ..train import steps as train_steps
from . import rooftool
from .mesh import make_production_mesh

ACT_SEQ_NOTE = "requested, not sharded in the port"


# --------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# --------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The step's batch as meta tensors: the global batch, as the
    reference's ``ShapeDtypeStruct``s."""
    B, S = shape.global_batch, shape.seq_len
    n_in = 1 if shape.kind == "decode" else S  # decode: one new token
    batch: Dict[str, torch.Tensor] = {}
    if cfg.embed_inputs:
        batch["embeds"] = _meta((B, n_in, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            batch["targets"] = _meta((B, S), torch.int32)
    else:
        batch["tokens"] = _meta((B, n_in), torch.int32)
    if cfg.n_image_tokens and shape.kind != "decode":
        batch["images"] = _meta((B, cfg.n_image_tokens, cfg.d_model), torch.bfloat16)
    return batch


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------


def _train_rules_for(cfg: ArchConfig, shape: ShapeSpec, multi_pod: bool):
    """(rules, grad_accum) for a train cell.

    - Megatron-SP residual stream when stacked scan carries dominate HBM
      (skipped for MoE: dispatch grouping crosses the seq sharding and the
      round-trips regressed memory — §Perf).
    - microbatch grad accumulation to bound per-pass activation memory.
    """
    rules = shd.train_rules(multi_pod)
    dp = (2 * 16) if multi_pod else 16
    b_loc = shape.global_batch / dp
    carry_bytes = cfg.n_superblocks * b_loc * shape.seq_len * cfg.d_model * 2
    is_moe = "moe" in cfg.pattern
    if carry_bytes > 8e9 and not is_moe:
        rules = {**rules, "act_seq": ("model",)}
        carry_bytes /= 16
    # Working set ~ carries + a few per-layer activation copies.
    work = carry_bytes + 10 * b_loc * shape.seq_len * cfg.d_model * 2
    accum = 1
    while work / accum > 6e9 and accum < max(1, int(b_loc)):
        accum *= 2
    return rules, accum


def _serve_rules_for(cfg: ArchConfig, multi_pod: bool):
    """Weight-gathered serving for models too big for 16-way TP alone."""
    rules = shd.serve_rules(multi_pod)
    if cfg.param_count() * 2 / 16 > 12e9:
        rules = {**rules, "embed": ("data",)}
    return rules


# --------------------------------------------------------------------------
# one rank's arguments
# --------------------------------------------------------------------------


def _walk(tree, specs):
    """(leaf, spec) pairs of a nested dict and its spec tree."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], specs[k])
    else:
        yield tree, specs


def _shard_shape(spec, shape, mesh):
    ix = shd.shard_index(spec, tuple(shape), mesh, mesh.coords(0))
    return tuple(i.stop - i.start for i in ix)


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def _cell_args(lm: LM, shape: ShapeSpec, mesh, rules) -> Dict[str, Any]:
    """The step's arguments as {name: (meta tree, spec tree)}, whole
    leaves with the specs that shard them: train (params, mu, nu, step,
    batch), prefill (params, batch), decode (params, batch, cache,
    lengths). Parameters bf16, moments float32."""
    specs = lm.param_specs()
    params = tree_map(lambda p: _meta(p.shape, torch.bfloat16), specs)
    pspecs = train_steps.param_shardings(lm, mesh, rules)
    batch = input_specs(lm.cfg, shape)
    args = {"params": (params, pspecs)}
    if shape.kind == "train":
        f32 = tree_map(lambda p: _meta(p.shape, torch.float32), specs)
        args.update(mu=(f32, pspecs), nu=(f32, pspecs), step=(_meta((), torch.int32), ()))
    args["batch"] = (batch, shd.batch_spec_tree(batch, mesh, rules))
    if shape.kind == "decode":
        cache = lm.cache_spec_tree(shape.global_batch, shape.seq_len)
        args["cache"] = (cache, shd.tree_shardings(shd.cache_axes_tree(cache), cache, mesh, rules))
        lengths = _meta((shape.global_batch,), torch.int32)
        args["lengths"] = (lengths, shd.batch_spec_tree(lengths, mesh, rules))
    return args


def _cell_rules(cfg: ArchConfig, shape: ShapeSpec, multi_pod: bool, train_override=None):
    """(rules, grad_accum) of a cell (grad_accum 1 for serving)."""
    if shape.kind == "train":
        return train_override or _train_rules_for(cfg, shape, multi_pod)
    return _serve_rules_for(cfg, multi_pod), 1


def _shard_bytes(args, mesh) -> int:
    """Each argument leaf's bytes over the mesh-axis sizes its spec splits
    it by (every split divides: `spec_for` replicates where one would not)."""
    return sum(_bytes(leaf) // int(np.prod([shd.axis_size(mesh, e) for e in spec]))
               for tree, specs in args.values() for leaf, spec in _walk(tree, specs))


def arg_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh, *, multi_pod: bool,
              train_override=None) -> int:
    """``arg_bytes_dev`` of a cell, without a dry pass."""
    rules, _ = _cell_rules(cfg, shape, multi_pod, train_override)
    return _shard_bytes(_cell_args(LM(cfg), shape, mesh, rules), mesh)


# --------------------------------------------------------------------------
# the dry pass
# --------------------------------------------------------------------------


class _Traffic(TorchDispatchMode):
    """Operand and result bytes of every op that is not a view, nor a
    query of a tensor's metadata (``prim.device``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace != "prim":
            self.bytes += sum(_bytes(t) for t in pytree.tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


def _out_bytes(out) -> int:
    """Bytes of a step's distinct result tensors (a `TrainState`'s fields
    too: the train step returns the state it updated in place)."""
    tree = [vars(o) if isinstance(o, TrainState) else o for o in out]
    seen = {id(t): t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)}
    return sum(_bytes(t) for t in seen.values())


def lower_cell(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh,
    *,
    multi_pod: bool,
    train_override=None,  # (rules, grad_accum) for roofline depth slices
) -> Dict[str, Any]:
    """Rank 0's step of the cell, dry (see the module's docstring)."""
    lm = LM(cfg)
    comm = DryComm(mesh, 0)
    rules, grad_accum = _cell_rules(cfg, shape, multi_pod, train_override)
    args = _cell_args(lm, shape, mesh, rules)
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def shards(name, whole=False):
        """Fake tensors: rank 0's shards of an argument (``whole``: all of it)."""
        return tree_map(lambda t, spec: torch.empty(
            tuple(t.shape) if whole else _shard_shape(spec, t.shape, mesh), dtype=t.dtype),
            *args[name])

    with fake:
        params = shards("params")
        if shape.kind == "train":
            opt = AdamW(AdamWConfig())
            step, _, _ = train_steps.build_train_step(
                lm, opt, comm, rules, remat=True, grad_accum=grad_accum, multi_pod=multi_pod)
            state = TrainState(params, shards("mu"), shards("nu"), shards("step"))
            # The train step takes the global batch and slices its rows.
            run = functools.partial(step, state, shards("batch", whole=True))
        elif shape.kind == "prefill":
            step, _ = train_steps.build_prefill_step(
                lm, comm, rules, s_max=shape.seq_len, batch_size=shape.global_batch,
                multi_pod=multi_pod)
            run = functools.partial(step, params, shards("batch"))
        else:
            step, _ = train_steps.build_decode_step(lm, comm, rules, multi_pod=multi_pod)
            run = functools.partial(step, params, shards("batch"), shards("cache"),
                                    shards("lengths"), s_max=shape.seq_len)
        flops = FlopCounterMode(display=False, custom_mapping=shape_only.FLOP_FORMULAS)
        traffic = _Traffic()
        t0 = time.time()
        try:
            with flops, traffic:
                out = run()
        finally:
            # The pass leaves fake tensors in the process's rope frequency
            # cache; a later real call must not find them.
            layers._rope_freq.cache_clear()
        t_lower = time.time() - t0

    rec: Dict[str, Any] = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "chips": mesh.size,
        "lower_s": round(t_lower, 2),
        "compile_s": None,
        "flops_dev": flops.get_total_flops(),
        "bytes_dev": traffic.bytes,
        "arg_bytes_dev": _shard_bytes(args, mesh),
        "out_bytes_dev": _out_bytes(out),
        "temp_bytes_dev": None,
        "alias_bytes_dev": None,
        "collectives": rooftool.comm_collectives(comm.out_bytes, sum(comm.calls.values())),
        "hlo_chars": None,
    }
    if rules.get("act_seq"):
        rec["act_seq"] = ACT_SEQ_NOTE
    return rec


def reduced_depth(cfg: ArchConfig, n_superblocks: int) -> ArchConfig:
    """Same config with a different scanned depth (for two-point roofline)."""
    n_layers = len(cfg.pattern) * n_superblocks + len(cfg.remainder)
    return dataclasses.replace(cfg, n_layers=n_layers)


def roofline_cell(cfg, shape, mesh, *, multi_pod: bool) -> Dict[str, Any]:
    """Two-point roofline reconstruction for one cell, as the reference's:
    depth-0 and depth-1 slices (train slices with grad_accum 1 and the
    full config's rules), total = f(0) + n_superblocks * (f(1) - f(0)).
    XLA counts a scanned body once, which the reconstruction undoes; the
    flop counter sees every layer, so here the total equals the
    full-depth count (`tests/test_torch_dryrun.py` holds it so)."""
    override = None
    if shape.kind == "train":
        rules, _ = _train_rules_for(cfg, shape, multi_pod)
        override = (rules, 1)
    r0 = lower_cell(
        reduced_depth(cfg, 0), shape, mesh, multi_pod=multi_pod,
        train_override=override,
    )
    r1 = lower_cell(
        reduced_depth(cfg, 1), shape, mesh, multi_pod=multi_pod,
        train_override=override,
    )
    n = cfg.n_superblocks
    per = lambda a, b: max(0, b - a)  # noqa: E731
    flops = r0["flops_dev"] + per(r0["flops_dev"], r1["flops_dev"]) * n
    byts = r0["bytes_dev"] + per(r0["bytes_dev"], r1["bytes_dev"]) * n
    c0 = sum(v for k, v in r0["collectives"].items() if k != "count")
    c1 = sum(v for k, v in r1["collectives"].items() if k != "count")
    coll = c0 + per(c0, c1) * n
    chips = mesh.size
    cell = rooftool.CellAnalysis(
        flops_dev=flops,
        bytes_dev=byts,
        coll_bytes_dev=coll,
        coll_by_type=r1["collectives"],
        chips=chips,
    )
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = rooftool.model_flops(cfg.active_param_count(), tokens, shape.kind)
    out = cell.summary()
    out["model_flops_total"] = mf
    out["model_flops_dev"] = mf / chips
    out["useful_ratio"] = (mf / chips) / max(flops, 1.0)
    return out


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run(
    archs,
    shape_names,
    meshes,
    out_path: Optional[str],
    roofline: bool,
    full: bool = True,
):
    results = []
    for mesh_kind in meshes:
        multi_pod = mesh_kind == "multi"
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch in archs:
            cfg = configs.get_config(arch)
            valid = shapes_for(cfg)
            for sname in shape_names:
                if sname not in valid:
                    results.append(
                        {
                            "arch": arch,
                            "shape": sname,
                            "mesh": _mesh_name(multi_pod),
                            "status": "skipped",
                            "reason": "long_500k requires sub-quadratic attention",
                        }
                    )
                    print(f"[skip] {arch} x {sname} ({mesh_kind})", flush=True)
                    continue
                shape = SHAPES[sname]
                try:
                    if full:
                        rec = lower_cell(cfg, shape, mesh, multi_pod=multi_pod)
                        rec["status"] = "ok"
                    else:
                        rec = {"arch": arch, "shape": sname, "mesh": _mesh_name(multi_pod)}
                    if roofline and not multi_pod:
                        rec["roofline"] = roofline_cell(
                            cfg, shape, mesh, multi_pod=multi_pod
                        )
                        rec["status"] = "ok"
                    print(
                        f"[ok]   {arch} x {sname} ({mesh_kind}) "
                        f"lower={rec.get('lower_s', 0)}s "
                        f"args={(rec.get('arg_bytes_dev') or 0)/1e9:.2f}GB",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 - report, continue
                    rec = {
                        "arch": arch,
                        "shape": sname,
                        "mesh": _mesh_name(multi_pod),
                        "status": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                    print(f"[FAIL] {arch} x {sname} ({mesh_kind}): {e}", flush=True)
                results.append(rec)
                if out_path:
                    with open(out_path, "w") as f:
                        json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument(
        "--roofline-only", action="store_true",
        help="skip the full-depth pass; only the two-point slices",
    )
    args = ap.parse_args(argv)

    archs = configs.list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["single"], "multi": ["multi"], "both": ["single", "multi"]}[
        args.mesh
    ]
    return run(
        archs,
        shapes,
        meshes,
        args.out,
        roofline=args.roofline or args.roofline_only,
        full=not args.roofline_only,
    )


if __name__ == "__main__":
    main()

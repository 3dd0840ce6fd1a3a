"""repro_torch's int8 error-feedback compression and compressed data
parallelism against the reference on the CPU.

The quantiser and dequantiser bit-equal to `repro.optim.compression`'s;
`compressed_all_reduce` on 2 and 4 spawned `gloo` ranks bit-equal (sum and
new error) to the reference's ``compressed_psum`` under ``jax.vmap`` with
the same axis names on the same per-rank arrays, over ``data``, over a
(pod, data) mesh axis by axis, over both at once, and in the
compressed-DP sync order (pod, then data). One compressed-DP step against
a composition of reference functions on the same per-rank gradients
(synced gradients and errors bit-equal; AdamW within its own test's rtol
1e-6 / atol 1e-7), and the 30-step convergence check of
``tests/test_compressed_dp.py`` (4 ranks, its config, its bound: the last
five losses within 15% of exact DP).

The reference is run eagerly: its source divides by 127.0 and keeps the
multiply and subtract apart, which the port copies. (Under ``jax.jit``,
XLA's CPU backend contracts them into FMAs with the reciprocal.) Ranks
import no jax (`torch_rank_programs`); each spawn has a timeout.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_rank_programs as progs  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.optim import AdamW as RefAdamW  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import compression as ref_comp  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.distributed.comm import run_ranks  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402

TIMEOUT_S = 120
# tests/test_compressed_dp.py's model and data.
CONV = dict(arch="qwen3-0.6b", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=512)
CONV_STEPS = 30


def _leaves_of(rng, n_ranks):
    """Per rank: leaves of several shapes and magnitudes; one whose scale
    is exactly 1 (max 127) and whose values sit on .5, so round-half-even
    decides them; one of zeros (scale 1e-12)."""
    halves = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5], np.float32)
    out_g, out_e = [], []
    for r in range(n_ranks):
        g = [rng.standard_normal((5, 7)).astype(np.float32) * 10.0 ** (r - 2),
             rng.standard_normal((33,)).astype(np.float32),
             halves * (1 if r % 2 else -1),
             np.zeros((3, 2), np.float32)]
        e = [rng.standard_normal(a.shape).astype(np.float32) * 0.01 for a in g]
        e[2] = np.zeros_like(e[2])
        out_g.append(g)
        out_e.append(e)
    return out_g, out_e


def _ref_psum(gs, es, mesh_shape, axes):
    """The reference's compressed_psum of every leaf under vmaps named as
    the mesh's axes; ``axes`` a name, a tuple (one psum over both), or a
    list (the DP sync: one psum per axis in turn). Returns per leaf the
    (ranks, ...) sums and new errors.

    One eager call for all leaves (eager jax compiles each operation per
    shape): each leaf is flattened and zero-padded to the longest, and an
    unnamed outer vmap runs over the leaves. The padding changes no real
    element's result: a zero adds nothing to max|g + e| and quantises to 0.
    """
    n_ranks, n_leaves = len(gs), len(gs[0])
    size = max(a.size for a in gs[0])

    def stack(arrays):
        flat = np.zeros((n_leaves, n_ranks, size), np.float32)
        for r in range(n_ranks):
            for i in range(n_leaves):
                flat[i, r, :arrays[r][i].size] = arrays[r][i].reshape(-1)
        return jnp.asarray(flat.reshape((n_leaves,) + tuple(mesh_shape.values()) + (size,)))

    def f(g, e):
        for ax in (axes if isinstance(axes, list) else [axes]):
            g, e = ref_comp.compressed_psum(g, e, ax)
        return g, e

    for name in reversed(list(mesh_shape)):
        f = jax.vmap(f, axis_name=name)
    s, n = jax.vmap(f)(stack(gs), stack(es))
    s = np.asarray(s).reshape(n_leaves, n_ranks, size)
    n = np.asarray(n).reshape(n_leaves, n_ranks, size)
    shapes = [a.shape for a in gs[0]]
    return ([s[i, :, :int(np.prod(sh))].reshape((n_ranks,) + sh) for i, sh in enumerate(shapes)],
            [n[i, :, :int(np.prod(sh))].reshape((n_ranks,) + sh) for i, sh in enumerate(shapes)])


@pytest.fixture(scope="module")
def data_runs():
    """Two spawns at once: 2 ranks on ``data`` (sums, one compressed-DP
    step); 4 ranks on a (4, 1) mesh (sums, 30 steps) and, the same ranks,
    on a (2, 2) pod x data mesh (sums by axis, both at once, the DP sync).
    Meanwhile this process computes the reference's sums on the same
    inputs, each rank's reference gradients and the exact-DP losses."""
    rng = np.random.default_rng(0)
    lm_ref = RefLM(dataclasses.replace(ref_configs.get_config("qwen3-0.6b"),
                                       **{k: v for k, v in CONV.items() if k != "arch"}))
    params = jax.tree_util.tree_map(np.asarray, lm_ref.init(jax.random.PRNGKey(0),
                                                            dtype=jnp.float32))
    data = SyntheticLMData(DataConfig(vocab_size=512, seq_len=64, global_batch=8))
    batches = [data.batch(i) for i in range(CONV_STEPS)]
    arch_kw = dict(CONV)
    g2, e2 = _leaves_of(rng, 2)
    g4, e4 = _leaves_of(rng, 4)
    gp, ep = _leaves_of(rng, 4)
    pod = dict(mesh=((2, 2), ("pod", "data")))
    two = [("sums", dict(program="compressed_sums", gs=g2, es=e2, axes="data")),
           ("step", dict(program="compressed_steps", arch_kw=arch_kw, params=params,
                         batches=batches[:1], lr=3e-3))]
    four = [("sums", dict(program="compressed_sums", gs=g4, es=e4, axes="data")),
            ("conv", dict(program="compressed_steps", arch_kw=arch_kw, params=params,
                          batches=batches, lr=3e-3, eval_batches=batches))]
    four += [(f"sums_{_key(ax)}", dict(program="compressed_sums", gs=gp, es=ep, axes=ax, **pod))
             for ax in POD_AXES]
    four.append(("sync", dict(program="compressed_sync", gs=[g[0] for g in gp],
                              es=[e[0] for e in ep], axes=("pod", "data"), **pod)))
    with ThreadPoolExecutor(max_workers=2) as pool:
        runs = {n: pool.submit(run_ranks, progs.run_jobs, make_mesh((n, 1), ("data", "model")),
                               jobs, backend="gloo", device="cpu", timeout_s=TIMEOUT_S)
                for n, jobs in ((2, two), (4, four))}
        ref = {"two": _ref_psum(g2, e2, {"data": 2}, "data"),
               "four": _ref_psum(g4, e4, {"data": 4}, "data"),
               "sync": _ref_psum([[g[0]] for g in gp], [[e[0]] for e in ep],
                                 {"pod": 2, "data": 2}, ["pod", "data"]),
               "grads": _ref_local_grads(lm_ref, params, batches[0], 2),
               "exact": _exact_dp_losses(params, batches)}
        for ax in POD_AXES:
            ref[f"pod_{_key(ax)}"] = _ref_psum(gp, ep, {"pod": 2, "data": 2}, ax)
        out = {"params": params, "batches": batches, "ref": ref}
        out["two"] = (g2, e2, [r["result"] for r in runs[2].result()])
        out["four"] = (g4, e4, [r["result"] for r in runs[4].result()])
    out["pod"] = (gp, ep, out["four"][2])
    return out


POD_AXES = ("pod", "data", ("pod", "data"))


def _key(ax):
    return ax if isinstance(ax, str) else "+".join(ax)


def _ref_local_grads(lm_ref, params, batch, n):
    """Per rank: ``jax.value_and_grad`` of the reference's loss on its rows."""
    value_and_grad = jax.jit(jax.value_and_grad(lm_ref.loss))
    rows = batch["tokens"].shape[0] // n
    return [value_and_grad(jax.tree_util.tree_map(jnp.asarray, params),
                           {"tokens": jnp.asarray(batch["tokens"][r * rows:(r + 1) * rows])})
            for r in range(n)]


def _exact_dp_losses(params, batches):
    """tests/test_compressed_dp.py's exact DP: one process, the global
    batch, each step's loss before its update."""
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import build_train_step

    lm = progs.lm_of(**CONV)
    opt = AdamW(AdamWConfig(lr=3e-3))
    state = opt.init(progs.tensors(params, "cpu"))
    step = build_train_step(lm, opt, remat=False)
    exact = []
    for b in batches:
        tb = progs.tensors(b, "cpu")
        exact.append(float(lm.loss(state.params, tb)))
        state, _ = step(state, tb)
    return exact


# ----------------------------------------------------------------- quantiser


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-6), (2, 1e4)])
def test_quantize_and_dequantize_bit_equal_reference(seed, scale):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((64, 33)) * scale).astype(np.float32)
    e = (rng.standard_normal((64, 33)) * scale * 0.01).astype(np.float32)
    q, s, ne = compression.quantize(torch.from_numpy(g), torch.from_numpy(e))
    rq, rs, rne = ref_comp.quantize(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(ne.numpy(), np.asarray(rne))
    np.testing.assert_array_equal(compression.dequantize(q, s).numpy(),
                                  np.asarray(ref_comp.dequantize(rq, rs)))


def test_quantize_rounds_half_to_even_and_clips():
    g = torch.tensor([127.0, 2.5, -3.5, 0.5, 1.5, -126.5])
    q, s, _ = compression.quantize(g, torch.zeros_like(g))
    assert float(s) == 1.0  # 127 / 127 + 1e-12 rounds to 1 in float32
    assert q.tolist() == [127, 2, -4, 0, 2, -126]


# ----------------------------------------------------------------- all-reduce


def _check_sums(gs, res, want):
    want_s, want_e = want
    for leaf in range(len(gs[0])):
        for r, out in enumerate(res):
            for s_key, e_key in (("sum", "error"), ("tree_sum", "tree_error")):
                np.testing.assert_array_equal(out[s_key][leaf].numpy(), want_s[leaf][r])
                np.testing.assert_array_equal(out[e_key][leaf].numpy(), want_e[leaf][r])


def test_compressed_all_reduce_two_ranks_bit_equal(data_runs):
    gs, _, res = data_runs["two"]
    _check_sums(gs, [r["sums"] for r in res], data_runs["ref"]["two"])


def test_compressed_all_reduce_four_ranks_bit_equal(data_runs):
    gs, _, res = data_runs["four"]
    _check_sums(gs, [r["sums"] for r in res], data_runs["ref"]["four"])


@pytest.mark.parametrize("axes", POD_AXES)
def test_compressed_all_reduce_pod_data_mesh_bit_equal(data_runs, axes):
    gs, _, res = data_runs["pod"]
    _check_sums(gs, [r[f"sums_{_key(axes)}"] for r in res], data_runs["ref"][f"pod_{_key(axes)}"])


def test_compressed_dp_sync_order_bit_equal(data_runs):
    """pod first, then data, the error carried between: the reference's
    ``sync`` loop."""
    _, _, res = data_runs["pod"]
    (want_s,), (want_e,) = data_runs["ref"]["sync"]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["sync"]["sum"].numpy(), want_s[r])
        np.testing.assert_array_equal(out["sync"]["error"].numpy(), want_e[r])


# ----------------------------------------------------------------- the DP step


def test_compressed_dp_step_equals_reference_composition(data_runs):
    """Each rank's local loss and gradients against ``jax.value_and_grad``
    of the reference's ``lm.loss`` on its rows; the step's synced
    gradients and new errors bit-equal to ``compressed_psum`` of those
    gradients; the updated params those of the reference's AdamW."""
    params = data_runs["params"]
    _, _, res = data_runs["two"]
    steps = [r["step"] for r in res]
    n = len(steps)
    for out, (loss, grads) in zip(steps, data_runs["ref"]["grads"]):
        np.testing.assert_allclose(out["loss0"], float(loss), rtol=1e-5)
        for a, b in zip(leaves(out["grads0"]), jax.tree_util.tree_leaves(grads)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-5 * float(np.abs(np.asarray(b)).max()) + 1e-8)
    names = list(leaves(layers.tree_map(lambda a: a, params)))
    gs = [[g.numpy() for g in leaves(out["grads0"])] for out in steps]
    es = [[np.zeros_like(a) for a in names] for _ in steps]
    want_s, want_e = _ref_psum(gs, es, {"data": n}, "data")
    for leaf, err in enumerate(leaves(steps[0]["error"])):
        np.testing.assert_array_equal(err.numpy(), want_e[leaf][0])
    synced = [w[0] for w in want_s]
    ref_opt = RefAdamW(RefAdamWConfig(lr=3e-3))
    state = ref_opt.init(jax.tree_util.tree_map(jnp.asarray, params))
    treedef = jax.tree_util.tree_structure(state.params)
    state = jax.jit(ref_opt.apply)(state, jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(s) for s in synced]))
    for a, b in zip(leaves(steps[0]["params"]), jax.tree_util.tree_leaves(state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    # The reported loss: the mean of the ranks' local means.
    np.testing.assert_allclose(steps[0]["losses"][0], np.mean([s["loss0"] for s in steps]),
                               rtol=1e-6)


def test_compressed_dp_converges_like_exact(data_runs):
    """tests/test_compressed_dp.py on 4 ranks: exact DP (one process, the
    global batch) and compressed DP both learn, and the compressed one's
    last five losses are within 15% of exact DP's."""
    _, _, res = data_runs["four"]
    comp = res[0]["conv"]["evals"]
    assert all(r["conv"]["evals"] == comp for r in res)  # replicated params
    exact = data_runs["ref"]["exact"]
    e_first, e_last = np.mean(exact[:5]), np.mean(exact[-5:])
    c_first, c_last = np.mean(comp[:5]), np.mean(comp[-5:])
    assert e_last < e_first and c_last < c_first
    assert abs(c_last - e_last) / e_last < 0.15, (exact, comp)

"""repro_torch's training gradients against the reference on the CPU.

`LM.loss` and its gradients for every layer family, at tiny sizes
(d_model 64, vocab 512, S 32): dense (qwen3-0.6b, 2 layers),
rec + local_attn (recurrentgemma-2b, one (rec, rec, local_attn) superblock
and its (rec, rec) remainder, window 16 so that S = 32 takes the
chunk-pair form), rwkv (rwkv6-7b, 2 layers of 4 heads of 16), moe
(dbrx-132b, 2 layers of 4 experts top-2 at capacity factor 1.25, on 4 x 64
tokens: 64 groups of 4 tokens with 3 slots an expert, so pairs are
dropped) and cross (llama-3.2-vision-11b, one (dense x 3, cross, dense)
superblock against 8 image embeddings, the gate drawn non-zero). The
same numpy parameters and batches go to the reference's ``lm.loss`` under
``jax.value_and_grad`` and to the port's loss under autograd, with and
without a mask and with ``LOSS_CHUNK`` set to 8 on both classes (four CE
chunks, each under checkpoint). Then the kernels' autograd Functions: the
chunk-checkpointed RWKV-6 scan against the reference's custom VJP, and
each Function run with the plain forward in place of its kernel, whose
gradients must equal plain autograd bit for bit.

Tolerances: losses rtol 1e-5; every gradient leaf within 1e-4 * max|leaf|
+ 1e-6 (XLA and PyTorch sum the products in other orders, and rwkv's
group norm enlarges such differences); the RWKV-6 cotangents 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.kernels.rwkv6_scan import ops as ref_rwkv_ops  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro_torch import configs, convert, kernels  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rglru_scan import ref as rg_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rk_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as rk_ref  # noqa: E402
from repro_torch.models import LM, blocks, layers  # noqa: E402
from repro_torch.optim.adamw import leaves  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402

TINY = {
    "qwen3-0.6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                       d_ff=128, vocab_size=512),
    "recurrentgemma-2b": dict(n_layers=5, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
                              d_ff=128, vocab_size=512, rnn_width=64, local_window=16),
    "rwkv6-7b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, rwkv_head_dim=16,
                     d_ff=128, vocab_size=512),
    "dbrx-132b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                      vocab_size=512, n_experts=4, experts_per_token=2,
                      moe_capacity_factor=1.25),
    "llama-3.2-vision-11b": dict(n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                                 d_ff=128, vocab_size=512, n_image_tokens=8),
}
SHAPE = {"dbrx-132b": (4, 64)}  # (B, S); else (2, 32)


@pytest.fixture(scope="module", params=list(TINY))
def pair(request):
    """(reference LM, reference params, port LM, port params, numpy batch):
    parameters drawn with numpy from the specs (the zero-initialised ones
    at 0.1), a batch of tokens with a random mask (and image embeddings)."""
    arch = request.param
    rlm = RefLM(dataclasses.replace(ref_configs.get_config(arch), **TINY[arch]))
    lm = LM(dataclasses.replace(configs.get_config(arch), **TINY[arch]))
    rng = np.random.default_rng(0)

    def draw(p):
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init in ("zeros", "ones") else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    tree = layers.tree_map(draw, lm.param_specs())
    B, S = SHAPE.get(arch, (2, 32))
    batch = {"tokens": rng.integers(0, lm.cfg.vocab_size, size=(B, S)).astype(np.int32),
             "mask": rng.random((B, S)) < 0.8}
    if lm.cfg.n_image_tokens:
        batch["images"] = rng.normal(0, 1, (B, lm.cfg.n_image_tokens, 64)).astype(np.float32)
    return (rlm, jax.tree_util.tree_map(jnp.asarray, tree), lm,
            convert.lm_params_from_reference(tree, lm), batch)


def _count_drops(monkeypatch):
    """A one-element list counting the (token, choice) pairs the port's MoE
    dispatch drops while the test runs."""
    dropped = [0]
    dispatch = blocks._moe_dispatch

    def counting(*args):
        buf, meta = dispatch(*args)
        dropped[0] += int((~meta[2]).sum())
        return buf, meta

    monkeypatch.setattr(blocks, "_moe_dispatch", counting)
    return dropped


def _loss_chunk(monkeypatch, chunk):
    if chunk is not None:
        monkeypatch.setattr(RefLM, "LOSS_CHUNK", chunk)
        monkeypatch.setattr(LM, "LOSS_CHUNK", chunk)


@pytest.mark.parametrize("masked,chunk", [(False, None), (True, 8)])
def test_loss_and_grads_match_reference(pair, monkeypatch, masked, chunk):
    rlm, rp, lm, params, batch = pair
    _loss_chunk(monkeypatch, chunk)
    if not masked:
        batch = {k: v for k, v in batch.items() if k != "mask"}
    dropped = _count_drops(monkeypatch)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p, b: rlm.loss(p, b)))(
        rp, jax.tree_util.tree_map(jnp.asarray, batch))
    loss, grads = loss_and_grads(lm, params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 remat=True)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)

    def close(path, w):
        g = grads
        for key in path:
            g = g[key.key]
        w = np.asarray(w)
        tol = 1e-4 * np.abs(w).max() + 1e-6
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(close, want)
    if lm.cfg.n_experts:
        assert dropped[0] > 0  # capacity dropped pairs: their path carries no gradient


def test_remat_equals_no_remat(pair, monkeypatch):
    """Bit for bit on the CPU: the recomputed forward is the same
    computation (the reference's test_remat_matches_no_remat)."""
    _, _, lm, params, batch = pair
    _loss_chunk(monkeypatch, 8)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    l0, g0 = loss_and_grads(lm, params, tb, remat=False)
    l1, g1 = loss_and_grads(lm, params, tb, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert torch.equal(lm.forward(params, tb, remat=True), lm.forward(params, tb))


def test_cpu_gradients_launch_nothing(pair):
    _, _, lm, params, batch = pair
    kernels.reset_launch_counts()
    loss, _ = loss_and_grads(lm, params, {k: torch.from_numpy(v) for k, v in batch.items()
                                          if k != "mask"})
    assert np.isfinite(float(loss))
    assert not any(kernels.launch_counts().values())


# --------------------------------------------------------------------- RWKV-6


def _rwkv_inputs(rng, Bn=2, H=2, T=16, N=8):
    r, k, v = (rng.normal(0, 1, (Bn, H, T, N)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 0.999, (Bn, H, T, N)).astype(np.float32)
    u = rng.normal(0, 0.5, (H, N)).astype(np.float32)
    s0 = rng.normal(0, 0.1, (Bn, H, N, N)).astype(np.float32)
    return r, k, v, w, u, s0


def test_rwkv6_function_matches_reference_vjp():
    """The port's chunked op (chunk 4, T 16: four chunks) against the
    reference's custom VJP: outputs, final state and all six cotangents."""
    rng = np.random.default_rng(3)
    xs = _rwkv_inputs(rng)
    do = rng.normal(0, 1, xs[0].shape).astype(np.float32)
    ds = rng.normal(0, 1, xs[5].shape).astype(np.float32)
    (ro, rs), vjp = jax.vjp(lambda *a: ref_rwkv_ops.rwkv6_scan(*a, chunk=4),
                            *map(jnp.asarray, xs))
    want = vjp((jnp.asarray(do), jnp.asarray(ds)))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    o, s = rk_ops.rwkv6_scan(*ts, chunk=4)
    got = torch.autograd.grad((o, s), ts, (torch.from_numpy(do), torch.from_numpy(ds)))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(ro), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(rs), atol=1e-5, rtol=1e-5)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def _plain_grads(fn, inputs, cots):
    ins = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*ins), ins, cots)


def test_flash_function_wiring_equals_plain_autograd():
    """`FlashAttention` with the plain forward in the kernel's place: its
    backward is autograd through the plain version, bit for bit."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 24, 16), generator=g)
    k, v = (torch.randn((2, 2, 24, 16), generator=g) for _ in range(2))
    do = torch.randn(q.shape, generator=g)
    scale = 0.3
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.FlashAttention.apply(*ins, True, scale, fa_ref.attention_ref)
    got = torch.autograd.grad(out, ins, do)
    want = _plain_grads(lambda a, b, c: fa_ref.attention_ref(a, b, c, scale=scale), (q, k, v), do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_function_wiring_equals_plain_autograd(with_h0):
    g = torch.Generator().manual_seed(1)
    la = -torch.rand((2, 20, 12), generator=g) * 2 - 1e-3
    gx = torch.randn((2, 20, 12), generator=g)
    h0 = torch.randn((2, 12), generator=g) if with_h0 else None
    cots = (torch.randn(gx.shape, generator=g), torch.randn((2, 12), generator=g))
    base = [la, gx] + ([h0] if with_h0 else [])
    ins = [t.clone().requires_grad_() for t in base]
    out = rg_ops.RGLRUScan.apply(ins[0], ins[1], ins[2] if with_h0 else None,
                                 rg_ref.rglru_scan_ref)
    got = torch.autograd.grad(out, ins, cots)
    want = _plain_grads(lambda *a: rg_ref.rglru_scan_ref(*a), base, cots)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("chunk", [16, 4])
def test_rwkv6_function_wiring_against_plain_autograd(chunk):
    """One chunk: bit for bit; four chunks: the carried state's and u's
    gradients sum in another order (within 1e-6)."""
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(x) for x in _rwkv_inputs(rng)]
    cots = (torch.randn(xs[0].shape, generator=torch.Generator().manual_seed(5)),
            torch.randn(xs[5].shape, generator=torch.Generator().manual_seed(6)))
    ins = [t.clone().requires_grad_() for t in xs]
    out = rk_ops.RWKV6Scan.apply(*ins, chunk, rk_ref.rwkv6_scan_ref)
    got = torch.autograd.grad(out, ins, cots)
    want = _plain_grads(rk_ref.rwkv6_scan_ref, xs, cots)
    for a, b in zip(got, want):
        if chunk == 16:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_ops_without_grad_keep_the_inference_path():
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(x) for x in _rwkv_inputs(rng)]
    state = xs[5].clone()
    o, s = rk_ops.rwkv6_scan(*xs[:5], state, state_out=state)
    assert s is state and o.grad_fn is None
    with pytest.raises(ValueError, match="state_out"):
        rk_ops.rwkv6_scan(xs[0].requires_grad_(), *xs[1:5], state, state_out=state)


def test_decode_attention_raises_under_grad():
    q = torch.zeros((1, 2, 16), requires_grad=True)
    cache = torch.zeros((1, 1, 8, 16))
    lengths = torch.ones(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no gradient"):
        dec_ops.decode_attention(q, cache, cache, lengths)
    with torch.no_grad():
        assert dec_ops.decode_attention(q, cache, cache, lengths).shape == (1, 2, 16)

"""repro_torch's LM serving path against the reference LM on the CPU.

At a small GQA configuration (qwen3-0.6b reduced 8x, with 4 query heads
over 2 KV heads restored) the reference's parameters are carried across
with `convert.lm_params_from_reference`, and both sides compute the same
function: forward logits, prefill + decode logits with a float32 cache and
with the default bf16 cache, and the tokens `serve_batch` generates.

Tolerances: float32 logits 1e-4 abs/rel (|logits| ~ 5; the matrix products
sum in another order in XLA and in PyTorch); with the bf16 cache 2e-3 (a
K/V value a last f32 bit apart may round to the neighbouring bf16 step),
and the bf16 cache itself within one bf16 step (2^-7 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.train import reduce_config as ref_reduce_config  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch import configs, convert, kernels  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM, layers  # noqa: E402

F32_TOL = 1e-4
BF16_CACHE_TOL = 2e-3
BF16_STEP = 2.0**-7


def small_gqa(cfg):
    return dataclasses.replace(serve.reduce_config(cfg, 8), n_heads=4, n_kv_heads=2)


@pytest.fixture(scope="module")
def pair():
    """(reference LM, reference params, port LM, port params)."""
    cfg = small_gqa(configs.get_config("qwen3-0.6b"))
    ref_cfg = dataclasses.replace(
        ref_reduce_config(ref_configs.get_config("qwen3-0.6b"), 8), n_heads=4, n_kv_heads=2
    )
    rlm, lm = RefLM(ref_cfg), LM(cfg)
    rp = rlm.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    # Non-zero norm scales, so the (1 + scale) path is exercised.
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    rp = jax.tree_util.tree_map_with_path(
        lambda path, x: x + 0.1 * jax.random.normal(next(keys), x.shape)
        if "norm" in jax.tree_util.keystr(path) else x,
        rp,
    )
    params = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, rp), lm)
    return rlm, rp, lm, params


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ref_configs.list_archs())
def test_configs_are_copies(arch):
    assert configs.list_archs() == ref_configs.list_archs()
    ours, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for factor in (1, 4, 8):
        assert dataclasses.asdict(serve.reduce_config(ours, factor)) == dataclasses.asdict(
            ref_reduce_config(ref, factor)
        )
    assert configs.SHAPES.keys() == ref_configs.SHAPES.keys()


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 4, 9, 16)).astype(np.float32)
    scale = rng.normal(0, 0.3, 16).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 1, 9))
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    _close(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           ref_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    for name in ("swiglu", "gelu"):
        _close(layers.activation_fn(name)(torch.from_numpy(x)),
               ref_layers.activation_fn(name)(jnp.asarray(x)), 1e-6)


def test_param_specs_and_init(pair):
    _, rp, lm, params = pair
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    got = layers.tree_map(lambda p: tuple(p.shape), lm.param_specs())
    assert got == want
    fresh = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    assert layers.tree_map(lambda t: tuple(t.shape), fresh) == want
    assert float(fresh["blocks"]["pos0_dense"]["attn"]["wq"].std()) == pytest.approx(
        lm.cfg.d_model**-0.5, rel=0.1
    )
    assert lm.init(torch.Generator().manual_seed(0))["embed"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="do not match"):
        convert.lm_params_from_reference({"embed": np.zeros((2, 2), np.float32)}, lm)


def test_forward_logits_match_reference(pair):
    rlm, rp, lm, params = pair
    toks = np.random.default_rng(1).integers(0, lm.cfg.vocab_size, size=(2, 40))
    want = rlm.forward(rp, {"tokens": jnp.asarray(toks)})
    got = lm.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 40, lm.cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_decode_match_reference(pair, cache_dtype):
    """Prefill(S) then 4 decode steps: last logits equal the reference's with
    the same cache dtype; with an f32 cache also the full forward's."""
    rlm, rp, lm, params = pair
    B, S, G = 2, 32, 4
    toks = np.random.default_rng(2).integers(0, lm.cfg.vocab_size, size=(B, S + G))
    f32 = cache_dtype == "float32"
    tol = F32_TOL if f32 else BF16_CACHE_TOL
    ref_dt = jnp.float32 if f32 else None
    ours_dt = torch.float32 if f32 else None
    rl, rc, rlen = rlm.prefill(rp, {"tokens": jnp.asarray(toks[:, :S])}, s_max=S + 8,
                               cache_dtype=ref_dt)
    ol, oc, olen = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])}, s_max=S + 8,
                              cache_dtype=ours_dt)
    k = oc["blocks"]["pos0_dense"]["k"]
    assert k.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert k.shape == (lm.cfg.n_layers, B, 2, S + 8, lm.cfg.head_dim)
    _close(ol, rl, tol)
    np.testing.assert_allclose(k.float().numpy(), np.asarray(rc["blocks"]["pos0_dense"]["k"],
                               np.float32), atol=F32_TOL, rtol=tol if f32 else BF16_STEP)
    full = lm.forward(params, {"tokens": torch.from_numpy(toks)}) if f32 else None
    for g in range(G):
        step = toks[:, S + g : S + g + 1]
        rl, rc, rlen = rlm.decode_step(rp, {"tokens": jnp.asarray(step)}, rc, rlen)
        ol, oc, olen = lm.decode_step(params, {"tokens": torch.from_numpy(step)}, oc, olen)
        _close(ol, rl, tol)
        if f32:
            _close(ol, full[:, S + g], 2e-3)  # the reference test's tolerance
    assert olen.dtype == torch.int32 and olen.tolist() == [S + G] * B


def test_serve_batch_greedy_tokens_equal_reference(pair):
    rlm, rp, lm, params = pair
    prompts = np.random.default_rng(3).integers(0, lm.cfg.vocab_size, size=(3, 24))
    want = ref_serve.serve_batch(rlm, rp, prompts, 12, make_mesh((1, 1), ("data", "model")))
    kernels.reset_launch_counts()
    got, logits = serve.serve_batch(lm, params, prompts, 12, return_logits=True)
    assert got.shape == (3, 12) and got.dtype == np.int32
    assert logits.shape == (3, 12, lm.cfg.vocab_size) and np.isfinite(logits).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, logits.argmax(-1))
    assert kernels.launch_counts()["flash_attention"] == 0  # CPU: plain versions


def test_serve_batch_temperature_is_seeded(pair):
    _, _, lm, params = pair
    prompts = np.random.default_rng(4).integers(0, lm.cfg.vocab_size, size=(2, 8))
    a = serve.serve_batch(lm, params, prompts, 6, temperature=1.0, seed=7)
    b = serve.serve_batch(lm, params, prompts, 6, temperature=1.0, seed=7)
    np.testing.assert_array_equal(a, b)
    assert ((a >= 0) & (a < lm.cfg.vocab_size)).all()


def test_serve_batch_timings(pair):
    _, _, lm, params = pair
    timings = {}
    prompts = np.zeros((1, 4), np.int64)
    serve.serve_batch(lm, params, prompts, 3, timings=timings)
    assert timings["decode_steps"] == 2 and timings["prefill_s"] > 0 and timings["decode_s"] > 0


def test_serve_main_on_cpu(capsys):
    tokens = serve.main(["--device", "cpu", "--reduce", "8", "--requests", "2",
                         "--prompt-len", "8", "--gen", "3"])
    assert tokens.shape == (2, 3)
    assert "device=cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e"])
def test_serve_batch_moe_tokens_equal_reference(arch):
    """The MoE archs through `serve_batch` unchanged, at reduce 16 (capacity
    factor 1.25: pairs are dropped in the prefill), on the reference's
    parameters carried across: the greedy tokens equal the reference's."""
    rlm = RefLM(ref_reduce_config(ref_configs.get_config(arch), 16))
    lm = LM(serve.reduce_config(configs.get_config(arch), 16))
    rp = rlm.init(jax.random.PRNGKey(2), dtype=jnp.float32)
    params = convert.lm_params_from_reference(jax.tree_util.tree_map(np.asarray, rp), lm)
    # 3 x 64 prompt tokens: 64 groups of 3, so an expert can overflow.
    prompts = np.random.default_rng(5).integers(0, lm.cfg.vocab_size, size=(3, 64))
    want = ref_serve.serve_batch(rlm, rp, prompts, 8, make_mesh((1, 1), ("data", "model")))
    np.testing.assert_array_equal(serve.serve_batch(lm, params, prompts, 8), want)

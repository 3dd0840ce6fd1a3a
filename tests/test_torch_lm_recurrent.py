"""repro_torch's recurrent serving paths against the reference LM on the CPU.

recurrentgemma-2b (rec + local_attn blocks) and rwkv6-7b (rwkv blocks) at
``reduce_config(..., 8)``: seeded parameters (every zero-initialised
gate, bias, shift ratio, bonus and norm scale drawn non-zero, so that
those paths are exercised) go to the reference as arrays and to the port
through `convert.lm_params_from_reference`, and both sides compute the same
function: parameter specs, forward logits, the prefill cache, prefill +
decode logits step by step (recurrentgemma's decode across the local
ring's wrap, from prompts shorter and longer than the reduced window of
128), and the tokens `serve_batch` generates. `local_attention` itself is
held to the reference below, at, above and off a multiple of its window.

Tolerances: float32 logits and states 1e-4 abs/rel for recurrentgemma
(the products sum in another order in XLA and in PyTorch) and 1e-3 for
rwkv6, whose group norm after the scan divides each 32-wide head of
outputs by their spread and enlarges such differences: the reference
against itself, with every parameter scaled by 1 + 1e-6 noise, moves its
logits by up to 9.8e-4 over a 150-token forward (the port: 6.2e-4). With
the default bf16 cache every cache entry is held within one bf16 step
(2^-7 abs/rel) after prefill: a value a last f32 bit apart may round to
the neighbouring bf16 step, and that step feeds the logits and the float32
states. The logits then within 2e-3 for recurrentgemma and 2e-2 for
rwkv6, whose decode re-rounds its token shifts, whole activation rows, to
bf16 at every step, so such steps compound through its state (the
reference against itself as above: up to 1.4e-2 over 8 steps, against
2e-4 with a float32 cache).
"""

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
from repro.models import attention as ref_attention  # noqa: E402
from repro_torch import configs, convert, kernels  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import LM, attention, layers  # noqa: E402

F32_TOL = {"recurrentgemma-2b": 1e-4, "rwkv6-7b": 1e-3}
BF16_CACHE_TOL = {"recurrentgemma-2b": 2e-3, "rwkv6-7b": 2e-2}
BF16_STEP = 2.0**-7
ARCHS = tuple(F32_TOL)


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference LM, reference params, port LM, port params) for one arch.

    The parameters are drawn with numpy from the specs (normal at the
    specs' scale; the zero-initialised ones at 0.1, so that those paths
    are exercised), handed to the reference as arrays and carried across
    to the port by `convert.lm_params_from_reference`."""
    arch = request.param
    rlm = RefLM(ref_reduce_config(ref_configs.get_config(arch), 8))
    lm = LM(serve.reduce_config(configs.get_config(arch), 8))
    rng = np.random.default_rng(0)

    def draw(p):
        if p.init == "ones":
            return np.ones(p.shape, np.float32)
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init == "zeros" else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    tree = layers.tree_map(draw, lm.param_specs())
    return rlm, jax.tree_util.tree_map(jnp.asarray, tree), lm, \
        convert.lm_params_from_reference(tree, lm)


def _tokens(lm, seed, B, S):
    return np.random.default_rng(seed).integers(0, lm.cfg.vocab_size, size=(B, S))


def test_param_specs_and_init(pair):
    _, rp, lm, params = pair
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    assert layers.tree_map(lambda p: tuple(p.shape), lm.param_specs()) == want
    assert layers.tree_map(lambda t: tuple(t.shape), params) == want
    fresh = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    assert layers.tree_map(lambda t: tuple(t.shape), fresh) == want
    kind = "rec" if "rec" in lm.cfg.pattern else "rwkv"
    assert f"pos0_{kind}" in params["blocks"]
    if lm.cfg.remainder:  # recurrentgemma: (rec, rec) after the stacked layers
        assert {"rem0_rec", "rem1_rec"} <= set(params)
    with pytest.raises(ValueError, match="do not match"):
        convert.lm_params_from_reference({"embed": np.zeros((2, 2), np.float32)}, lm)


def test_forward_logits_match_reference(pair):
    """For recurrentgemma S = 150 is above the reduced window (128): the
    chunk-pair form with padding (prefill below also runs S <= 128, causal
    attention)."""
    rlm, rp, lm, params = pair
    S = 150
    toks = _tokens(lm, S, 2, S)
    want = rlm.forward(rp, {"tokens": jnp.asarray(toks)})
    got = lm.forward(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, S, lm.cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, F32_TOL[lm.cfg.name])


def _cache_entries(cache):
    """{path: tensor or array} of every leaf of a (port or reference) cache."""
    out = {}
    for key, entry in cache["blocks"].items():
        out.update({f"blocks/{key}/{n}": t for n, t in entry.items()})
    for key, entry in cache.items():
        if key != "blocks":
            out.update({f"{key}/{n}": t for n, t in entry.items()})
    return out


@pytest.mark.parametrize("S,G,cache_dtype", [(124, 8, "float32"), (140, 6, "bfloat16")])
def test_prefill_decode_match_reference(pair, S, G, cache_dtype):
    """Prefill(S), then G decode steps: the cache after prefill, the logits
    of every step and, with a float32 cache, the cache after the last step
    equal the reference's with the same cache dtype.
    recurrentgemma's ring of 128 wraps during decode from S = 124 and is
    rolled at prefill from S = 140. The cache tensors are written in place:
    decode hands back the very tensors prefill made."""
    rlm, rp, lm, params = pair
    B = 2
    toks = _tokens(lm, S + G, B, S + G)
    f32 = cache_dtype == "float32"
    name = lm.cfg.name
    tol, entry_tol = (F32_TOL[name],) * 2 if f32 else (BF16_CACHE_TOL[name], BF16_STEP)
    rl, rc, rlen = rlm.prefill(rp, {"tokens": jnp.asarray(toks[:, :S])}, s_max=S + G,
                               cache_dtype=jnp.float32 if f32 else None)
    ol, oc, olen = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])}, s_max=S + G,
                              cache_dtype=torch.float32 if f32 else None)
    _close(ol, rl, tol)
    ours, ref = _cache_entries(oc), _cache_entries(rc)
    assert ours.keys() == ref.keys()
    for name, t in ours.items():
        assert tuple(t.shape) == ref[name].shape, name
        assert str(t.dtype).split(".")[-1] == str(ref[name].dtype), name
        _close(t, ref[name], entry_tol)
    ptrs = {name: t.data_ptr() for name, t in ours.items()}
    ref_decode = jax.jit(rlm.decode_step)
    for g in range(G):
        step = toks[:, S + g : S + g + 1]
        rl, rc, rlen = ref_decode(rp, {"tokens": jnp.asarray(step)}, rc, rlen)
        ol, oc, olen = lm.decode_step(params, {"tokens": torch.from_numpy(step)}, oc, olen)
        _close(ol, rl, tol)
    assert {n: t.data_ptr() for n, t in _cache_entries(oc).items()} == ptrs
    if f32:  # with bf16 entries the steps' roundings compound (see the top)
        for name, t in _cache_entries(oc).items():
            _close(t, _cache_entries(rc)[name], tol)
    assert olen.dtype == torch.int32 and olen.tolist() == [S + G] * B


def test_decode_matches_full_forward(pair):
    """With a float32 cache, prefill + decode logits equal the full
    forward's at the same positions (2e-3, the reference test's tolerance)."""
    _, _, lm, params = pair
    B, S, G = 2, 122, 7
    toks = _tokens(lm, 5, B, S + G)
    full = lm.forward(params, {"tokens": torch.from_numpy(toks)})
    ol, oc, olen = lm.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                              s_max=S + G, cache_dtype=torch.float32)
    _close(ol, full[:, S - 1], 2e-3)
    for g in range(G):
        step = torch.from_numpy(toks[:, S + g : S + g + 1])
        ol, oc, olen = lm.decode_step(params, {"tokens": step}, oc, olen)
        _close(ol, full[:, S + g], 2e-3)


def test_serve_batch_greedy_tokens_equal_reference(pair):
    rlm, rp, lm, params = pair
    prompts = _tokens(lm, 3, 2, 140)
    want = ref_serve.serve_batch(rlm, rp, prompts, 6, make_mesh((1, 1), ("data", "model")))
    kernels.reset_launch_counts()
    got, logits = serve.serve_batch(lm, params, prompts, 6, return_logits=True)
    assert got.shape == (2, 6) and got.dtype == np.int32
    assert logits.shape == (2, 6, lm.cfg.vocab_size) and np.isfinite(logits).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, logits.argmax(-1))
    assert not any(kernels.launch_counts().values())  # CPU: plain versions


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduce", [8, 4])
def test_serve_main_on_cpu(arch, reduce, capsys):
    tokens = serve.main(["--arch", arch, "--device", "cpu", "--reduce", str(reduce),
                         "--requests", "2", "--prompt-len", "6", "--gen", "3"])
    assert tokens.shape == (2, 3)
    assert f"arch={arch}" in capsys.readouterr().out


@pytest.mark.parametrize(
    "H,KVH,S,W",
    [(4, 2, 48, 64), (4, 1, 64, 64), (2, 1, 150, 64), (4, 2, 192, 64), (2, 2, 37, 16)],
)
def test_local_attention_matches_reference(H, KVH, S, W):
    """S below, at, above and at a multiple of the window, GQA and MQA."""
    rng = np.random.default_rng(S * 10 + W)
    B, D = 2, 32
    q = rng.normal(0, 1, (B, H, S, D)).astype(np.float32)
    k, v = (rng.normal(0, 1, (B, KVH, S, D)).astype(np.float32) for _ in range(2))
    got = attention.local_attention(*map(torch.from_numpy, (q, k, v)), W)
    want = ref_attention.local_attention(*map(jnp.asarray, (q, k, v)), W)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    _close(got, want, 2e-5)

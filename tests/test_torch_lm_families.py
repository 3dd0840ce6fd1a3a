"""Every architecture of ``configs`` on the port against the reference LM on
the CPU, the MoE and cross blocks piece by piece, and the launcher that
places LM jobs with NoMora (`launch/schedule.py`, `launch/mesh.py`).

All ten configs run at the reference smoke tests' ``reduced()`` shape
(tests/test_models_smoke.py: d_model 64, 4 heads of 16, two superblocks;
MoE dropless there). Parameters are drawn with numpy from the specs (the
zero-initialised ones at 0.1, so the (1 + scale) norms and the other
zero-started paths are exercised; the cross gates set to +-U(0.5, 1.5), so
that tanh(gate) is far from 0), handed to the reference as arrays and
carried across with `convert.lm_params_from_reference`. Inputs are seeded
numpy: tokens, frame embeddings for musicgen, image embeddings for the VLM.

Tolerances: float32 logits 1e-4 abs/rel (XLA and PyTorch sum the products
in other orders); with the default bf16 cache 2e-3 (a K/V value a last f32
bit apart may round to the neighbouring bf16 step). MoE dispatch at
capacity factor 1.25 is exact (buffers, kept mask, sorted experts, slots,
tokens: the same sort and the same float32 router products on these
sizes), the routing gates within 1e-6 relative (each softmax sums its
exponentials in another order), `moe_apply` and `cross_attention` within
1e-5. The scheduler's
placements are equal (tolerance 0) with ``fixed_algo_s = 0`` on both sides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_models_smoke import reduced  # noqa: E402  (the reference tests' shape)

from repro import configs as ref_configs  # noqa: E402
from repro.core import simulator as ref_simulator  # noqa: E402
from repro.launch import mesh as ref_mesh  # noqa: E402
from repro.launch import schedule as ref_schedule  # noqa: E402
from repro.models import LM as RefLM  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import blocks as ref_blocks  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import simulator  # noqa: E402
from repro_torch.launch import mesh, schedule  # noqa: E402
from repro_torch.models import LM, attention, blocks, layers  # noqa: E402

ARCHS = ref_configs.list_archs()
F32_TOL = 1e-4
BF16_CACHE_TOL = 2e-3
MOE_TOL = 1e-5
GATE_RTOL = 1e-6
B, S = 2, 32


def _draw(lm, seed=0):
    """numpy parameters for ``lm``'s specs, cross gates far from 0."""
    rng = np.random.default_rng(seed)

    def draw(p):
        fan_in = p.shape[-2] if len(p.shape) > 1 else p.shape[-1]
        scale = 0.1 if p.init == "zeros" else p.scale or fan_in**-0.5
        return (scale * rng.standard_normal(p.shape)).astype(np.float32)

    tree = layers.tree_map(draw, lm.param_specs())
    for key, p in list(tree["blocks"].items()) + [(k, v) for k, v in tree.items()
                                                  if k.startswith("rem")]:
        if "gate" in p.get("attn", {}):
            g = p["attn"]["gate"]
            p["attn"]["gate"] = (rng.choice([-1.0, 1.0], g.shape)
                                 * rng.uniform(0.5, 1.5, g.shape)).astype(np.float32)
    return tree


def _batch(cfg, rng, n):
    batch = {}
    if cfg.embed_inputs:
        batch["embeds"] = rng.normal(0, 1, (B, n, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    if cfg.n_image_tokens:
        batch["images"] = rng.normal(0, 1, (B, cfg.n_image_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def _ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _ours(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference LM, reference params, port LM, port params) of one arch."""
    arch = request.param
    rlm = RefLM(reduced(ref_configs.get_config(arch)))
    lm = LM(reduced(configs.get_config(arch)))
    tree = _draw(lm)
    return rlm, jax.tree_util.tree_map(jnp.asarray, tree), lm, \
        convert.lm_params_from_reference(tree, lm)


def test_forward_logits_match_reference(pair):
    rlm, rp, lm, params = pair
    batch = _batch(lm.cfg, np.random.default_rng(1), S)
    want = rlm.forward(rp, _ref(batch))
    got = lm.forward(params, _ours(batch))
    assert got.shape == (B, S, lm.cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want, F32_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_decode_match_reference(pair, cache_dtype):
    """Prefill(S) and one decode step: both logits against the reference's
    with the same cache dtype (the cross layers' image K/V included)."""
    rlm, rp, lm, params = pair
    f32 = cache_dtype == "float32"
    tol = F32_TOL if f32 else BF16_CACHE_TOL
    full = _batch(lm.cfg, np.random.default_rng(2), S + 1)
    name = "embeds" if lm.cfg.embed_inputs else "tokens"
    prompt = {name: full[name][:, :S]}
    if "images" in full:
        prompt["images"] = full["images"]
    step = {name: full[name][:, S:]}
    rl, rc, rlen = rlm.prefill(rp, _ref(prompt), s_max=S + 8,
                               cache_dtype=jnp.float32 if f32 else None)
    ol, oc, olen = lm.prefill(params, _ours(prompt), s_max=S + 8,
                              cache_dtype=torch.float32 if f32 else None)
    _close(ol, rl, tol)
    rl, _, _ = rlm.decode_step(rp, _ref(step), rc, rlen)
    ol, _, olen = lm.decode_step(params, _ours(step), oc, olen)
    _close(ol, rl, tol)
    assert olen.tolist() == [S + 1] * B


@pytest.mark.parametrize("kind", ["moe", "cross"])
def test_block_and_cache_specs_match_reference(kind):
    arch = "dbrx-132b" if kind == "moe" else "llama-3.2-vision-11b"
    cfg, rcfg = configs.get_config(arch), ref_configs.get_config(arch)
    want = jax.tree_util.tree_map(lambda p: (p.shape, p.axes, p.init, p.scale),
                                  ref_blocks.block_specs(kind, rcfg),
                                  is_leaf=lambda p: isinstance(p, ref_blocks.Param))
    got = layers.tree_map(lambda p: (p.shape, p.axes, p.init, p.scale),
                          blocks.block_specs(kind, cfg))
    assert got == want
    want_c = {k: (s, jnp.dtype(d).name) for k, (s, d) in
              ref_blocks.cache_spec(kind, rcfg, 3, 40).items()}
    got_c = {k: (s, str(d).replace("torch.", "")) for k, (s, d) in
             blocks.cache_spec(kind, cfg, 3, 40).items()}
    assert got_c == want_c
    if kind == "cross":
        assert got_c["k"][0] == (3, cfg.n_kv_heads, cfg.n_image_tokens, cfg.head_dim)


def test_cross_attention_matches_reference():
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (2, 6, 9, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 2, 13, 16)).astype(np.float32) for _ in range(2))
    want = ref_attention.cross_attention(*map(jnp.asarray, (q, k, v)))
    got = attention.cross_attention(*map(torch.from_numpy, (q, k, v)))
    assert got.shape == (2, 6, 9, 16) and got.dtype == torch.float32
    _close(got, want, MOE_TOL)


MOE_CASES = {"top1_shared": ("llama4-scout-17b-a16e", 1), "top2": ("dbrx-132b", 2)}


def _moe_case(case):
    """(reference cfg, port cfg, numpy moe params, numpy (4, 128, D) input):
    capacity factor 1.25, inputs with a common offset (so the router
    favours some experts and pairs are dropped) and three zero tokens (all
    gates tie: top-k takes the lowest experts)."""
    arch, k = MOE_CASES[case]
    over = dict(experts_per_token=k, moe_capacity_factor=1.25)
    rcfg = dataclasses.replace(reduced(ref_configs.get_config(arch)), **over)
    cfg = dataclasses.replace(reduced(configs.get_config(arch)), **over)
    rng = np.random.default_rng(4 + k)
    tree = layers.tree_map(
        lambda p: (rng.standard_normal(p.shape) * p.shape[-2] ** -0.5).astype(np.float32),
        blocks._moe_specs(cfg))
    x = (rng.normal(0, 1, (4, 128, cfg.d_model)) + 0.3).astype(np.float32)
    x[0, :3] = 0.0
    return rcfg, cfg, tree, x


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_dispatch_equals_reference_with_drops(case):
    rcfg, cfg, tree, x = _moe_case(case)
    G = blocks._largest_divisor_leq(x.shape[0] * x.shape[1], blocks.MOE_GROUPS)
    assert G == ref_blocks._largest_divisor_leq(x.shape[0] * x.shape[1], 64) == 64
    xt = x.reshape(G, -1, cfg.d_model)
    rbuf, rmeta = ref_blocks._moe_dispatch(rcfg, jnp.asarray(tree["router"]), jnp.asarray(xt))
    buf, meta = blocks._moe_dispatch(cfg, torch.from_numpy(tree["router"]), torch.from_numpy(xt))
    keep = meta[2].numpy()
    assert 0 < (~keep).sum() < keep.size  # pairs were dropped, not all
    assert buf.shape == rbuf.shape
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    e_sorted, pos_c, keep, g_sorted, tok_sorted = meta[:5]
    for got, want in zip((e_sorted, pos_c, keep, tok_sorted), rmeta[:3] + rmeta[4:5]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The gates come from a softmax whose sum runs in another order.
    np.testing.assert_allclose(g_sorted.numpy(), np.asarray(rmeta[3]), rtol=GATE_RTOL, atol=0)
    # The zero token's pairs went to the lowest experts (ties).
    tok0 = (meta[4][0] == 0).numpy()
    assert sorted(meta[0][0].numpy()[tok0].tolist()) == list(range(cfg.experts_per_token))


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_reference_with_drops(case):
    rcfg, cfg, tree, x = _moe_case(case)
    want = ref_blocks.moe_apply(rcfg, jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    params = layers.tree_map(torch.from_numpy, tree)
    got = blocks.moe_apply(cfg, params, torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got, want, MOE_TOL)
    assert torch.equal(got, blocks.moe_apply(cfg, params, torch.from_numpy(x)))


def test_vlm_batch_without_images_raises():
    lm = LM(reduced(configs.get_config("llama-3.2-vision-11b")))
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match=r'batch\["images"\]'):
        lm.forward(params, tokens)
    with pytest.raises(ValueError, match=r'batch\["images"\]'):
        lm.prefill(params, tokens, s_max=8)


def _zero_algo_s(monkeypatch):
    monkeypatch.setattr(ref_schedule.simulator, "SimConfig",
                        functools.partial(ref_simulator.SimConfig, fixed_algo_s=0.0))
    monkeypatch.setattr(schedule.simulator, "SimConfig",
                        functools.partial(simulator.SimConfig, fixed_algo_s=0.0))


def test_schedule_ml_jobs_equals_reference(monkeypatch, capsys):
    _zero_algo_s(monkeypatch)
    assert schedule.ARCH_KIND == ref_schedule.ARCH_KIND
    want, want_m = ref_schedule.schedule_ml_jobs(64, 6, 120)
    got, got_m = schedule.schedule_ml_jobs(64, 6, 120, device="cpu")
    assert len(got) == 6 and got == want
    for f in ("tasks_placed", "tasks_migrated", "rounds", "placement_latency_s",
              "response_time_s", "per_job_perf", "migrated_pct_per_round"):
        assert getattr(got_m, f) == getattr(want_m, f), f
    np.testing.assert_equal(got_m.summary(), want_m.summary())
    placements, _ = schedule.main(["--device", "cpu", "--machines", "64", "--jobs", "6",
                                   "--duration", "120"])
    assert placements == want
    assert "device=cpu jobs placed: 6" in capsys.readouterr().out


@pytest.mark.parametrize("seed", range(3))
def test_nomora_ordered_devices_equals_reference(seed):
    """Ties in latency (and several devices on one host) keep device order."""
    rng = np.random.default_rng(seed)
    n_hosts, n_dev = 5, 12
    lat = rng.choice([50.0, 80.0, 120.0], n_hosts).tolist()
    host_of = rng.integers(0, n_hosts, n_dev).tolist()
    devices = [f"dev{i}" for i in range(n_dev)]
    want = ref_mesh.nomora_ordered_devices(host_of, lat, devices)
    assert mesh.nomora_ordered_devices(host_of, lat, devices) == want
    assert mesh.nomora_ordered_devices(host_of, np.asarray(lat), tuple(devices)) == want

"""Nothing moved: the weights' layout, the counts behind the roofline and
`mfu` metrics, the weights the seed makes, and the reference's readings,
held to literals that the benchmark's code gave before the layer kinds
were split into files of their own (`harness/kinds/`,
`reference/kinds/`).

Counts are at the configurations' published widths (the shapes the cells
run); weights and readings at `pb_tiny.shrink`'s widths on the CPU, on
`pb_tiny.SEED`. Floats are compared bit for bit: hex floats, or the
sha256 of a tensor's bytes.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import pb_tiny
from harness import counts, spec, traffic as tr, weights
from reference import lm as ref

CPU = torch.device("cpu")


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def _hex(values):
    return [float(v).hex() for v in values]


def _digest(norms):
    return hashlib.sha256("\n".join(f"{k}={float(v).hex()}"
                                     for k, v in sorted(norms.items())).encode()).hexdigest()


def _counts():
    q = spec.load_config("qwen3-0.6b")["arch"]
    d = spec.load_config("dbrx-132b")["arch"]
    c = {"qwen3.product_params": counts.product_params(q),
         "dbrx.product_params": counts.product_params(d),
         "qwen3.train_step_flops.4x4096": counts.train_step_flops(q, 4, 4096)}
    for a, name, B, lens, steps in ((q, "qwen3", 4, (2048, 4096, 8192), (0, 14)),
                                    (d, "dbrx", 32, (128, 256, 512), (0, 254))):
        for P in lens:
            c[f"{name}.prefill_flops.{B}x{P}"] = counts.prefill_flops(a, B, P)
            for j in steps:
                ctx = [P + j + 1] * B
                c[f"{name}.decode_step_flops.{B}x{P}+{j}"] = counts.decode_step_flops(a, ctx)
                c[f"{name}.decode_step_bytes.{B}x{P}+{j}"] = counts.decode_step_bytes(a, ctx)
    c["dbrx.experts_bytes"] = counts.F32 * d["n_layers"] * d["n_experts"] * counts.expert_params(d)
    return c


@pytest.mark.parametrize("config", ["qwen3-0.6b", "dbrx-132b"])
def test_layout_is_unchanged(config):
    got = [(".".join(p), s, float(sc).hex())
           for p, s, sc in weights.layout(spec.load_config(config)["arch"])]
    assert got == LAYOUT[config]


def test_counts_are_unchanged_and_exact():
    got = _counts()
    assert set(got) == set(COUNTS)
    for k, v in got.items():
        assert v == COUNTS[k] and float(v).is_integer(), (k, v, COUNTS[k])


@pytest.mark.parametrize("cell", pb_tiny.CELLS)
def test_weights_from_the_seed_are_unchanged(cell):
    a = pb_tiny.shrink(spec.load_cell(cell)).arch
    params = weights.make(a, pb_tiny.SEED, CPU)
    flat = []
    for path, _, _ in weights.layout(a):
        t = params
        for k in path:
            t = t[k]
        flat.append(t.reshape(-1))
    assert _sha(torch.cat(flat)) == CELLS[cell]["weights_sha256"]


def test_training_reference_is_unchanged():
    import run as bench
    from harness.bench import Run

    name = "qwen3-0.6b.train-4k"
    cell = pb_tiny.shrink(spec.load_cell(name))
    drv = bench.load_file(bench.HERE / "drivers" / "train.py", "pb_frozen_train")
    run = Run(cell, pb_tiny.SEED, 0.0, False, CPU, 0.0)
    want = CELLS[name]
    got = drv.reference_readings(run)
    assert _hex(got["loss"]) == want["loss"]
    assert _digest(got["grad"]) == want["grad_sha256"]
    assert _digest(got["change"]) == want["change_sha256"]
    half = drv.reference_readings(run, "f32", slice(0, cell.traffic["batch"] // 2))
    assert _hex(half["loss"]) == want["half_loss"]
    assert _hex(drv.reference_readings(run, "tf32")["loss"]) == want["tf32_loss"]


def _shas(ts):
    return None if ts is None else [_sha(t) for t in ts]


@pytest.mark.parametrize("cell", ["qwen3-0.6b.prefill-long", "dbrx-132b.chat"])
def test_serving_reference_is_unchanged(cell):
    """The greedy server (the control's place) and the reference over a
    served sequence, following the greedy server's routes, in f32 and TF32."""
    c = pb_tiny.shrink(spec.load_cell(cell))
    a, t = c.arch, c.traffic
    params = weights.make(a, pb_tiny.SEED, CPU)
    for i in (0, 1):
        prompt = torch.as_tensor(np.asarray(tr.prompts(pb_tiny.SEED, i, t, a["vocab_size"])[1]),
                                 dtype=torch.long)
        P = prompt.shape[0]
        want = CELLS[cell][f"P{P}"]
        for mode in ("f32", "tf32"):
            with torch.no_grad(), ref.precision(mode):
                toks, lg, routes = ref.serve_greedy(a, params, prompt, t["gen_tokens"],
                                                    t["batch"], c.config)
                seq = torch.cat([prompt, toks[:-1]])
                whole, rlog, ch = ref.serve(a, params, seq, P, t["batch"], c.config, routes)
            got = {f"greedy_{mode}_tokens": toks.tolist(),
                   f"greedy_{mode}_logits_sha256": _sha(lg),
                   f"greedy_{mode}_chosen": _hex(lg.gather(1, toks[:, None])[:, 0]),
                   f"greedy_{mode}_routes_sha256": _shas(routes),
                   f"serve_{mode}_logits_sha256": _sha(whole),
                   f"serve_{mode}_chosen": _hex(whole.gather(1, toks[:, None])[:, 0]),
                   f"serve_{mode}_router_sha256": _shas(rlog),
                   f"serve_{mode}_choices_sha256": _shas(ch)}
            assert got == {k: want[k] for k in got}, (cell, P, mode)


# The parent's outputs, as the benchmark's code gave them before the split.

LAYOUT = {
    'qwen3-0.6b': [
        ('embed', (151936, 1024), '0x1.0000000000000p-5'),
        ('blocks.pos0_dense.norm_attn', (28, 1024), '0x1.999999999999ap-4'),
        ('blocks.pos0_dense.attn.wq', (28, 1024, 2048), '0x1.0000000000000p-5'),
        ('blocks.pos0_dense.attn.wk', (28, 1024, 1024), '0x1.0000000000000p-5'),
        ('blocks.pos0_dense.attn.wv', (28, 1024, 1024), '0x1.0000000000000p-5'),
        ('blocks.pos0_dense.attn.wo', (28, 2048, 1024), '0x1.6a09e667f3bcdp-6'),
        ('blocks.pos0_dense.attn.q_norm', (28, 128), '0x1.999999999999ap-4'),
        ('blocks.pos0_dense.attn.k_norm', (28, 128), '0x1.999999999999ap-4'),
        ('blocks.pos0_dense.norm_ffn', (28, 1024), '0x1.999999999999ap-4'),
        ('blocks.pos0_dense.ffn.w1', (28, 1024, 3072), '0x1.0000000000000p-5'),
        ('blocks.pos0_dense.ffn.w2', (28, 3072, 1024), '0x1.279a74590331cp-6'),
        ('blocks.pos0_dense.ffn.w3', (28, 1024, 3072), '0x1.0000000000000p-5'),
        ('final_norm', (1024,), '0x1.999999999999ap-4'),
    ],
    'dbrx-132b': [
        ('embed', (100352, 6144), '0x1.a20bd700c2c3ep-7'),
        ('blocks.pos0_moe.norm_attn', (4, 6144), '0x1.999999999999ap-4'),
        ('blocks.pos0_moe.attn.wq', (4, 6144, 6144), '0x1.a20bd700c2c3ep-7'),
        ('blocks.pos0_moe.attn.wk', (4, 6144, 1024), '0x1.a20bd700c2c3ep-7'),
        ('blocks.pos0_moe.attn.wv', (4, 6144, 1024), '0x1.a20bd700c2c3ep-7'),
        ('blocks.pos0_moe.attn.wo', (4, 6144, 6144), '0x1.a20bd700c2c3ep-7'),
        ('blocks.pos0_moe.norm_ffn', (4, 6144), '0x1.999999999999ap-4'),
        ('blocks.pos0_moe.moe.router', (4, 6144, 16), '0x1.a20bd700c2c3ep-7'),
        ('blocks.pos0_moe.moe.we1', (4, 16, 6144, 10752), '0x1.a20bd700c2c3ep-7'),
        ('blocks.pos0_moe.moe.we2', (4, 16, 10752, 6144), '0x1.3c03650e00e03p-7'),
        ('blocks.pos0_moe.moe.we3', (4, 16, 6144, 10752), '0x1.a20bd700c2c3ep-7'),
        ('final_norm', (6144,), '0x1.999999999999ap-4'),
        ('head', (6144, 100352), '0x1.a20bd700c2c3ep-7'),
    ],
}

COUNTS = {
    'qwen3.product_params': 595984384,
    'dbrx.product_params': 4140171264,
    'qwen3.train_step_flops.4x4096': 81683030212608,
    'qwen3.prefill_flops.4x2048': 9141874589696,
    'qwen3.decode_step_flops.4x2048+0': 6647840768,
    'qwen3.decode_step_bytes.4x2048+0': 3327088640,
    'qwen3.decode_step_flops.4x2048+14': 6660685824,
    'qwen3.decode_step_bytes.4x2048+14': 3333511168,
    'qwen3.prefill_flops.4x4096': 22130795216896,
    'qwen3.decode_step_flops.4x4096+0': 8526888960,
    'qwen3.decode_step_bytes.4x4096+0': 4266612736,
    'qwen3.decode_step_flops.4x4096+14': 8539734016,
    'qwen3.decode_step_bytes.4x4096+14': 4273035264,
    'qwen3.prefill_flops.4x8192': 59653508562944,
    'qwen3.decode_step_flops.4x8192+0': 12284985344,
    'qwen3.decode_step_bytes.4x8192+0': 6145660928,
    'qwen3.decode_step_flops.4x8192+14': 12297830400,
    'qwen3.decode_step_bytes.4x8192+14': 6152083456,
    'dbrx.prefill_flops.32x128': 28930832596992,
    'dbrx.decode_step_flops.32x128+0': 265376759808,
    'dbrx.decode_step_bytes.32x128+0': 54693421056,
    'dbrx.decode_step_flops.32x128+254': 266175774720,
    'dbrx.decode_step_bytes.32x128+254': 54826590208,
    'dbrx.prefill_flops.32x256': 57873744789504,
    'dbrx.decode_step_flops.32x256+0': 265779412992,
    'dbrx.decode_step_bytes.32x256+0': 54760529920,
    'dbrx.decode_step_flops.32x256+254': 266578427904,
    'dbrx.decode_step_bytes.32x256+254': 54893699072,
    'dbrx.prefill_flops.32x512': 115914187997184,
    'dbrx.decode_step_flops.32x512+0': 266584719360,
    'dbrx.decode_step_bytes.32x512+0': 54894747648,
    'dbrx.decode_step_flops.32x512+254': 267383734272,
    'dbrx.decode_step_bytes.32x512+254': 55027916800,
    'dbrx.experts_bytes': 50734301184,
}

CELLS = {
    'qwen3-0.6b.train-4k': {
        'weights_sha256': '0cd53ce8691699eabf0cda98e23f35149189316263a8a34ffdf7d772f1d20d1e',
        'loss': [
            '0x1.ac426a0000000p+2',
            '0x1.a650b20000000p+2',
            '0x1.b546ce0000000p+2',
        ],
        'grad_sha256': 'c7850ef7029d415ee85593d253abddb644b1edf05ad380fccc3d38597dfd3364',
        'change_sha256': '85e8571ecbd3f609259afd19c27076dadd896f7f88c07667466032058553afdb',
        'half_loss': [
            '0x1.b905000000000p+2',
            '0x1.a5b83c0000000p+2',
            '0x1.b530a60000000p+2',
        ],
        'tf32_loss': [
            '0x1.ac3ed00000000p+2',
            '0x1.a652780000000p+2',
            '0x1.b547b00000000p+2',
        ],
    },
    'qwen3-0.6b.prefill-long': {
        'weights_sha256': '0cd53ce8691699eabf0cda98e23f35149189316263a8a34ffdf7d772f1d20d1e',
        'P16': {
            'greedy_f32_tokens': [0, 488, 217, 76, 137, 145],
            'greedy_f32_logits_sha256': 'c2323f5fe91fb9f49dfe29669d08ff4cd2a3b80518c78b50b318929b0b2c4f35',
            'greedy_f32_chosen': [
                '0x1.5854b80000000p+1',
                '0x1.4f4a2c0000000p+1',
                '0x1.604d3c0000000p+1',
                '0x1.9706900000000p+1',
                '0x1.80367c0000000p+1',
                '0x1.9018a40000000p+1',
            ],
            'greedy_f32_routes_sha256': None,
            'serve_f32_logits_sha256': '0a5849d95b159376da77360e9b9794eb8870954c72bf5d56e583aabe34ccb7a3',
            'serve_f32_chosen': [
                '0x1.5854b60000000p+1',
                '0x1.4f4a2e0000000p+1',
                '0x1.604d420000000p+1',
                '0x1.97068e0000000p+1',
                '0x1.8036760000000p+1',
                '0x1.9018a80000000p+1',
            ],
            'serve_f32_router_sha256': None,
            'serve_f32_choices_sha256': None,
            'greedy_tf32_tokens': [0, 488, 217, 76, 137, 145],
            'greedy_tf32_logits_sha256': 'b20dc219e3fdf266ba50d29683c6b2e8f06fcf84ab95790aa326cc835b3facaa',
            'greedy_tf32_chosen': [
                '0x1.5839280000000p+1',
                '0x1.4fbc480000000p+1',
                '0x1.60a0900000000p+1',
                '0x1.9702580000000p+1',
                '0x1.80140e0000000p+1',
                '0x1.9038ae0000000p+1',
            ],
            'greedy_tf32_routes_sha256': None,
            'serve_tf32_logits_sha256': '22dddd5ca960fb2f22e78bd55f095b10c33a858736a26a86d930cce19215559d',
            'serve_tf32_chosen': [
                '0x1.5839260000000p+1',
                '0x1.4fbc3e0000000p+1',
                '0x1.60a08c0000000p+1',
                '0x1.9708820000000p+1',
                '0x1.80140c0000000p+1',
                '0x1.9038ae0000000p+1',
            ],
            'serve_tf32_router_sha256': None,
            'serve_tf32_choices_sha256': None,
        },
        'P256': {
            'greedy_f32_tokens': [422, 455, 499, 487, 87, 77],
            'greedy_f32_logits_sha256': '12cae873ca61696348c22f871e0fe69be55ad3c657de910e150aa699cb411c53',
            'greedy_f32_chosen': [
                '0x1.5483be0000000p+1',
                '0x1.42b5200000000p+1',
                '0x1.54ae2a0000000p+1',
                '0x1.4baeb60000000p+1',
                '0x1.7119840000000p+1',
                '0x1.50829c0000000p+1',
            ],
            'greedy_f32_routes_sha256': None,
            'serve_f32_logits_sha256': 'ba6bbd55a5ee46d8375ca9c01f74c1df87932a11a7139cbf05c4527ced7acb75',
            'serve_f32_chosen': [
                '0x1.5483c00000000p+1',
                '0x1.42b52e0000000p+1',
                '0x1.54ae280000000p+1',
                '0x1.4baeb60000000p+1',
                '0x1.7119840000000p+1',
                '0x1.5082a00000000p+1',
            ],
            'serve_f32_router_sha256': None,
            'serve_f32_choices_sha256': None,
            'greedy_tf32_tokens': [422, 455, 499, 487, 87, 77],
            'greedy_tf32_logits_sha256': '10af05041bab3bfc8470af3905c8e89fb4fdca206af7e062116f7000796a5745',
            'greedy_tf32_chosen': [
                '0x1.5495280000000p+1',
                '0x1.42b3200000000p+1',
                '0x1.5490ba0000000p+1',
                '0x1.4b634a0000000p+1',
                '0x1.713f5a0000000p+1',
                '0x1.5086f80000000p+1',
            ],
            'greedy_tf32_routes_sha256': None,
            'serve_tf32_logits_sha256': '3cc9a8fe2ce2cd5d1a6fe48c9e66e207af06a6c665035799de596985d1fa4c6e',
            'serve_tf32_chosen': [
                '0x1.54952e0000000p+1',
                '0x1.42b2ea0000000p+1',
                '0x1.54943a0000000p+1',
                '0x1.4b5c720000000p+1',
                '0x1.713f5c0000000p+1',
                '0x1.5088200000000p+1',
            ],
            'serve_tf32_router_sha256': None,
            'serve_tf32_choices_sha256': None,
        },
    },
    'dbrx-132b.chat': {
        'weights_sha256': 'f335e84a3d12bb5d1e168ac9347a5da618fe41c3ad734b1dd80f6243f253a1c1',
        'P16': {
            'greedy_f32_tokens': [7, 383, 16, 1, 22, 375],
            'greedy_f32_logits_sha256': '29bfc5a524e12ff2b34bcc173cc42fad34485abed6af4abba4ddd7bf71254e6e',
            'greedy_f32_chosen': [
                '0x1.697fe20000000p+1',
                '0x1.a7dc340000000p+1',
                '0x1.ae0dfc0000000p+1',
                '0x1.db7d8e0000000p+1',
                '0x1.9105680000000p+1',
                '0x1.8baf860000000p+1',
            ],
            'greedy_f32_routes_sha256': [
                '4ae297b1c89da63bc3a0367d10689983beea8dae8f29552f8c6cb7a0fb655364',
                '0ed8f2db1a932b2294e02af5f8da1741d6ab5baa2e636538698e4f3de2465e1b',
            ],
            'serve_f32_logits_sha256': '6592d5187e5a29ca3c543d8f5a46db0a778617fa3c86e9e1aaa1adb8e009c665',
            'serve_f32_chosen': [
                '0x1.697fe20000000p+1',
                '0x1.a7dc340000000p+1',
                '0x1.ae0dfe0000000p+1',
                '0x1.db7c660000000p+1',
                '0x1.9104160000000p+1',
                '0x1.8baf440000000p+1',
            ],
            'serve_f32_router_sha256': [
                'db0cd34c1fc1defe82c2eba264029a6f11393dfcc5a3a761953bd74352054e25',
                '8c5919b1f4039be65fe02beb027b9ffd99e8879ddca1d37d25267910ebab5701',
            ],
            'serve_f32_choices_sha256': [
                '4ae297b1c89da63bc3a0367d10689983beea8dae8f29552f8c6cb7a0fb655364',
                '0ed8f2db1a932b2294e02af5f8da1741d6ab5baa2e636538698e4f3de2465e1b',
            ],
            'greedy_tf32_tokens': [7, 383, 16, 1, 22, 375],
            'greedy_tf32_logits_sha256': 'd4dd482895066adae467fe96f08186f6e0ceee2848d9708b9bfa824c1feea389',
            'greedy_tf32_chosen': [
                '0x1.6994860000000p+1',
                '0x1.a787340000000p+1',
                '0x1.ae02e40000000p+1',
                '0x1.dbd2760000000p+1',
                '0x1.9171920000000p+1',
                '0x1.8b462a0000000p+1',
            ],
            'greedy_tf32_routes_sha256': [
                '4ae297b1c89da63bc3a0367d10689983beea8dae8f29552f8c6cb7a0fb655364',
                '0ed8f2db1a932b2294e02af5f8da1741d6ab5baa2e636538698e4f3de2465e1b',
            ],
            'serve_tf32_logits_sha256': '03f5c88bdca43a72ff8b556cd89b80649a80fde58a63d630720ebbab05b28fd9',
            'serve_tf32_chosen': [
                '0x1.6994880000000p+1',
                '0x1.a787360000000p+1',
                '0x1.ae02ec0000000p+1',
                '0x1.dbd27a0000000p+1',
                '0x1.9168a40000000p+1',
                '0x1.8b462a0000000p+1',
            ],
            'serve_tf32_router_sha256': [
                '63b238915262a1f0d3d0ddfbf45a5ba294a924fa141a36408e9026cd9d004b0e',
                'a809e0a7350fa8c9720e642d3375e9f57f15b7086d8fa7621318411e8b398003',
            ],
            'serve_tf32_choices_sha256': [
                '4ae297b1c89da63bc3a0367d10689983beea8dae8f29552f8c6cb7a0fb655364',
                '0ed8f2db1a932b2294e02af5f8da1741d6ab5baa2e636538698e4f3de2465e1b',
            ],
        },
        'P256': {
            'greedy_f32_tokens': [468, 70, 225, 225, 225, 225],
            'greedy_f32_logits_sha256': '3db929456a8e228a71459903f687d49a408f5fec7da5ca5012eb0fec60169255',
            'greedy_f32_chosen': [
                '0x1.cec6240000000p+1',
                '0x1.6881880000000p+1',
                '0x1.59ad0a0000000p+1',
                '0x1.a608b60000000p+1',
                '0x1.cd4dfc0000000p+1',
                '0x1.d6e6980000000p+1',
            ],
            'greedy_f32_routes_sha256': [
                '8ba2c2ff880336df589816fd403ab1024c19c7b36d61e04912d0bd85adcdd18c',
                '183b739571b19db690e60170cfe2f35837d69bdd5a2dffd75569d0d22221a53a',
            ],
            'serve_f32_logits_sha256': 'ea8d06818d3e5ee640503a9bfa978cec3b85b2f09c0b8801e3f763b2e5c3db2b',
            'serve_f32_chosen': [
                '0x1.cec6260000000p+1',
                '0x1.68819c0000000p+1',
                '0x1.59ad040000000p+1',
                '0x1.a608b20000000p+1',
                '0x1.cd4dfa0000000p+1',
                '0x1.d6e69c0000000p+1',
            ],
            'serve_f32_router_sha256': [
                'd960ee9ea8257424a24b76af9fde7d8352083b00f572bc780c28a67060c27b76',
                'b604d1bed94f247eaf9850998b426ef511be73d351a34d7b534509143480ca10',
            ],
            'serve_f32_choices_sha256': [
                '8ba2c2ff880336df589816fd403ab1024c19c7b36d61e04912d0bd85adcdd18c',
                '183b739571b19db690e60170cfe2f35837d69bdd5a2dffd75569d0d22221a53a',
            ],
            'greedy_tf32_tokens': [468, 70, 225, 225, 225, 225],
            'greedy_tf32_logits_sha256': 'b9b5a684120eb98659fb59a21389e4af1ecbbea73546dd08f946ccbc39e2f517',
            'greedy_tf32_chosen': [
                '0x1.cebb6a0000000p+1',
                '0x1.68785c0000000p+1',
                '0x1.593ad80000000p+1',
                '0x1.a607ca0000000p+1',
                '0x1.cd40000000000p+1',
                '0x1.d706f80000000p+1',
            ],
            'greedy_tf32_routes_sha256': [
                '8ba2c2ff880336df589816fd403ab1024c19c7b36d61e04912d0bd85adcdd18c',
                '183b739571b19db690e60170cfe2f35837d69bdd5a2dffd75569d0d22221a53a',
            ],
            'serve_tf32_logits_sha256': 'dc3011a454a34de7b622b8b9998fb8a830f25089caf3334c8e329c030bf25ba6',
            'serve_tf32_chosen': [
                '0x1.cebb6a0000000p+1',
                '0x1.6874f00000000p+1',
                '0x1.593ada0000000p+1',
                '0x1.a607c80000000p+1',
                '0x1.cd3ffe0000000p+1',
                '0x1.d706fc0000000p+1',
            ],
            'serve_tf32_router_sha256': [
                '9ae0893f696a057edf2f7cc59858ca8ebcdba5cfcb7d7969600e5de9d1e087aa',
                '32206b47e0eed5a5fb3a40913692be69aab9a9fae863646fced730150149687d',
            ],
            'serve_tf32_choices_sha256': [
                '8ba2c2ff880336df589816fd403ab1024c19c7b36d61e04912d0bd85adcdd18c',
                '183b739571b19db690e60170cfe2f35837d69bdd5a2dffd75569d0d22221a53a',
            ],
        },
    },
}

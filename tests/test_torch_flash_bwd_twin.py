"""A CPU twin of the CUDA flash-attention backward's arithmetic.

``csrc/flash_attention_bwd.cu`` recomputes the probabilities from the
forward's log-sum-exp L and takes every product on the tensor cores in
3xTF32 (big = rna(x); small = x - big, whose low 13 bits the tensor cores
drop; small*small dropped; bf16 / f16 values are exact in TF32 and take
fewer passes).
``twin_backward`` runs its three launches on the CPU with that arithmetic:
Δ = rowsum(dO ∘ O); the dQ kernel's query tiles of 16*QW rows walking key
tiles of BK (S = Q K^T, dP = dO V^T, dS = P ∘ (dP - Δ), dQ += dS K); and the
dK/dV kernel's key tiles of 16*KW walking the G query heads of their KV
head and, in each, the query tiles of BQ rows from the first at or after
the tile's first key (S^T, P^T, dV += P^T dO, dP^T, dS^T, dK += dS^T Q),
every tile constant read from the kernel's `Tile` table. The products with
P or dS are summed JG 8-row blocks at a time before they join the f32
sums, as the kernels' fresh fragments do. A tile that a warp skips adds
exact zeros here. The order in which register fragments take
the terms of one product only permutes a sum, which the matrix products
here cannot tell from another (tests/test_torch_cuda.py checks the
fragments on the card).

The twin is held to autograd through the port's `attention_ref` on the
same seeded inputs within GRAD_TOL of each gradient's largest magnitude;
one TF32 pass misses that tolerance on the same inputs.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from test_torch_flash_tf32x3 import SMEM_PER_BLOCK, tf32_rna, twin_attention  # noqa: E402

CU = Path(kernel_cuda.__file__).resolve().parents[2] / "csrc" / "flash_attention_bwd.cu"
# |twin - autograd| <= GRAD_TOL * max|autograd gradient|, per gradient. In
# f32 the two differ by the order of their sums and by P recomputed from L
# (a few 1e-7 of the largest gradient at these sizes); one TF32 pass rounds
# every operand to 2^-11 and lands near 1e-4.
GRAD_TOL = 1e-5


def split(x: torch.Tensor):
    """The kernel's split: big rounded to TF32 (to nearest, ties away from
    zero), small = x - big with its low 13 bits dropped, as the tensor cores
    read it."""
    big = tf32_rna(x)
    return big, ((x - big).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tc_product(a, b, a_exact: bool, b_exact: bool, passes: int = 3) -> torch.Tensor:
    """a @ b as the kernel's TF32 passes take it (f32 sums); ``passes=1``
    is a single TF32 product, for comparison."""
    if passes == 1:
        return tf32_rna(a) @ tf32_rna(b)
    a_big, a_small = (a, None) if a_exact else split(a.float())
    b_big, b_small = (b, None) if b_exact else split(b.float())
    out = torch.zeros(a.shape[0], b.shape[1])
    if a_small is not None:
        out = out + a_small @ b_big
    if b_small is not None:
        out = out + a_big @ b_small
    return out + a_big @ b_big


def bwd_tiles() -> dict:
    """{head_dim: {KW, BQ, QW, BK, JG, kTwoPass}} from the kernel's `Tile` table."""
    keys = ("KW", "BQ", "QW", "BK", "JG", "kTwoPass")
    found = re.findall(r"struct Tile<(\d+)> \{ static constexpr int " +
                       ", ".join(f"{k} = (\\d+)" for k in keys), CU.read_text())
    return {int(d): dict(zip(keys, map(int, rest))) for d, *rest in found}


def twin_backward(do, q, k, v, o, lse, *, causal=True, scale=None, passes=3):
    """The backward kernels' loops on the CPU -> float32 (dq, dk, dv)
    (before the cast to q's dtype)."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    tile = bwd_tiles()[D]
    scale = D**-0.5 if scale is None else scale
    exact = q.dtype != torch.float32  # bf16/f16 values are exact in TF32
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)

    def probs(s, L, rows, cols):  # exp(scale S - L), 0 above the diagonal
        p = torch.exp(s * scale - L)
        return torch.where(cols <= rows, p, 0.0) if causal else p

    def add_products(acc, p, b):  # acc + p @ b, JG blocks of 8 of p's columns at a time
        for c in range(0, p.shape[1], 8 * tile["JG"]):
            acc = acc + tc_product(p[:, c : c + 8 * tile["JG"]], b[c : c + 8 * tile["JG"]],
                                   False, exact, passes)
        return acc

    dq = torch.empty(B, H, S, D)
    BQ, BK = 16 * tile["QW"], tile["BK"]
    for b in range(B):
        for h in range(H):
            kh, vh = kf[b, h // G], vf[b, h // G]
            for q0 in range(0, S, BQ):
                rows = torch.arange(q0, min(q0 + BQ, S))
                acc = torch.zeros(len(rows), D)
                nk = -(-S // BK)
                if causal:
                    nk = min(nk, (q0 + BQ - 1) // BK + 1)
                for k0 in range(0, nk * BK, BK):
                    keys = torch.arange(k0, min(k0 + BK, S))
                    s = tc_product(qf[b, h, rows], kh[keys].T, exact, exact, passes)
                    dp = tc_product(dof[b, h, rows], vh[keys].T, exact, exact, passes)
                    p = probs(s, lse[b, h, rows, None], rows[:, None], keys[None, :])
                    ds = p * (dp - delta[b, h, rows, None])
                    acc = add_products(acc, ds, kh[keys])
                dq[b, h, rows] = acc * scale

    dk, dv = torch.empty(B, KVH, S, D), torch.empty(B, KVH, S, D)
    BN, BQ = 16 * tile["KW"], tile["BQ"]
    for b in range(B):
        for kvh in range(KVH):
            for n0 in range(0, S, BN):
                keys = torch.arange(n0, min(n0 + BN, S))
                kt, vt = kf[b, kvh, keys], vf[b, kvh, keys]
                dka, dva = torch.zeros(len(keys), D), torch.zeros(len(keys), D)
                first = (n0 // BQ) * BQ if causal else 0
                for h in range(kvh * G, (kvh + 1) * G):
                    for m0 in range(first, S, BQ):
                        rows = torch.arange(m0, min(m0 + BQ, S))
                        qt, dot = qf[b, h, rows], dof[b, h, rows]
                        st = tc_product(kt, qt.T, exact, exact, passes)
                        pt = probs(st, lse[b, h, None, rows], rows[None, :], keys[:, None])
                        dva = add_products(dva, pt, dot)
                        dpt = tc_product(vt, dot.T, exact, exact, passes)
                        dst = pt * (dpt - delta[b, h, None, rows])
                        dka = add_products(dka, dst, qt)
                dk[b, kvh, keys], dv[b, kvh, keys] = dka * scale, dva
    return dq, dk, dv


def _inputs(seed, B, H, KVH, S, D, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dtype)
            for shape in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D), (B, H, S, D))]


def _autograd(q, k, v, do, causal, scale):
    ins = [t.float().clone().requires_grad_() for t in (q, k, v)]
    out = ref.attention_ref(*ins, causal=causal, scale=scale)
    return torch.autograd.grad(out, ins, do.float())


def _twin(q, k, v, do, causal, scale, passes=3):
    out, lse = twin_attention(q, k, v, causal=causal, scale=scale, return_lse=True)
    return twin_backward(do, q, k, v, out.to(q.dtype), lse, causal=causal, scale=scale,
                         passes=passes)


def _worst(got, want) -> float:
    """The largest |got - want| of each gradient over its largest |want|."""
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KVH,S,D", [
    (1, 4, 2, 100, 64),  # G = 2, ragged S
    (1, 2, 1, 70, 128),  # G = 2, S below one key tile of the dK/dV kernel
    (2, 3, 1, 37, 16),  # MQA, G = 3
])
def test_bwd_twin_matches_autograd(B, H, KVH, S, D, causal):
    q, k, v, do = _inputs(S + D + causal, B, H, KVH, S, D)
    scale = 0.7 * D**-0.5
    want = _autograd(q, k, v, do, causal, scale)
    assert _worst(_twin(q, k, v, do, causal, scale), want) <= GRAD_TOL


def test_bwd_twin_two_passes_at_head_dim_256():
    """head_dim 256: the dK/dV kernel runs dV and dK in two launches
    (kTwoPass), which recompute S alike: the same arithmetic."""
    assert bwd_tiles()[256]["kTwoPass"] == 1
    q, k, v, do = _inputs(5, 1, 2, 1, 40, 256)
    assert _worst(_twin(q, k, v, do, True, None), _autograd(q, k, v, do, True, None)) \
        <= GRAD_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_bwd_twin_16bit_inputs_take_fewer_passes(dtype):
    """bf16 / f16 inputs: S and dP take one pass, the products with P or dS
    two. Against autograd on the widened values within 2e-2 of the largest
    gradient (the card's 16-bit tolerance): Δ comes from the output as
    stored in the 16-bit dtype."""
    q, k, v, do = _inputs(3, 1, 4, 2, 50, 64, dtype)
    assert _worst(_twin(q, k, v, do, True, None), _autograd(q, k, v, do, True, None)) <= 2e-2


@pytest.mark.parametrize("D", [64, 128])
def test_one_tf32_pass_misses_the_gradient_tolerance(D):
    q, k, v, do = _inputs(D + 2, 1, 4, 2, 96, D)
    want = _autograd(q, k, v, do, True, None)
    assert _worst(_twin(q, k, v, do, True, None), want) <= GRAD_TOL
    assert _worst(_twin(q, k, v, do, True, None, passes=1), want) > GRAD_TOL


def test_split_drops_less_than_2_to_the_minus_21():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(0, 1, 10_000) * 10.0 ** rng.integers(-6, 6, 10_000))
                         .astype(np.float32))
    big, small = split(x)
    for part in (big, small):  # TF32: the low 13 bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((x.double() - big.double() - small.double()).abs()
            <= 2.0**-21 * x.double().abs()).all()


def test_bwd_tiles_fit_the_card():
    """Every head_dim the forward takes has backward tiles whose shared
    memory fits a block (rows of D + 4 floats, as the kernel's
    `dkdv_smem_floats` / `dq_smem_floats`), with 8-row blocks."""
    tiles = bwd_tiles()
    assert sorted(tiles) == list(kernel_cuda.HEAD_DIMS)
    for d, t in tiles.items():
        dkdv = ((2 * 16 * t["KW"] + 4 * t["BQ"]) * (d + 4) + 4 * t["BQ"]) * 4
        dq = (2 * 16 * t["QW"] + 4 * t["BK"]) * (d + 4) * 4
        assert t["BQ"] % 8 == 0 and t["BK"] % 8 == 0
        assert max(dkdv, dq) <= SMEM_PER_BLOCK, (d, dkdv, dq)

"""A CPU twin of the CUDA flash-attention kernel's arithmetic.

``csrc/flash_attention.cu`` does both products on the tensor cores in
3xTF32: an f32 operand x enters as big = rna(x) and small = rna(x - big),
both TF32 (`cvt.rna.tf32.f32`), and a*b is taken as small_a*big_b +
big_a*small_b + big_a*big_b (small*small dropped). bf16 and f16 values are
exact in TF32, so with those inputs Q K^T takes one pass and P V two (P is
f32). ``twin_attention`` runs the kernel's tile loop on the CPU with that
arithmetic: its query and key tiles (read from the kernel's `Tile` table),
and the online softmax with the -inf guard. The order in which the
kernel's register fragments take the terms of a product (keys 2t, 2t + 1
of each 8-key block in P V; d0 + 2t, d0 + 2t + 1 in Q K^T) only permutes
a sum, which the matrix products here cannot tell apart from another:
tests/test_torch_cuda.py checks that fragment mapping on the card.

The twin is held to the port's `attention_ref` and to the reference's
Pallas kernel in interpret mode (its jnp ref for ragged S), on the same
seeded numpy inputs, within 2e-5 abs/rel, the f32 tolerance the card's
checks use. One TF32 pass misses that tolerance on the same inputs: that is
why the kernel takes three.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import kernel as ref_fa_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as ref_fa  # noqa: E402
from repro_torch.kernels.flash_attention import kernel_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402

TOL = 2e-5
CU = Path(kernel_cuda.__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"
SMEM_PER_BLOCK = 232_448  # H100: dynamic shared memory a block may use


def kernel_tiles() -> dict:
    """{head_dim: (warps, keys per tile)} from the kernel's `Tile` table."""
    found = re.findall(r"struct Tile<(\d+)> \{ static constexpr int NW = (\d+), BK = (\d+)",
                       CU.read_text())
    return {int(d): (int(nw), int(bk)) for d, nw, bk in found}


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: float32 rounded to 10 mantissa bits, to nearest
    with ties away from zero (on the magnitude bits, the sign untouched)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def tc_product(a: torch.Tensor, b: torch.Tensor, a_exact: bool, b_exact: bool,
               passes: int = 3) -> torch.Tensor:
    """a @ b as the kernel's TF32 passes take it (f32 sums). ``passes=1``
    is a single TF32 product, for comparison."""
    if passes == 1:
        return tf32_rna(a) @ tf32_rna(b)
    a_big, a_small = (a, None) if a_exact else split(a)
    b_big, b_small = (b, None) if b_exact else split(b)
    out = torch.zeros(a.shape[0], b.shape[1])
    if a_small is not None:
        out = out + a_small @ b_big
    if b_small is not None:
        out = out + a_big @ b_small
    return out + a_big @ b_big


def twin_attention(q, k, v, *, causal=True, scale=None, passes=3, return_lse=False):
    """The kernel's tile loop on the CPU: (B, H, S, D) x (B, KVH, S, D)
    -> float32 (B, H, S, D) (before the cast to q's dtype); with
    ``return_lse`` also each row's log-sum-exp m + log(l), (B, H, S), the
    kernel's optional output for the backward."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    warps, BK = kernel_tiles()[D]
    BQ = 16 * warps
    scale = D**-0.5 if scale is None else scale
    exact = q.dtype != torch.float32  # bf16/f16 values are exact in TF32
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(B, H, S, D)
    lse = torch.empty(B, H, S)
    for b in range(B):
        for h in range(H):
            kh, vh = kf[b, h // G], vf[b, h // G]
            for q0 in range(0, S, BQ):
                rows = torch.arange(q0, min(q0 + BQ, S))
                qt = qf[b, h, rows]
                m = torch.full((len(rows),), float("-inf"))
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), D)
                nk = -(-S // BK)
                if causal:
                    nk = min(nk, (q0 + BQ - 1) // BK + 1)
                for k0 in range(0, nk * BK, BK):
                    keys = torch.arange(k0, min(k0 + BK, S))
                    s = tc_product(qt, kh[keys].T, exact, exact, passes) * scale
                    if causal:
                        s = torch.where(keys[None, :] <= rows[:, None], s, float("-inf"))
                    m_new = torch.maximum(m, s.amax(dim=1))
                    m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
                    alpha = torch.exp(m - m_use)
                    p = torch.exp(s - m_use[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + tc_product(p, vh[keys], False, exact, passes)
                    m = m_new
                out[b, h, rows] = acc / l[:, None]  # every row has key 0: l > 0
                lse[b, h, rows] = m + torch.log(l)
    return (out, lse) if return_lse else out


def _inputs(seed, B, H, KVH, S, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0, 1, shape).astype(np.float32)
              for shape in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))]
    if dtype == np.float32:
        return arrays, [torch.from_numpy(a) for a in arrays]
    tdt = {"bfloat16": torch.bfloat16, "float16": torch.float16}[dtype]
    tensors = [torch.from_numpy(a).to(tdt) for a in arrays]
    return [t.float().numpy() for t in tensors], tensors


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def _misses(got, want, tol=TOL) -> bool:
    want = np.asarray(want, np.float32)
    return not bool((np.abs(got.numpy() - want) <= tol + tol * np.abs(want)).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_twin_matches_reference_kernel(D, causal):
    """GQA (4 query heads over 2 KV heads) at every head_dim the kernel takes."""
    arrays, (q, k, v) = _inputs(D + causal, 1, 4, 2, 128, D)
    got = twin_attention(q, k, v, causal=causal)
    qj, kj, vj = (jnp.asarray(a) for a in arrays)
    _close(got, ref_fa_kernel.flash_attention_pallas(qj, kj, vj, causal=causal, block_q=64,
                                                     block_k=64, interpret=True))
    _close(got, ref.attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(37, 256), (203, 256), (100, 128), (1, 64)])
def test_twin_ragged_mqa(S, D, causal):
    """Any S (not a multiple of the kernel's tiles), MQA (10 heads over 1)."""
    arrays, (q, k, v) = _inputs(S + D, 2, 10, 1, S, D)
    got = twin_attention(q, k, v, causal=causal, scale=0.07)
    qj, kj, vj = (jnp.asarray(a) for a in arrays)
    _close(got, ref_fa.attention_ref(qj, kj, vj, causal=causal, scale=0.07))
    _close(got, ref.attention_ref(q, k, v, causal=causal, scale=0.07))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("D", [64, 256])
def test_twin_16bit_inputs_take_fewer_passes(dtype, D):
    """bf16/f16 values are exact in TF32: one pass for Q K^T and two for
    P V hold the f32 result on the same (widened) values."""
    arrays, (q, k, v) = _inputs(D, 1, 4, 2, 100, D, dtype)
    for t, a in zip((q, k, v), arrays):
        assert torch.equal(tf32_rna(t), torch.from_numpy(a))
    got = twin_attention(q, k, v)
    _close(got, ref.attention_ref(*(torch.from_numpy(a) for a in arrays)))
    _close(got, ref_fa.attention_ref(*(jnp.asarray(a) for a in arrays), causal=True))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_one_tf32_pass_misses_the_f32_tolerance(D):
    """The same inputs as the 3xTF32 twin passes with: a single TF32 pass
    (each operand rounded to 2^-11 relative) misses 2e-5."""
    arrays, (q, k, v) = _inputs(D + 1, 1, 4, 2, 128, D)
    want = ref_fa.attention_ref(*(jnp.asarray(a) for a in arrays), causal=True)
    _close(twin_attention(q, k, v), want)
    assert _misses(twin_attention(q, k, v, passes=1), want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,D", [(100, 64), (37, 256)])
def test_twin_lse_equals_logsumexp_of_the_plain_logits(S, D, causal):
    """The forward's log-sum-exp output (m + log(l) per row, from the same
    tiles as the output) against logsumexp of the plain version's scaled,
    masked float32 logits."""
    _, (q, k, v) = _inputs(S + D + 7, 2, 6, 2, S, D)
    out, lse = twin_attention(q, k, v, causal=causal, scale=0.09, return_lse=True)
    assert torch.equal(out, twin_attention(q, k, v, causal=causal, scale=0.09))
    logits = torch.einsum("bhqd,bhkd->bhqk", q, torch.repeat_interleave(k, 3, dim=1)) * 0.09
    if causal:
        logits = logits.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    _close(lse, torch.logsumexp(logits, dim=-1).numpy())


def test_tf32_rounding_and_split():
    # Round to nearest at bit 13, ties away from zero on either sign.
    one = 1.0
    x = torch.tensor([one + 2**-11, -(one + 2**-11), one + 2**-12, one + 3 * 2**-11,
                      one + 2**-10, 3.0, -0.0], dtype=torch.float32)
    want = torch.tensor([one + 2**-10, -(one + 2**-10), one, one + 2**-9,
                         one + 2**-10, 3.0, -0.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.normal(0, 1, 10_000) * 10.0 ** rng.integers(-6, 6, 10_000))
                         .astype(np.float32))
    big, small = split(a)
    for part in (big, small):  # TF32: the low 13 bits are zero
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((a - big).abs() <= 2.0**-11 * a.abs()).all()
    # What the split leaves out is below 2^-22 of x.
    assert ((a.double() - big.double() - small.double()).abs() <= 2.0**-22 * a.double().abs()).all()


def test_kernel_tiles_fit_the_card():
    """Every head_dim has a tile whose Q and two K/V stages fit a block's
    shared memory."""
    tiles = kernel_tiles()
    assert sorted(tiles) == list(kernel_cuda.HEAD_DIMS)
    # Q and two K stages in rows of D + 8 floats, two V stages in rows of D + 4.
    smem = {d: ((16 * nw + 2 * bk) * (d + 8) + 2 * bk * (d + 4)) * 4
            for d, (nw, bk) in tiles.items()}
    for d, (nw, bk) in tiles.items():
        assert bk % 8 == 0 and 1 <= nw <= 32 and smem[d] <= SMEM_PER_BLOCK


def test_wrapper_refuses_misaligned_views():
    """The 16-byte `cp.async` copies need 16-byte aligned pointers and
    strides (dimensions of length 1 do not count); the wrapper copies a
    view that is not to contiguous storage before the launch."""
    base = torch.zeros(2 * 3 * 40 * 64 + 4)
    x = base[:-4].view(2, 3, 40, 64)
    assert kernel_cuda.aligned(x)
    assert kernel_cuda.aligned(x.transpose(1, 2))
    assert not kernel_cuda.aligned(base[1:-3].view(2, 3, 40, 64))
    assert not kernel_cuda.aligned(torch.zeros(2, 3, 40, 66)[..., :64])
    assert kernel_cuda.aligned(torch.zeros(1, 3, 40, 64).as_strided((1, 3, 40, 64),
                                                                    (7, 2560, 64, 1)))
    assert not kernel_cuda.aligned(torch.zeros(2, 40, 66, dtype=torch.bfloat16)[None, ..., :64])

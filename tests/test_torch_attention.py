"""repro_torch's attention plain versions against the reference.

The port's flash and decode attention (CPU tensors take the plain
versions through ``ops``) against the reference's Pallas kernels in
interpret mode and its jnp refs, on the same inputs made from a seed with
numpy. GQA, MQA and MHA, causal and full, ragged lengths, f32 and bf16.

Tolerances: f32 2e-5 abs/rel (as tests/test_kernels_attention.py; the
sums run in another order); bf16 inputs 2e-2 (the outputs round to bf16,
whose unit step at 1 is 2^-7 = 7.8e-3: one rounding either side).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import kernel as ref_dec_kernel  # noqa: E402
from repro.kernels.decode_attention import ref as ref_dec  # noqa: E402
from repro.kernels.flash_attention import kernel as ref_fa_kernel  # noqa: E402
from repro.kernels.flash_attention import ref as ref_fa  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = {np.float32: 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got_torch, want_jax, tol):
    np.testing.assert_allclose(
        got_torch.float().numpy(), np.asarray(want_jax, np.float32), atol=tol, rtol=tol
    )


def _qkv(seed, B, H, KVH, S, D, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0, 1, shape).astype(np.float32)
              for shape in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))]
    return [_pair(a, dtype) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize(
    "B,H,KVH,S,D,dtype",
    [
        (1, 2, 2, 128, 64, np.float32),  # MHA
        (2, 4, 2, 256, 64, np.float32),  # GQA
        (1, 8, 1, 128, 128, np.float32),  # MQA
        (2, 4, 2, 128, 16, np.float32),  # the reduced qwen3 head_dim
        (2, 4, 2, 128, 64, "bfloat16"),
    ],
)
def test_flash_plain_matches_reference_kernel(B, H, KVH, S, D, dtype, causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B * 100 + S + D, B, H, KVH, S, D, dtype)
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = TOL[dtype]
    pallas = ref_fa_kernel.flash_attention_pallas(
        qj, kj, vj, causal=causal, block_q=64, block_k=64, interpret=True
    )
    _close(got, pallas, tol)
    _close(got, ref_fa.attention_ref(qj, kj, vj, causal=causal), tol)


@pytest.mark.parametrize("S", [1, 37, 100])
def test_flash_plain_ragged_sequence(S):
    """Any S (the reference kernel needs S % block == 0; its ref does not)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(S, 2, 4, 2, S, 32, np.float32)
    for causal in (True, False):
        got = fa_ops.flash_attention(qt, kt, vt, causal=causal, scale=0.3)
        _close(got, ref_fa.attention_ref(qj, kj, vj, causal=causal, scale=0.3), 2e-5)


def test_causal_attention_default_scale():
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, 1, 4, 2, 64, 32, np.float32)
    _close(attention.causal_attention(qt, kt, vt),
           ref_fa.attention_ref(qj, kj, vj, causal=True, scale=32**-0.5), 2e-5)


def _decode_inputs(seed, B, H, KVH, S, D, q_dtype, cache_dtype, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    kc = rng.normal(0, 1, (B, KVH, S, D)).astype(np.float32)
    vc = rng.normal(0, 1, (B, KVH, S, D)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, size=B)
    lengths = np.asarray(lengths, np.int32)
    return (
        _pair(q, q_dtype), _pair(kc, cache_dtype), _pair(vc, cache_dtype),
        (jnp.asarray(lengths), torch.from_numpy(lengths)),
    )


@pytest.mark.parametrize(
    "B,H,KVH,S,D,q_dtype,cache_dtype",
    [
        (1, 2, 2, 128, 64, np.float32, np.float32),
        (3, 8, 2, 256, 64, np.float32, np.float32),
        (2, 4, 1, 512, 128, np.float32, np.float32),  # MQA
        (2, 4, 2, 128, 16, np.float32, np.float32),
        (3, 4, 2, 192, 64, np.float32, "bfloat16"),  # serving: f32 q, bf16 cache
        (2, 4, 2, 128, 64, "bfloat16", "bfloat16"),
    ],
)
def test_decode_plain_matches_reference_kernel(B, H, KVH, S, D, q_dtype, cache_dtype):
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(
        B * 17 + S + D, B, H, KVH, S, D, q_dtype, cache_dtype
    )
    got = dec_ops.decode_attention(qt, kt, vt, lt)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    tol = TOL[q_dtype if q_dtype == "bfloat16" else np.float32]
    if cache_dtype == "bfloat16" and q_dtype != "bfloat16":
        tol = 2e-5  # same bf16 cache values, widened to f32 on both sides
    pallas = ref_dec_kernel.decode_attention_pallas(qj, kj, vj, lj, block_k=64, interpret=True)
    _close(got, pallas, tol)
    _close(got, ref_dec.decode_attention_ref(qj, kj, vj, lj), tol)


@pytest.mark.parametrize("lengths", [[1, 1], [1, 128], [128, 128], [64, 65]])
def test_decode_plain_edge_lengths(lengths):
    (qj, qt), (kj, kt), (vj, vt), (lj, lt) = _decode_inputs(
        3, 2, 4, 2, 128, 64, np.float32, np.float32, lengths
    )
    got = attention.decode_attention(qt, kt, vt, lt)
    _close(got, ref_dec_kernel.decode_attention_pallas(qj, kj, vj, lj, block_k=64,
                                                        interpret=True), 2e-5)


def test_cpu_attention_launches_no_kernel():
    kernels.reset_launch_counts()
    (_, qt), (_, kt), (_, vt) = _qkv(0, 1, 2, 1, 16, 16, np.float32)
    fa_ops.flash_attention(qt, kt, vt)
    dec_ops.decode_attention(qt[:, :, 0], kt, vt, torch.tensor([3], dtype=torch.int32))
    assert kernels.launch_counts()["flash_attention"] == 0
    assert kernels.launch_counts()["decode_attention"] == 0

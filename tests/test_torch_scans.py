"""repro_torch's recurrence scans (RG-LRU, RWKV-6) against the reference.

The port's plain versions (CPU tensors take them through ``ops``) against
the reference's Pallas kernels in interpret mode and its jnp refs, on the
same inputs made from a seed with numpy: the shapes of
tests/test_kernels_scans.py, plus T not a multiple of the reference's
block (its kernels assert divisibility; its refs do not), a given initial
state, T = 1 (the rwkv decode step) and the RG-LRU's a -> 1 stability case.

Tolerances, as tests/test_kernels_scans.py: 1e-5 abs/rel for the RG-LRU,
1e-4 for RWKV-6 (its state sums N products per step, in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rglru_scan import kernel as ref_rg_kernel  # noqa: E402
from repro.kernels.rglru_scan import ref as ref_rg  # noqa: E402
from repro.kernels.rwkv6_scan import kernel as ref_rk_kernel  # noqa: E402
from repro.kernels.rwkv6_scan import ops as ref_rk_ops  # noqa: E402
from repro.kernels.rwkv6_scan import ref as ref_rk  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rg_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as rk_ops  # noqa: E402

RG_TOL = 1e-5
RK_TOL = 1e-4


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _rglru_inputs(seed, B, T, D, with_h0):
    rng = np.random.default_rng(seed)
    la = -rng.uniform(0.001, 2.0, (B, T, D)).astype(np.float32)
    gx = rng.normal(0, 1, (B, T, D)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (B, D)).astype(np.float32) if with_h0 else None
    return la, gx, h0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize(
    "B,T,D,bt,bd",
    [(1, 16, 128, 8, 128), (2, 64, 256, 32, 128), (1, 128, 512, 64, 512)],
)
@pytest.mark.parametrize("with_h0", [True, False])
def test_rglru_plain_matches_reference_kernel(B, T, D, bt, bd, with_h0):
    la, gx, h0 = _rglru_inputs(B * 11 + T, B, T, D, with_h0)
    out, h = rg_ops.rglru_scan(_t(la), _t(gx), _t(h0))
    assert out.shape == (B, T, D) and out.dtype == torch.float32
    assert h.shape == (B, D) and h.dtype == torch.float32
    want_o, want_h = ref_rg_kernel.rglru_scan_pallas(
        _j(la), _j(gx), _j(h0), block_t=bt, block_d=bd, interpret=True)
    _close(out, want_o, RG_TOL)
    _close(h, want_h, RG_TOL)
    ref_o, ref_h = ref_rg.rglru_scan_ref(_j(la), _j(gx), _j(h0))
    _close(out, ref_o, RG_TOL)
    _close(h, ref_h, RG_TOL)


@pytest.mark.parametrize("B,T,D,with_h0", [(2, 37, 100, True), (3, 1, 64, True),
                                           (1, 300, 24, False)])
def test_rglru_plain_any_shape(B, T, D, with_h0):
    """T and D of no block multiple, and T = 1 (the reference's kernel
    asserts ``T % block_t == 0 and D % block_d == 0``; its ref does not)."""
    la, gx, h0 = _rglru_inputs(T + D, B, T, D, with_h0)
    out, h = rg_ops.rglru_scan(_t(la), _t(gx), _t(h0))
    ref_o, ref_h = ref_rg.rglru_scan_ref(_j(la), _j(gx), _j(h0))
    _close(out, ref_o, RG_TOL)
    _close(h, ref_h, RG_TOL)
    # Chaining the final state across two halves equals one scan.
    if T > 1:
        m = T // 2
        o1, h1 = rg_ops.rglru_scan(_t(la[:, :m]), _t(gx[:, :m]), _t(h0))
        o2, h2 = rg_ops.rglru_scan(_t(la[:, m:]), _t(gx[:, m:]), h1)
        torch.testing.assert_close(torch.cat([o1, o2], 1), out, atol=0, rtol=0)
        torch.testing.assert_close(h2, h, atol=0, rtol=0)


def test_rglru_stability_near_one():
    """a -> 1 (log_a -> 0^-): the sqrt(-expm1) path stays finite and equal."""
    B, T, D = 1, 8, 128
    la = np.full((B, T, D), -1e-7, np.float32)
    gx = np.ones((B, T, D), np.float32)
    out, h = rg_ops.rglru_scan(_t(la), _t(gx))
    assert torch.isfinite(out).all() and torch.isfinite(h).all()
    want_o, want_h = ref_rg_kernel.rglru_scan_pallas(
        _j(la), _j(gx), None, block_t=8, block_d=128, interpret=True)
    _close(out, want_o, RG_TOL)
    _close(h, want_h, RG_TOL)


def test_rglru_bf16_output_dtype():
    la, gx, _ = _rglru_inputs(3, 2, 20, 32, False)
    out, h = rg_ops.rglru_scan(_t(la).bfloat16(), _t(gx).bfloat16())
    assert out.dtype == torch.bfloat16 and h.dtype == torch.float32
    ref_o, ref_h = ref_rg.rglru_scan_ref(jnp.asarray(la, jnp.bfloat16),
                                         jnp.asarray(gx, jnp.bfloat16))
    _close(out, ref_o, 1e-2)  # one bf16 rounding of each output
    _close(h, ref_h, RG_TOL)


def _rwkv_inputs(seed, B, H, T, N, with_s0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, H, T, N)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.2, 0.999, (B, H, T, N)).astype(np.float32)  # as exp(-exp(x))
    u = rng.normal(0, 0.5, (H, N)).astype(np.float32)
    s0 = rng.normal(0, 0.1, (B, H, N, N)).astype(np.float32) if with_s0 else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,H,T,N,bt", [(1, 1, 16, 16, 8), (2, 3, 64, 32, 32),
                                        (1, 2, 128, 64, 64)])
@pytest.mark.parametrize("with_s0", [True, False])
def test_rwkv6_plain_matches_reference_kernel(B, H, T, N, bt, with_s0):
    args = _rwkv_inputs(B * 7 + T, B, H, T, N, with_s0)
    out, s = rk_ops.rwkv6_scan(*map(_t, args))
    assert out.shape == (B, H, T, N) and out.dtype == torch.float32
    assert s.shape == (B, H, N, N) and s.dtype == torch.float32
    want_o, want_s = ref_rk_kernel.rwkv6_scan_pallas(*map(_j, args), block_t=bt,
                                                     interpret=True)
    _close(out, want_o, RK_TOL)
    _close(s, want_s, RK_TOL)
    ref_o, ref_s = ref_rk.rwkv6_scan_ref(*map(_j, args))
    _close(out, ref_o, RK_TOL)
    _close(s, ref_s, RK_TOL)


@pytest.mark.parametrize("B,H,T,N", [(2, 3, 37, 32), (2, 4, 1, 64), (1, 2, 200, 16)])
def test_rwkv6_plain_matches_reference_ops(B, H, T, N):
    """Any T, 1 included, with a given state, against the reference's public
    op (its chunk-checkpointed form on the CPU; T = 1 is its decode path)."""
    args = _rwkv_inputs(T + N, B, H, T, N, True)
    out, s = rk_ops.rwkv6_scan(*map(_t, args))
    want_o, want_s = ref_rk_ops.rwkv6_scan(*map(_j, args))
    _close(out, want_o, RK_TOL)
    _close(s, want_s, RK_TOL)
    if T == 1:
        want_o, want_s = ref_rk_kernel.rwkv6_scan_pallas(*map(_j, args), interpret=True)
        _close(out, want_o, RK_TOL)
        _close(s, want_s, RK_TOL)


def test_rwkv6_state_out_in_place():
    """Decode hands the cache's state as s0 and as state_out: after the call
    the same tensor holds the new state, and steps chain like one scan."""
    B, H, T, N = 2, 3, 6, 16
    r, k, v, w, u, s0 = _rwkv_inputs(9, B, H, T, N, True)
    full_o, full_s = rk_ops.rwkv6_scan(*map(_t, (r, k, v, w, u, s0)))
    state = torch.from_numpy(s0.copy())
    for t in range(T):
        step = [torch.from_numpy(np.ascontiguousarray(a[:, :, t : t + 1])) for a in (r, k, v, w)]
        o, got = rk_ops.rwkv6_scan(*step, torch.from_numpy(u), state, state_out=state)
        assert got is state
        torch.testing.assert_close(o[:, :, 0], full_o[:, :, t], atol=RK_TOL, rtol=RK_TOL)
    torch.testing.assert_close(state, full_s, atol=RK_TOL, rtol=RK_TOL)


def test_rwkv6_ops_casts_like_the_reference():
    """k, v follow r's dtype; w, u, s0 become float32; out has r's dtype."""
    r, k, v, w, u, s0 = _rwkv_inputs(4, 1, 2, 9, 16, True)
    out, s = rk_ops.rwkv6_scan(_t(r).bfloat16(), _t(k), _t(v), _t(w).bfloat16(),
                               _t(u).bfloat16(), _t(s0))
    assert out.dtype == torch.bfloat16 and s.dtype == torch.float32
    want_o, want_s = ref_rk_ops.rwkv6_scan(jnp.asarray(r, jnp.bfloat16), _j(k), _j(v),
                                           jnp.asarray(w, jnp.bfloat16),
                                           jnp.asarray(u, jnp.bfloat16), _j(s0))
    _close(out, want_o, 2e-2)
    _close(s, want_s, RK_TOL)


def test_cpu_scans_launch_no_kernel():
    kernels.reset_launch_counts()
    la, gx, _ = _rglru_inputs(0, 1, 4, 8, False)
    rg_ops.rglru_scan(_t(la), _t(gx))
    rk_ops.rwkv6_scan(*map(_t, _rwkv_inputs(0, 1, 1, 3, 16, False)))
    assert kernels.launch_counts()["rglru_scan"] == 0
    assert kernels.launch_counts()["rwkv6_scan"] == 0

"""A CPU twin of the CUDA RWKV-6 scan kernel's order of work.

``csrc/rwkv6_scan.cu`` runs one CTA of kWarps warps per (b, h). Each warp
spans all N columns and is KG key groups of 32 / KG lanes; lane (g, l) of
warp w keeps keys (w KG + g) KPT .. (KPT = N / (kWarps KG)) of CPT = N KG
/ 32 columns in registers (the `Tile` entries, parsed from the source
below). Per step t the bonus is one scalar, c[t] = sum_i (r_i u_i) k_i,
summed by 16 threads (thread q over keys q N / 16 .. with fused
multiply-adds) and four xor shuffles. The key block (w, g)'s partial o_j
starts at v_j * c[t] (the first block) or 0 and runs acc = fma(r_i, S_ij,
acc), S_ij = fma(w_i, S_ij, k_i * v_j) over its keys in order; a warp's KG
partials are added by xor shuffles (highest group bit first), and the
warps' rows in warp order. Time runs in chunks of kChunk steps through a
ring of kStages stages, with two partial buffers and two rows of c:
iteration ci issues chunk ci + kStages - 1's copies, computes chunk
ci + 1's c row, writes chunk ci - 1's outputs and computes chunk ci.

``twin_rwkv6`` runs that schedule on the CPU with the ring's buffers as
arrays: a copy lands the moment it is issued (rows past T as zeros, as
the tensor copies fill them; a call of one chunk copies rows and leaves
the others as they were, unused either way), so a stage refilled before its last reader is done would
corrupt the result, and `_iteration_phases` asserts that no phase of an
iteration writes a buffer that another phase of it (run by other warps, in
no order) touches. Each fused multiply-add is emulated in float64 and
rounded once to float32; products and sums outside them round to float32
as the kernel's `__fmul_rn` and `__fadd_rn` do.

The twin is held to the reference's Pallas kernel in interpret mode
(where T is a multiple of its block) and its jnp ref, on the same seeded
numpy inputs, within 1e-4 abs/rel, the kernel's tolerance on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rwkv6_scan import kernel as ref_rk_kernel  # noqa: E402
from repro.kernels.rwkv6_scan import ref as ref_rk  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel_cuda  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref  # noqa: E402

TOL = 1e-4
CU = Path(kernel_cuda.__file__).resolve().parents[2] / "csrc" / "rwkv6_scan.cu"
SMEM_PER_SM = 233_472  # H100: 228 KB per SM, of which 1 KB is reserved per CTA
SMEM_PER_CTA = 232_448
TILE = (r"struct Tile<(\d+)> \{ static constexpr int KG = (\d+), kWarps = (\d+), "
        r"kChunk = (\d+), kStages = (\d+), kMinBlocks = (\d+); \};")


def tiles() -> dict:
    """{N: tile} from the source's `Tile` entries, with the `Plan` values."""
    out = {}
    for n, kg, warps, chunk, stages, min_blocks in re.findall(TILE, CU.read_text()):
        N, kg, warps = int(n), int(kg), int(warps)
        out[N] = {"KG": kg, "warps": warps, "C": int(chunk), "S": int(stages),
                  "min_blocks": int(min_blocks), "LG": 32 // kg, "CPT": N * kg // 32,
                  "KPT": N // (warps * kg), "threads": 32 * warps}
    return out


def smem_bytes(N: int, t: dict, esize: int = 4) -> int:
    """`Plan::kSmem`: the stages (r, k, v rows in their type, w rows in
    f32), two partial buffers, two c rows, one mbarrier per stage."""
    stage = t["C"] * (3 * N * esize + N * 4)
    return t["S"] * stage + (2 * t["warps"] * t["C"] * N + 2 * t["C"]) * 4 + t["S"] * 8


def f32(x):
    return x.to(torch.float32)


def fma(a, b, c):
    """a * b + c rounded once to float32 (the product of two floats is
    exact in float64)."""
    return f32(a.double() * b.double() + c.double())


def tree(parts):
    """Adds partials over their first axis as xor shuffles do, highest bit
    first (every lane ends with the same float32 sum)."""
    bit = parts.shape[0] // 2
    while bit:
        parts = f32(parts + parts[[g ^ bit for g in range(parts.shape[0])]])
        bit //= 2
    return parts[0]


def _iteration_phases(ci: int, n_chunks: int, S: int) -> list:
    """The buffers each phase of iteration ci reads and writes, as the
    kernel's loop runs them after its barrier; asserts that no buffer one
    phase writes is touched by another."""
    phases = []
    if ci + S - 1 < n_chunks:
        phases.append({"reads": set(), "writes": {("stage", (ci + S - 1) % S)}})
    if ci + 1 < n_chunks:
        phases.append({"reads": {("stage", (ci + 1) % S)}, "writes": {("c", (ci + 1) % 2)}})
    if ci > 0:
        phases.append({"reads": {("part", (ci - 1) % 2)}, "writes": set()})
    phases.append({"reads": {("stage", ci % S), ("c", ci % 2)}, "writes": {("part", ci % 2)}})
    for a in phases:
        for b in phases:
            if a is not b:
                assert not a["writes"] & (b["reads"] | b["writes"]), (ci, a, b)
    return phases


def twin_rwkv6(r, k, v, w, u, s0=None):
    """(out (B, H, T, N), final state (B, H, N, N)) in the kernel's order;
    float32 inputs as torch tensors."""
    B, H, T, N = r.shape
    t = tiles()[N]
    KG, W, KPT, C, S = t["KG"], t["warps"], t["KPT"], t["C"], t["S"]
    kb = N // 16
    state = (torch.zeros((B, H, N, N)) if s0 is None else s0.clone()).float()
    out = torch.full((B, H, T, N), float("nan"))
    n_chunks = -(-T // C)
    stages = [[torch.full((B, H, C, N), float("nan")) for _ in range(4)] for _ in range(S)]
    c_rows, parts = [None, None], [None, None]

    def issue(x):  # lands at once; rows past T are zeros
        n = min(C, T - x * C)
        for z, a in zip(stages[x % S], (r, k, v, w)):
            z.zero_()
            z[:, :, :n] = a[:, :, x * C: x * C + n]

    def bonus(x):  # c[t] per step of chunk x: 16 threads, then xor shuffles
        sr, sk = stages[x % S][0], stages[x % S][1]
        acc = torch.zeros((16, B, H, C))
        for q in range(16):
            for i in range(q * kb, (q + 1) * kb):
                acc[q] = fma(f32(sr[..., i] * u[None, :, i, None]), sk[..., i], acc[q])
        c_rows[x % 2] = tree(acc)

    def write(x):  # the warps' rows in warp order
        n = min(C, T - x * C)
        o = parts[x % 2][0]
        for wi in range(1, W):
            o = f32(o + parts[x % 2][wi])
        out[:, :, x * C: x * C + n] = o[:, :, :n]

    def compute(x):
        sr, sk, sv, sw = stages[x % S]
        part = torch.zeros((W, B, H, C, N))
        for c in range(min(C, T - x * C)):
            vj = sv[:, :, c]  # (B, H, N)
            kv = f32(sk[:, :, c, :, None] * vj[:, :, None, :])  # (B, H, N, N)
            acc = torch.zeros((W * KG, B, H, N))  # per key block (w, g)
            acc[0] = f32(vj * c_rows[x % 2][:, :, c, None])
            for m in range(KPT):
                keys = [blk * KPT + m for blk in range(W * KG)]
                acc = fma(sr[:, :, c, keys].permute(2, 0, 1)[..., None],
                          state[:, :, keys].permute(2, 0, 1, 3), acc)
            state[:] = fma(sw[:, :, c, :, None], state, kv)
            for wi in range(W):
                part[wi, :, :, c] = tree(acc[wi * KG: (wi + 1) * KG])
        parts[x % 2] = part

    for x in range(min(S - 1, n_chunks)):
        issue(x)
    bonus(0)
    for ci in range(n_chunks):
        _iteration_phases(ci, n_chunks, S)
        if ci + S - 1 < n_chunks:
            issue(ci + S - 1)
        if ci + 1 < n_chunks:
            bonus(ci + 1)
        if ci > 0:
            write(ci - 1)
        compute(ci)
    write(n_chunks - 1)
    assert not out.isnan().any()
    return out, state


def _inputs(seed, B, H, T, N, with_s0, decay="uniform"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, H, T, N)).astype(np.float32) for _ in range(3))
    if decay == "uniform":
        w = rng.uniform(0.2, 0.999, (B, H, T, N))  # as test_torch_scans.py
    else:  # the model's w = exp(-exp(raw)), raw ~ N(0, 2), and both extremes
        w = np.exp(-np.exp(rng.normal(0, 2, (B, H, T, N))))
        w = np.clip(w, 1e-20, 0.9999)
        w[..., 0], w[..., 1] = 1e-20, 0.9999
    u = rng.normal(0, 0.5, (H, N)).astype(np.float32)
    s0 = rng.normal(0, 0.1, (B, H, N, N)).astype(np.float32) if with_s0 else None
    return r, k, v, w.astype(np.float32), u, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=TOL, rtol=TOL)


def _check(args, pallas_block=None):
    got_o, got_s = twin_rwkv6(*map(_t, args))
    want = [ref_rk.rwkv6_scan_ref(*map(_j, args)), ref.rwkv6_scan_ref(*map(_t, args))]
    if pallas_block is not None:
        want.append(ref_rk_kernel.rwkv6_scan_pallas(*map(_j, args), block_t=pallas_block,
                                                    interpret=True))
    for want_o, want_s in want:
        _close(got_o, want_o)
        _close(got_s, want_s)


@pytest.mark.parametrize("N", [16, 32, 64])
def test_tiles_fit_the_card(N):
    """Each head size has a tile whose key groups split a warp evenly, whose
    warps span the columns in whole quads of keys, and whose kMinBlocks
    CTAs fit an SM's threads and shared memory."""
    t = tiles()[N]
    assert t["KG"] in (1, 2, 4) and t["CPT"] * t["LG"] == N
    assert t["KPT"] % 4 == 0 and t["warps"] * t["KG"] * t["KPT"] == N
    assert t["C"] % 2 == 0 and t["C"] <= 32 and t["S"] >= 3
    assert t["threads"] * t["min_blocks"] <= 2048
    for esize in (4, 2):
        smem = smem_bytes(N, t, esize)
        assert smem <= SMEM_PER_CTA
        assert t["min_blocks"] * (smem + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("B,H,T,N,bt", [(1, 1, 16, 16, 8), (2, 3, 64, 32, 32),
                                        (1, 2, 128, 64, 64)])
@pytest.mark.parametrize("with_s0", [True, False])
def test_twin_matches_reference_kernel(B, H, T, N, bt, with_s0):
    _check(_inputs(B * 7 + T, B, H, T, N, with_s0), pallas_block=bt)


@pytest.mark.parametrize("N", [16, 32, 64])
def test_twin_ragged_T(N):
    """T = 37: not a multiple of the chunk or the ring (the reference's
    Pallas kernel refuses it; its ref does not)."""
    _check(_inputs(37 + N, 2, 2, 37, N, True))


@pytest.mark.parametrize("N", [16, 32, 64])
def test_twin_decode_step(N):
    """T = 1 with a given state: rwkv6's decode step."""
    _check(_inputs(1 + N, 2, 3, 1, N, True), pallas_block=1)


@pytest.mark.parametrize("N", [16, 64])
def test_twin_model_decay_range(N):
    """Decays as the model makes them, from 1e-20 to 0.9999, over more steps
    than the ring holds."""
    t = tiles()[N]
    T = t["C"] * t["S"] + 3
    _check(_inputs(5 + N, 1, 2, T, N, True, decay="model"))


def test_schedule_has_no_hazard():
    """Every iteration of the kernel's loop, at chunk counts around the ring
    size, keeps each buffer to one phase that writes it."""
    for N, t in tiles().items():
        for n_chunks in range(1, 2 * t["S"] + 2):
            for ci in range(n_chunks):
                _iteration_phases(ci, n_chunks, t["S"])

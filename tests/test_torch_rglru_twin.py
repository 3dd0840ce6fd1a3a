"""A CPU twin of the CUDA RG-LRU scan kernel's order of work.

``csrc/rglru_scan.cu`` runs one CTA per batch row and channel group of
G = 32 kVec channels (lane l takes channels l, l + 32, ... of the group),
with kProducers producer warps and one scan warp (the `Tile` entry of
each dtype, parsed from the source below). Time runs in chunks of kChunk
steps through a ring of kStages stages. Producer warp p loads steps p,
p + kProducers, ... of a chunk, waits on the stage's `empty` mbarrier when
it refills a stage, writes a = exp(la) and x = sqrt(-expm1(2 la)) * gx per
step and channel into the stage and arrives on its `full` mbarrier; the
scan warp waits on `full`, walks the chunk's steps with h = a * h + x
(product and sum rounded separately), writes each state, and arrives on
`empty`. Steps past T are neither computed nor read, channels past D
neither loaded nor stored.

``twin_rglru`` runs that schedule on the CPU: each warp is a generator
that yields at its mbarrier waits, and a seeded scheduler picks which
runnable warp goes next, so the warps interleave in many orders. The
mbarriers are modelled with their phase and parity as the kernel waits on
them, and every stage step carries the chunk that last wrote it and the
chunk that the scan last read from it: a producer that overwrites a stage
step before the scan released it, or a scan that reads a step its chunk's
producer has not written, fails an assertion.

Its arithmetic is the kernel's on float32 tensors, so it is held
bit-equal (``torch.equal``) to the port's plain version on the CPU, and
within 1e-5 abs/rel (the kernel's tolerance) to the reference's Pallas
kernel in interpret mode (where T and D are multiples of its blocks) and
its jnp ref, on the same seeded numpy inputs.
"""

import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.rglru_scan import kernel as ref_rg_kernel  # noqa: E402
from repro.kernels.rglru_scan import ref as ref_rg  # noqa: E402
from repro_torch.kernels.rglru_scan import kernel_cuda  # noqa: E402
from repro_torch.kernels.rglru_scan import ref  # noqa: E402

TOL = 1e-5
CU = Path(kernel_cuda.__file__).resolve().parents[2] / "csrc" / "rglru_scan.cu"
SMEM_PER_SM = 233_472  # H100: 228 KB per SM, of which 1 KB is reserved per CTA
SMEM_PER_CTA = 232_448
N_SM = 132
TILE = (r"struct Tile<(\w+)> \{ static constexpr int kVec = (\d+), kProducers = (\d+), "
        r"kChunk = (\d+), kStages = (\d+), kMinBlocks = (\d+); \};")
DTYPES = {"float": torch.float32, "__nv_bfloat16": torch.bfloat16, "__half": torch.float16}


def tiles() -> dict:
    """{torch dtype: tile} from the source's `Tile` entries, with the
    `Plan` values."""
    out = {}
    for name, vec, prod, chunk, stages, min_blocks in re.findall(TILE, CU.read_text()):
        V, P, C, S = int(vec), int(prod), int(chunk), int(stages)
        out[DTYPES[name]] = {"V": V, "P": P, "C": C, "S": S, "min_blocks": int(min_blocks),
                             "G": 32 * V, "threads": 32 * (P + 1),
                             "smem": S * C * 32 * V * 8 + 2 * S * 8}
    return out


class MBarrier:
    """An mbarrier: a phase completes when `count` arrivals have come;
    ``done(parity)`` is what `mbarrier.try_wait.parity` returns."""

    def __init__(self, count: int):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self, n: int = 1):
        self.pending -= n
        assert self.pending >= 0
        if self.pending == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def done(self, parity: int) -> bool:
        return (self.phase & 1) != parity


def run_schedule(agents: list, seed: int) -> None:
    """Runs generator `agents` (each yields a zero-argument predicate it
    waits on) in a seeded random interleaving until all end; fails on a
    deadlock."""
    rnd = random.Random(seed)
    waiting = {i: (lambda: True) for i in range(len(agents))}
    while waiting:
        ready = [i for i, pred in waiting.items() if pred()]
        assert ready, "deadlock: every warp waits"
        i = rnd.choice(ready)
        try:
            waiting[i] = next(agents[i])
        except StopIteration:
            del waiting[i]


def twin_cta(la, gx, h, out, t_len, tile, seed, compute=True, producer_waits=True):
    """One channel group of every batch row (the CTAs of one blockIdx.x
    run the same schedule): la, gx (B, T, V, 32) float32 with channels past
    D zero, h (B, V, 32) float32 updated in place, out (B, T, V, 32)
    float32 written step by step. ``compute=False`` runs the schedule and
    its hazard checks only; ``producer_waits=False`` drops the producers'
    wait on `empty` (the hazard check must catch that)."""
    V, P, C, S = tile["V"], tile["P"], tile["C"], tile["S"]
    B = h.shape[0]
    n_chunks = -(-t_len // C)
    stage = torch.full((S, B, C, V, 32, 2), float("nan"))
    written = [[None] * C for _ in range(S)]  # the chunk that last wrote each step
    released = [-1] * S  # the last chunk the scan released from each stage
    full = [MBarrier(32 * P) for _ in range(S)]
    empty = [MBarrier(32) for _ in range(S)]

    def producer(p):
        for c in range(n_chunks):
            s, t0 = c % S, c * C
            n = min(C, t_len - t0)
            steps = [t for t in range(p, C, P) if t < n]  # its steps of the chunk, loaded
            if c >= S and producer_waits:
                parity = ((c // S) - 1) & 1
                yield lambda s=s, parity=parity: empty[s].done(parity)
            for t in steps:
                assert released[s] >= c - S, f"stage {s} refilled before the scan left it"
                if compute:
                    a = torch.exp(la[:, t0 + t])
                    mult = torch.sqrt(-torch.expm1(2.0 * la[:, t0 + t]))
                    stage[s, :, t, ..., 0] = a
                    stage[s, :, t, ..., 1] = mult * gx[:, t0 + t]
                written[s][t] = c
            full[s].arrive(32)  # every lane of the warp

    def scan():
        for c in range(n_chunks):
            s, t0 = c % S, c * C
            n = min(C, t_len - t0)
            yield lambda s=s, parity=(c // S) & 1: full[s].done(parity)
            for t in range(n):
                assert written[s][t] == c, f"chunk {c} step {t} read before it was written"
                if compute:
                    h[:] = stage[s, :, t, ..., 0] * h + stage[s, :, t, ..., 1]
                    out[:, t0 + t] = h
            released[s] = c
            empty[s].arrive(32)

    run_schedule([producer(p) for p in range(P)] + [scan()], seed)


def twin_rglru(log_a, gx, h0=None, seed=0):
    """(states (B, T, D) in gx's dtype, final state (B, D) float32) in the
    kernel's order."""
    B, T, D = gx.shape
    tile = tiles()[gx.dtype]
    V, G = tile["V"], tile["G"]
    out = torch.full((B, T, D), float("nan"))
    h_final = torch.full((B, D), float("nan"))
    for g in range(-(-D // G)):
        d = g * G + torch.arange(V)[:, None] * 32 + torch.arange(32)  # (V, 32)
        ok = d < D
        idx = d.clamp(max=D - 1)

        def gather(x):  # (B, T, D) -> (B, T, V, 32) float32, channels past D zero
            return torch.where(ok, x.float()[..., idx], torch.zeros(()))

        h = torch.zeros((B, V, 32))
        if h0 is not None:
            h = torch.where(ok, h0.float()[:, idx], torch.zeros(()))
        got = torch.full((B, T, V, 32), float("nan"))
        twin_cta(gather(log_a), gather(gx), h, got, T, tile, seed + g)
        out[..., d[ok]] = got[..., ok]
        h_final[:, d[ok]] = h[:, ok]
    assert not out.isnan().any() and not h_final.isnan().any()
    return out.to(gx.dtype), h_final


def _inputs(seed, B, T, D, with_h0, near_one=False):
    rng = np.random.default_rng(seed)
    if near_one:  # a -> 1, as test_rglru_stability_near_one
        la = np.full((B, T, D), -1e-7, np.float32)
        la[..., ::3] = -rng.uniform(0, 1e-6, la[..., ::3].shape)
    else:
        la = -rng.uniform(0.001, 2.0, (B, T, D))
    gx = rng.normal(0, 1, (B, T, D))
    h0 = rng.normal(0, 0.3, (B, D)).astype(np.float32) if with_h0 else None
    return la.astype(np.float32), gx.astype(np.float32), h0


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def _check(la, gx, h0, pallas_blocks=None):
    """The twin bit-equal to the plain version, and within 1e-5 of the
    reference's jnp ref (and Pallas kernel, with its blocks)."""
    got_o, got_h = twin_rglru(_t(la), _t(gx), _t(h0))
    plain_o, plain_h = ref.rglru_scan_ref(_t(la), _t(gx), _t(h0))
    assert torch.equal(got_o, plain_o) and torch.equal(got_h, plain_h)
    want = [ref_rg.rglru_scan_ref(_j(la), _j(gx), _j(h0))]
    if pallas_blocks is not None:
        bt, bd = pallas_blocks
        want.append(ref_rg_kernel.rglru_scan_pallas(_j(la), _j(gx), _j(h0), block_t=bt,
                                                    block_d=bd, interpret=True))
    for want_o, want_h in want:
        _close(got_o, want_o)
        _close(got_h, want_h)
    assert np.isfinite(got_o.numpy()).all() and np.isfinite(got_h.numpy()).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_tiles_fit_the_card(dtype):
    """Each dtype has a tile whose producers take as many steps of a chunk
    each, whose ring has two stages or more, and whose kMinBlocks CTAs fit
    an SM's threads and shared memory."""
    t = tiles()[dtype]
    assert 1 <= t["V"] <= 4 and t["C"] % t["P"] == 0 and t["S"] >= 2
    assert t["threads"] * t["min_blocks"] <= 2048
    assert t["smem"] <= SMEM_PER_CTA and t["min_blocks"] * (t["smem"] + 1024) <= SMEM_PER_SM


def test_prefill_ctas_are_all_resident():
    """At recurrentgemma-2b's prefill, (8, 2048, 2560) f32, every CTA is
    resident at once: a CTA walks all of T, so a second wave would run
    alone for a whole CTA's time."""
    t = tiles()[torch.float32]
    assert 8 * -(-2560 // t["G"]) <= N_SM * t["min_blocks"]


@pytest.mark.parametrize("B,T,D,bt,bd", [(1, 16, 128, 8, 128), (2, 64, 256, 32, 128),
                                         (1, 128, 64, 64, 64)])
@pytest.mark.parametrize("with_h0", [True, False])
def test_twin_matches_reference_kernel(B, T, D, bt, bd, with_h0):
    _check(*_inputs(B * 11 + T, B, T, D, with_h0), pallas_blocks=(bt, bd))


@pytest.mark.parametrize("T_of", ["1", "C-1", "C+1", "2C+3"])
@pytest.mark.parametrize("D", [33, 100])
def test_twin_ragged(T_of, D):
    """T at the chunk's edges (a ragged last chunk, one chunk shorter than
    the ring, more chunks than stages) and D of no channel-group multiple,
    with and without h0 (the reference's Pallas kernel refuses such T and
    D; its ref does not)."""
    C = tiles()[torch.float32]["C"]
    T = {"1": 1, "C-1": C - 1, "C+1": C + 1, "2C+3": 2 * C + 3}[T_of]
    _check(*_inputs(T + D, 2, T, D, True))
    _check(*_inputs(T * D, 1, T, D, False))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [33, 100])
def test_twin_16_bit_inputs(dtype, D):
    """bf16 and f16 inputs widen as they are read and the states round
    once to the inputs' dtype: equal to the plain version."""
    C = tiles()[dtype]["C"]
    la, gx, h0 = _inputs(7 + D, 2, C + 5, D, True)
    la_t, gx_t, h0_t = _t(la, dtype), _t(gx, dtype), _t(h0)
    got_o, got_h = twin_rglru(la_t, gx_t, h0_t)
    want_o, want_h = ref.rglru_scan_ref(la_t, gx_t, h0_t)
    assert got_o.dtype == dtype
    assert torch.equal(got_o, want_o) and torch.equal(got_h, want_h)
    _, j_h = ref_rg.rglru_scan_ref(jnp.asarray(la_t.float().numpy()),
                                     jnp.asarray(gx_t.float().numpy()), _j(h0))
    _close(got_h, j_h)


@pytest.mark.parametrize("with_h0", [True, False])
def test_twin_near_one(with_h0):
    """a -> 1 (log_a down to -1e-7, some -0): sqrt(-expm1(2 la)) stays
    finite, over more steps than the ring holds."""
    t = tiles()[torch.float32]
    _check(*_inputs(3, 2, t["C"] * t["S"] + 3, 40, with_h0, near_one=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_schedule_has_no_hazard(dtype):
    """The ring's hand-over at chunk counts around the ring size, in many
    interleavings of the warps: no stage step is refilled before the scan
    released it, none read before its chunk was written, no deadlock."""
    t = tiles()[dtype]
    for n_chunks in range(1, 2 * t["S"] + 3):
        for t_len in (n_chunks * t["C"], n_chunks * t["C"] - 1):
            for seed in range(4):
                h = torch.zeros((1, t["V"], 32))
                twin_cta(None, None, h, None, t_len, t, seed, compute=False)


def test_hazard_check_catches_a_missing_wait():
    """Without the producers' wait on `empty`, some interleaving refills a
    stage the scan has not left: the check must see it."""
    t = tiles()[torch.float32]
    with pytest.raises(AssertionError, match="refilled before"):
        for seed in range(20):
            h = torch.zeros((1, t["V"], 32))
            twin_cta(None, None, h, None, (t["S"] + 2) * t["C"], t, seed, compute=False,
                     producer_waits=False)

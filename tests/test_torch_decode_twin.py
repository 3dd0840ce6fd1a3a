"""A CPU twin of the CUDA decode-attention kernel's order of work.

``csrc/decode_attention.cu`` cuts the sequence axis into splits sized to
the card (its split rule, `plan` below, with the constants parsed from the
source), walks each split in tiles of ``kTile`` positions with an online
softmax (max, sum, accumulator per head), and combines a sequence's valid
splits in split order, taking every split's factor exp(m - M) once (the
CTAs of the splits' cluster each merge a slice of the columns, through
distributed shared memory); a sequence with one valid split is written
directly. ``twin_decode`` runs that order on the CPU in float32. A bf16
cache whose head_dim is in kTcDims goes through the tensor cores: q and p
enter the bf16 `mma` as three bf16 pieces each (round to nearest even,
then the remainder, twice), which the twin emulates on the bits; the
cache's bf16 values are exact. Other caches take f32 FMAs on the CUDA
cores. The order of the terms within a tile only permutes sums that the
matrix products here cannot tell apart from another, and the ring of copy
stages only decides when a tile arrives, not the order in which tiles are
used.

The twin is held to the reference's Pallas kernel in interpret mode (its
jnp ref where S is not a multiple of 64) and to the port's
`decode_attention_ref`, on the same seeded numpy inputs, within 2e-5
abs/rel, the f32 tolerance of the card's checks.

With ``return_lse`` the kernel's combine also writes each row's
log-sum-exp m + log(l) from the (max, sum) it merged (a zero output and
-inf where a row has no valid position). The twin's, and the port's plain
version's, are held to the log-sum-exp of the reference's masked scaled
logits; and a cache cut into position shards (as ``model`` ranks hold a
sequence-split cache, some shards empty, a local ring that has wrapped)
merged by `merge_partials` equals the reference's attention over the
whole cache, within the same 2e-5.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.decode_attention import kernel as ref_dec_kernel  # noqa: E402
from repro.kernels.decode_attention import ref as ref_dec  # noqa: E402
from repro_torch.kernels.decode_attention import kernel_cuda  # noqa: E402
from repro_torch.kernels.decode_attention import ref  # noqa: E402
from repro_torch.models.attention import merge_partials  # noqa: E402

TOL = 2e-5
H100_SMS = 132
CU = Path(kernel_cuda.__file__).resolve().parents[2] / "csrc" / "decode_attention.cu"


def kernel_constants() -> dict:
    """The kernel's ``constexpr int`` constants, read from the source."""
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", CU.read_text())}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tensor_cores(D, cache_dtype) -> bool:
    """Whether the kernel takes its tensor-core path (`make_plan`; the
    caches 16-byte aligned, as fresh tensors are)."""
    dims = [int(d) for d in re.search(r"kTcDims\[\] = \{([\d, ]+)\}", CU.read_text())
            .group(1).split(",")]
    return cache_dtype == "bf16" and D in dims


def plan(B, H, KVH, S, sms=H100_SMS, tc=False) -> dict:
    """The kernel's split rule (`make_plan`): head blocks of at most
    kTcHeads (tensor cores) or kMaxHeads heads, then splits of whole tiles,
    as many as keep B * KVH * head blocks * splits within kCtasPerSm CTAs
    per SM on 7/8 of the SMs (one wave), at most kMaxSplits."""
    c = kernel_constants()
    G = H // KVH
    nhb = cdiv(G, c["kTcHeads"] if tc else c["kMaxHeads"])
    hp = cdiv(G, nhb)
    groups = B * KVH * nhb
    tile = c["kTile"]
    n_tiles = cdiv(S, tile)
    want = max(1, min(c["kCtasPerSm"] * sms * 7 // 8 // groups, n_tiles, c["kMaxSplits"]))
    tps = cdiv(n_tiles, want)
    return {"nhb": nhb, "hp": hp, "splits": cdiv(n_tiles, tps),
            "split_len": tps * tile, "tile": tile}


def _merge(parts):
    """[(m, l, acc)] of one set of splits, in slot order -> (M, L, acc)."""
    ms = torch.stack([m for m, _, _ in parts])  # (n, heads)
    M = ms.amax(dim=0)
    f = torch.exp(ms - M)  # each split's factor, once
    L = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for j, (_, l, a) in enumerate(parts):
        L = L + f[j] * l
        acc = acc + f[j][:, None] * a
    return M, L, acc


def bf16_pieces(x: torch.Tensor):
    """The kernel's `split3`: x = s0 + s1 + s2 (+ below 2^-24 |x|), each
    bf16 rounded to nearest even, as f32 values."""
    s0 = x.bfloat16().float()
    r1 = x - s0
    s1 = r1.bfloat16().float()
    return s0, s1, (r1 - s1).bfloat16().float()


def product(a: torch.Tensor, b: torch.Tensor, tc: bool) -> torch.Tensor:
    """a @ b as the kernel takes it: f32, or on the tensor cores with a in
    three bf16 pieces (b exact in bf16), smallest piece first."""
    if not tc:
        return a @ b
    out = torch.zeros(a.shape[0], b.shape[1])
    for piece in reversed(bf16_pieces(a)):
        out = out + piece @ b
    return out


def twin_decode(q, k, v, lengths, *, scale=None, sms=H100_SMS, return_lse=False):
    """(B, H, D) x (B, KVH, S, D) caches, (B,) lengths -> float32 (B, H, D),
    in the kernel's split, tile and combine order (and with ``return_lse``
    the (B, H) log-sum-exp its combine writes)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    tc = tensor_cores(D, "bf16" if k.dtype == torch.bfloat16 else "other")
    pl = plan(B, H, KVH, S, sms, tc)
    T, Ls = pl["tile"], pl["split_len"]
    scale = D**-0.5 if scale is None else scale
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty(B, H, D)
    lse = torch.full((B, H), float("-inf"))
    for b in range(B):
        n = min(int(lengths[b]), S)
        nv = cdiv(n, Ls)
        if nv == 0:  # nothing valid: NaN, or with the log-sum-exp zeros and -inf
            out[b] = 0.0 if return_lse else float("nan")
            continue
        for kvh in range(KVH):
            for hb in range(pl["nhb"]):
                h0 = kvh * G + hb * pl["hp"]
                heads = range(h0, h0 + min(pl["hp"], G - hb * pl["hp"]))
                qh = qf[b, heads]
                parts = []
                for s in range(nv):
                    m = torch.full((len(heads),), float("-inf"))
                    l = torch.zeros(len(heads))
                    acc = torch.zeros(len(heads), D)
                    for p0 in range(s * Ls, min((s + 1) * Ls, n), T):
                        pos = slice(p0, min(p0 + T, (s + 1) * Ls, n))
                        x = product(qh, kf[b, kvh, pos].T, tc) * scale
                        m_new = torch.maximum(m, x.amax(dim=1))
                        alpha = torch.exp(m - m_new)
                        e = torch.exp(x - m_new[:, None])
                        l = l * alpha + e.sum(dim=1)
                        acc = acc * alpha[:, None] + product(e, vf[b, kvh, pos], tc)
                        m = m_new
                    parts.append((m, l, acc))
                M, L, acc = parts[0] if nv == 1 else _merge(parts)
                out[b, heads] = acc / L[:, None]
                lse[b, heads] = M + torch.log(L)
    return (out, lse) if return_lse else out


def _inputs(seed, B, H, KVH, S, D, cache_dtype):
    """Seeded numpy arrays; a bf16 cache is rounded once and both sides get
    the rounded values."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, D)).astype(np.float32)
    kc, vc = (rng.normal(0, 1, (B, KVH, S, D)).astype(np.float32) for _ in range(2))
    if cache_dtype == "bf16":
        kc, vc = (torch.from_numpy(a).bfloat16() for a in (kc, vc))
        k_np, v_np = kc.float().numpy(), vc.float().numpy()
    else:
        k_np, v_np = kc, vc
        kc, vc = torch.from_numpy(kc), torch.from_numpy(vc)
    return (q, k_np, v_np), (torch.from_numpy(q), kc, vc)


def _lengths(B, H, KVH, S, tc):
    """1, a split boundary, one past it, and S (then repeated)."""
    L = plan(B, H, KVH, S, tc=tc)["split_len"]
    return np.array([[1, L, L + 1, S][i % 4] for i in range(B)], np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


CASES = [
    # (B, H, KVH, S, D, cache dtype)
    (4, 2, 2, 256, 128, "f32"),  # G = 1
    (4, 4, 2, 256, 128, "bf16"),  # G = 2, qwen3-0.6b's head_dim
    (4, 10, 1, 256, 256, "bf16"),  # G = 10, recurrentgemma-2b's head_dim, MQA
    (4, 10, 1, 128, 256, "f32"),
    (4, 4, 2, 100, 42, "bf16"),  # head_dims of --reduce 3 and 7: the element path
    (4, 10, 1, 100, 18, "f32"),
    (4, 2, 2, 70, 18, "bf16"),
    (4, 4, 2, 192, 42, "f32"),
]


@pytest.mark.parametrize("B,H,KVH,S,D,cache_dtype", CASES)
def test_twin_matches_reference(B, H, KVH, S, D, cache_dtype):
    (q_np, k_np, v_np), (q, kc, vc) = _inputs(B * 100 + S + D, B, H, KVH, S, D, cache_dtype)
    lengths = _lengths(B, H, KVH, S, tensor_cores(D, cache_dtype))
    got = twin_decode(q, kc, vc, lengths)
    qj, kj, vj, lj = (jnp.asarray(a) for a in (q_np, k_np, v_np, lengths))
    if S % 64 == 0:
        want = ref_dec_kernel.decode_attention_pallas(qj, kj, vj, lj, block_k=64,
                                                      interpret=True)
    else:
        want = ref_dec.decode_attention_ref(qj, kj, vj, lj)
    _close(got, want)
    _close(got, ref.decode_attention_ref(q, kc, vc, torch.from_numpy(lengths)))


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_twin_holds_for_any_split_count(sms):
    """One split (written directly) and merges of several, on the same
    inputs."""
    (q_np, k_np, v_np), (q, kc, vc) = _inputs(sms, 3, 4, 2, 320, 64, "f32")
    lengths = np.array([320, 33, 1], np.int32)
    got = twin_decode(q, kc, vc, lengths, scale=0.2, sms=sms)
    _close(got, ref_dec.decode_attention_ref(*(jnp.asarray(a) for a in (q_np, k_np, v_np,
                                                                        lengths)), scale=0.2))


def test_split_rule_at_the_serving_shapes():
    """Splits sized to the H100's 132 SMs: qwen3-0.6b (64 (b, kv head)
    pairs, 1,088 positions) 2-9 splits; recurrentgemma-2b (8 pairs, G = 10,
    2,048 positions) kMaxSplits splits of 128 positions; every CTA serves
    the whole GQA group."""
    c = kernel_constants()
    assert tensor_cores(128, "bf16") and tensor_cores(256, "bf16")
    qwen = plan(8, 16, 8, 1088, tc=True)
    assert qwen["nhb"] == 1 and 2 <= qwen["splits"] <= 9
    gemma = plan(8, 10, 1, 2048, tc=True)
    assert gemma["nhb"] == 1 and gemma["splits"] == c["kMaxSplits"] == 16
    assert gemma["split_len"] == 128
    assert 64 * qwen["splits"] <= c["kCtasPerSm"] * H100_SMS
    assert qwen["split_len"] % c["kTile"] == 0


@pytest.mark.parametrize("tc", [False, True])
@pytest.mark.parametrize("B,H,KVH,S", [(8, 16, 8, 1088), (8, 10, 1, 2048), (1, 48, 1, 5),
                                       (3, 13, 1, 4096), (64, 64, 64, 33)])
def test_split_rule_covers_each_position_once(B, H, KVH, S, tc):
    """Splits tile [0, S) in whole tiles, at most kMaxSplits of them; head
    blocks cover every query head of a group once with at most kTcHeads or
    kMaxHeads each."""
    c = kernel_constants()
    p = plan(B, H, KVH, S, tc=tc)
    G = H // KVH
    assert (p["splits"] - 1) * p["split_len"] < S <= p["splits"] * p["split_len"]
    assert p["hp"] <= c["kTcHeads" if tc else "kMaxHeads"] and p["nhb"] * p["hp"] >= G > (p["nhb"] - 1) * p["hp"]
    assert 1 <= p["splits"] <= c["kMaxSplits"] and p["split_len"] % p["tile"] == 0


def test_bf16_pieces_are_exact_enough():
    """Three bf16 pieces hold a float32 to 2^-24 of it (two leave up to
    2^-18), and a bf16 cache value is its own first piece."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(0, 1, 10_000) * 10.0 ** rng.integers(-6, 6, 10_000))
                         .astype(np.float32))
    s0, s1, s2 = bf16_pieces(x)
    for part in (s0, s1, s2):
        assert torch.equal(part.bfloat16().float(), part)
    rest = (x.double() - s0.double() - s1.double() - s2.double()).abs()
    assert (rest <= 2.0**-24 * x.double().abs()).all()
    assert ((x.double() - s0.double() - s1.double()).abs() > 2.0**-20 * x.double().abs()).any()
    kc = x.bfloat16().float()
    assert torch.equal(bf16_pieces(kc)[0], kc) and not bf16_pieces(kc)[1].any()


# ----------------------------------------------------------------- log-sum-exp and shards


def ref_lse(q, k, v, lengths, scale=None):
    """The log-sum-exp of the reference's masked scaled logits (its plain
    version's), -inf where a row has nothing valid."""
    D = q.shape[-1]
    scale = D**-0.5 if scale is None else scale
    g = q.shape[1] // k.shape[1]
    kx = jnp.repeat(jnp.asarray(k), g, axis=1)
    logits = jnp.einsum("bhd,bhsd->bhs", jnp.asarray(q), kx) * scale
    mask = jnp.arange(k.shape[2])[None, None, :] < jnp.asarray(lengths)[:, None, None]
    return np.asarray(jax.scipy.special.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1))


@pytest.mark.parametrize("B,H,KVH,S,D,cache_dtype", [CASES[1], CASES[2], CASES[3], CASES[4]])
def test_twin_and_plain_log_sum_exp_match_reference(B, H, KVH, S, D, cache_dtype):
    (q_np, k_np, v_np), (q, kc, vc) = _inputs(B + S + D, B, H, KVH, S, D, cache_dtype)
    lengths = _lengths(B, H, KVH, S, tensor_cores(D, cache_dtype))
    lengths[-1] = 0  # a row with no valid position: zeros and -inf
    want = ref_lse(q_np, k_np, v_np, lengths)
    got_out, got = twin_decode(q, kc, vc, lengths, return_lse=True)
    plain_out, plain = ref.decode_attention_ref(q, kc, vc, torch.from_numpy(lengths),
                                                return_lse=True)
    for o, lse in ((got_out, got), (plain_out, plain)):
        assert torch.isneginf(lse[-1]).all() and not o[-1].any() and not o.isnan().any()
        _close(lse[:-1], want[:-1])
    _close(got_out[:-1], ref_dec.decode_attention_ref(*(jnp.asarray(a) for a in (
        q_np, k_np, v_np, lengths)))[:-1])
    # Without the log-sum-exp the plain output is as before (NaN: 0 / 0).
    bare = ref.decode_attention_ref(q, kc, vc, torch.from_numpy(lengths))
    assert bare[-1].isnan().all() and torch.equal(bare[:-1], plain_out[:-1])


def _shard_lengths(valid, offsets, size):
    return [np.clip(valid - off, 0, size).astype(np.int32) for off in offsets]


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("ring", [False, True])
def test_position_shards_merge_to_reference(n_shards, ring):
    """A cache cut into ``n_shards`` contiguous position shards (as the
    ``model`` ranks hold recurrentgemma-2b's ring and granite-20b's causal
    cache), each attended on its own with the log-sum-exp (the valid count
    of shard r: clamp(valid - r * S / n, 0, S / n), zero for some rows),
    then merged, equals the reference's attention over the whole cache. A
    wrapped ring holds its window in slot order p % W: a permutation of the
    positions, which the softmax does not see."""
    B, H, KVH, S, D = 5, 10, 1, 256, 64
    (q_np, k_np, v_np), (q, kc, vc) = _inputs(7 + n_shards, B, H, KVH, S, D, "f32")
    valid = np.array([1, 40, 130, S, 200], np.int32)
    if ring:  # the last window of positions 0 .. len, at slot p % S
        valid = np.array([S, S, S, S, 77], np.int32)
        shift = np.array([5, 100, 255, 0, 0])
        for b in range(B):
            k_np[b], v_np[b] = (np.roll(a[b], shift[b], axis=1) for a in (k_np, v_np))
        kc, vc = torch.from_numpy(k_np), torch.from_numpy(v_np)
    size = S // n_shards
    offs = [r * size for r in range(n_shards)]
    outs, lses = [], []
    for off, n in zip(offs, _shard_lengths(valid, offs, size)):
        o, lse = twin_decode(q, kc[:, :, off:off + size].contiguous(),
                             vc[:, :, off:off + size].contiguous(), n, return_lse=True)
        po, plse = ref.decode_attention_ref(q, kc[:, :, off:off + size], vc[:, :, off:off + size],
                                            torch.from_numpy(n), return_lse=True)
        _close(o, po)
        _close(lse.clamp(min=-1e30), plse.clamp(min=-1e30))
        outs.append(o)
        lses.append(lse)
    assert any(torch.isneginf(x).any() for x in lses)  # some shard holds nothing
    merged = merge_partials(torch.stack(outs), torch.stack(lses),
                            lambda t: t.amax(0, keepdim=True), lambda t: t.sum(0, keepdim=True))[0]
    want = ref_dec.decode_attention_ref(*(jnp.asarray(a) for a in (q_np, k_np, v_np, valid)))
    _close(merged, want)

"""A CPU twin of the persistent CUDA auction-phase kernel's schedule.

``csrc/auction_phase.cu`` runs the auction's whole Jacobi phase in one
cooperative launch of co-resident CTAs (kThreads threads each, kCtasPerSm
per SM at most; the grid rule and the row split rule are read from the
source below). Each iteration, between grid barriers:

- phase 1: the bidders are a compacted list (double-buffered by iteration
  parity, counts in a ring of three). Each row is split into
  ``row_splits(n, warps, M)`` column chunks, none narrower than
  kMinColsPerSplit columns (the twin may set another width, so that rows of
  a few dozen machines split too); a warp takes one (row, chunk) unit at a
  time, its lane l folds columns c0 + l, c0 + l + 32, ... with the triple
  merge and the warp reduces by ``__shfl_down_sync``.
  With more than one chunk, each warp stores its partial and counts the row
  on an atomic counter, and the warp that counts last merges the row's
  partials (lane k takes partials k, k + 32, ...). The row's finisher either
  takes the task's unscheduled column or claims the machine with a 64-bit
  atomicMax on (order bits of the bid) << 32 | (0xFFFFFFFF - task id);
  the previous iteration's claims are cleared first.
- phase 2: a bidder whose key survived takes slot1 at its bid, evicts the
  owner and recomputes price1/slot1/price2 of that machine only; losers and
  evictees are pushed onto the next list.

``twin_phase`` runs that schedule on the CPU with numpy float32 arithmetic:
the order in which the warps finish their units, the order of each list,
and the order in which phase 2 visits the bidders are drawn from a seeded
generator, so different seeds run the same solve in different orders. It
checks the schedule's invariants as it goes (claims cleared before reuse,
one winner per machine, an evictee held the slot, bids above the price
they replace, the incremental slot prices equal a full recomputation, the
next list is exactly the unassigned active tasks) and is held bit-equal
(price, owner, assigned, iterations) to the reference's
``repro.core.auction`` phase (``jax.lax.while_loop``, on the CPU) and to the
port's step-wise loop, whose bidder-row count it also matches.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import auction as r_auction  # noqa: E402
from repro_torch.kernels.auction_phase import kernel_cuda, ref  # noqa: E402

CU = Path(kernel_cuda.__file__).resolve().parents[2] / "csrc" / "auction_phase.cu"
N_SM = 132  # H100 SXM
NEG_VALUE = np.float32(-(2.0**40))
LOCK = np.float32(2.0**40)
FLOOR = np.float32(-(2.0**62))
INT_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def kernel_rules() -> dict:
    """The kernel's constants and its row-split and grid rules, from the
    source: the integer expressions are evaluated with C's division."""
    text = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    def expr(func, var):
        body = re.search(rf"{func}\([^)]*\) \{{(.*?)\n\}}", text, re.S).group(1)
        return re.search(rf"const (?:int|long long) {var} = ([^;]+);", body).group(1)

    splits = re.search(r"row_splits\([^)]*\) \{(.*?)\n\}", text, re.S).group(1)
    assert "return want < most ? (want > 1 ? want : 1) : most;" in splits
    n_part = re.search(r"const size_t n_part = ([^;]+);", text).group(1)
    threads = const("kThreads")
    return {
        "threads": threads,
        "warps": threads // 32,
        "ctas_per_sm": const("kCtasPerSm"),
        "min_cols": const("kMinColsPerSplit"),
        "most": expr("row_splits", "most"),
        "want": expr("row_splits", "want"),
        "units": expr("auction_phase_default_ctas", "units"),
        "ctas_want": expr("auction_phase_default_ctas", "want"),
        "n_part": n_part,
    }


def _c_eval(expression: str, **env) -> int:
    py = expression.replace("(long long)", "").replace("(size_t)", "").replace("/", "//")
    return int(eval(py, {}, env))  # noqa: S307 (integer expressions of the .cu)


def row_splits(n: int, warps: int, M: int, min_cols: int) -> int:
    k = kernel_rules()
    most = _c_eval(k["most"], M=M, kMinColsPerSplit=min_cols)
    want = _c_eval(k["want"], warps=warps, n=n)
    return min(max(want, 1), most)


def default_ctas(Tp: int, M: int, min_cols: int, max_ctas: int) -> int:
    k = kernel_rules()
    units = _c_eval(k["units"], Tp=Tp, M=M, kMinColsPerSplit=min_cols)
    want = _c_eval(k["ctas_want"], units=units, kWarps=k["warps"])
    return max(1, want) if want < max_ctas else max_ctas


def n_part(ctas: int) -> int:
    return _c_eval(kernel_rules()["n_part"], ctas=ctas, kWarps=kernel_rules()["warps"])


# --------------------------------------------------------------------------
# The kernel's arithmetic


def merge(a, b):
    """The triple merge on numpy arrays (float32 best/second, int64 idx)."""
    ab, ai, as_ = a
    bb, bi, bs = b
    idx = np.where((bb > ab) | ((bb == ab) & (bi < ai)), bi, ai)
    second = np.maximum(np.minimum(ab, bb), np.maximum(as_, bs))
    return np.maximum(ab, bb), idx, second


def warp_reduce(best, idx, second):
    """One warp's triple of a sequence: element e goes to lane e % 32, each
    lane folds its elements in order, then the shuffle-down tree (a lane
    whose source is past 31 merges its own value, as __shfl_down_sync
    returns it); lane 0's triple."""
    k = -(-len(best) // 32)
    pad = k * 32 - len(best)
    lanes = [
        np.concatenate([x, np.full(pad, fill, x.dtype)]).reshape(k, 32)
        for x, fill in ((best, -np.inf), (idx, INT_MAX), (second, -np.inf))
    ]
    acc = tuple(x[0] for x in lanes)
    for r in range(1, k):
        acc = merge(acc, tuple(x[r] for x in lanes))
    src = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        take = np.where(src + off < 32, src + off, src)
        acc = merge(acc, tuple(x[take] for x in acc))
    return tuple(x[0] for x in acc)


def chunk_triple(v_row, p1, p2, c0, c1):
    cols = np.arange(c0, c1)
    x = v_row[c0:c1]
    return warp_reduce(x - p1[c0:c1], cols.astype(np.int64),
                       np.maximum(x - p2[c0:c1], FLOOR))


def slot_prices(row, S):
    """price1, its first slot, price2 (slot1 read as PRICE_LOCK), as the
    kernel's loops compute them."""
    pr1, s1 = row[0], 0
    for s in range(1, S):
        if row[s] < pr1:
            pr1, s1 = row[s], s
    pr2 = LOCK
    for s in range(S):
        if s != s1:
            pr2 = min(pr2, row[s])
    return np.float32(pr1), s1, np.float32(pr2)


def order_bits(x: np.float32) -> int:
    u = int(np.float32(x).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def from_order_bits(o: int) -> np.float32:
    u = (o & 0x7FFFFFFF) if o & 0x80000000 else (~o & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32)


# --------------------------------------------------------------------------
# The schedule


def twin_phase(price0, values, value_u, job_col, active, eps, max_iters, *, seed,
               min_cols=None, n_sm=N_SM):
    """(price, owner, assigned, iters, bidder_rows) by the kernel's schedule,
    its orders of work drawn from ``seed``."""
    k = kernel_rules()
    min_cols = min_cols or k["min_cols"]
    Tp, M = values.shape
    S = price0.shape[1]
    ctas = default_ctas(Tp, M, min_cols, n_sm * k["ctas_per_sm"])
    warps = ctas * k["warps"]
    eps = np.float32(eps)
    rng = np.random.default_rng(seed)

    price = price0.copy()
    owner = np.full((M, S), -1, np.int32)
    assigned = np.where(active, -1, 0).astype(np.int32)
    p1 = np.zeros(M, np.float32)
    p2 = np.zeros(M, np.float32)
    slot1 = np.zeros(M, np.int64)
    for m in range(M):
        p1[m], slot1[m], p2[m] = slot_prices(price0[m], S)
    key = np.zeros((2, M), dtype=object)  # 64-bit claims, as Python ints
    my_key = [0] * Tp
    lists = np.zeros((2, Tp), np.int64)
    bm_of = np.zeros((2, Tp), np.int64)
    row_cnt = np.zeros(Tp, np.int64)
    counts = [0, 0, 0]
    first = rng.permutation(np.flatnonzero(active))  # the set-up's pushes land in any order
    lists[0, : len(first)] = first
    counts[0] = len(first)

    it = rows = 0
    while True:
        n = counts[it % 3]
        if n == 0 or it >= max_iters:
            break
        rows += n
        par = it & 1
        # Phase 1: clear the previous iteration's claims, then bid.
        counts[(it + 1) % 3] = 0
        for i in range(counts[(it + 2) % 3]):
            if bm_of[par ^ 1, i] >= 0:
                key[par ^ 1, bm_of[par ^ 1, i]] = 0
        assert not any(key[par]), "a claim of two iterations ago was never cleared"
        splits = row_splits(n, warps, M, min_cols)
        assert splits == 1 or n * splits <= n_part(ctas), "partials overflow the workspace"
        chunk = -(-M // splits)
        part = {}
        for u in rng.permutation(n * splits):  # warps finish their units in any order
            i, c = divmod(int(u), splits)
            t = lists[par, i]
            tri = chunk_triple(values[t], p1, p2, c * chunk, min(M, c * chunk + chunk))
            if splits > 1:
                part[u] = tri
                row_cnt[i] += 1
                if row_cnt[i] < splits:
                    continue
                parts = [part[i * splits + c] for c in range(splits)]
                tri = warp_reduce(*(np.array([p[f] for p in parts]) for f in range(3)))
                row_cnt[i] = 0
            best, idx, second = tri
            if value_u[t] > best:
                assigned[t] = job_col[t]
                bm_of[par, i] = -1
            else:
                second_m = np.maximum(second, value_u[t])
                level = np.float32(np.float32(p1[idx] + np.float32(best - second_m)) + eps)
                my_key[i] = (order_bits(level) << 32) | (0xFFFFFFFF - int(t))
                bm_of[par, i] = idx
                key[par, idx] = max(key[par, idx], my_key[i])
        assert not row_cnt.any()

        # Phase 2: winners take their slot; losers and evictees bid again.
        nxt, won = [], set()
        bidders = set(lists[par, :n].tolist())
        for i in rng.permutation(n):
            bm = bm_of[par, i]
            if bm < 0:
                continue
            t = lists[par, i]
            if key[par, bm] != my_key[i]:
                nxt.append(t)
                continue
            assert bm not in won, "two winners on one machine"
            won.add(bm)
            s = slot1[bm]
            old = owner[bm, s]
            level = from_order_bits(my_key[i] >> 32)
            assert level > price[bm, s]
            price[bm, s], owner[bm, s], assigned[t] = level, t, bm
            if old >= 0:
                assert assigned[old] == bm and old not in bidders
                assigned[old] = -1
                nxt.append(old)
            p1[bm], slot1[bm], p2[bm] = slot_prices(price[bm], S)
        lists[par ^ 1, : len(nxt)] = nxt
        counts[(it + 1) % 3] = len(nxt)
        full = [slot_prices(price[m], S) for m in range(M)]
        assert np.array_equal(p1, [f[0] for f in full]) and np.array_equal(p2, [f[2] for f in full])
        assert np.array_equal(slot1, [f[1] for f in full])
        assert sorted(nxt) == np.flatnonzero((assigned < 0) & active).tolist()
        it += 1
    return price, owner, assigned, it, rows


# --------------------------------------------------------------------------
# Instances, as the solve paths build them


def instance(seed, T, Tp, M, S, *, exact=False, identical=False, forbid=0.1, jitter=9,
             n_jobs=3, levels=99):
    """(price0, values, value_u, job_col, active) of a round: costs in
    multiples of 10 with tie jitter (production) or scaled by T + 1 with
    identical rows (exact mode: price wars), forbidden columns, a task with
    every column forbidden, locked slots, and padding rows past T."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(1, levels + 1, size=(T, M)).astype(np.int64) * 10
    if identical:
        cost[:] = cost[0]
    if jitter:
        cost += r_auction._jitter_matrix_np(T, M, jitter)
    forbidden = rng.random((T, M)) < forbid
    if not identical:
        forbidden[0] = True
    unsched = rng.integers(400, 1500, size=T)
    scale = T + 1 if exact else 1
    values = np.full((Tp, M), NEG_VALUE, np.float32)
    values[:T] = np.where(forbidden, NEG_VALUE, (-cost * scale).astype(np.float32))
    value_u = np.zeros(Tp, np.float32)
    value_u[:T] = (-unsched * scale).astype(np.float32)
    job_col = np.full(Tp, M, np.int32)
    job_col[:T] = M + np.sort(rng.integers(0, n_jobs, size=T))
    active = np.arange(Tp) < T
    capacity = rng.integers(0, S + 1, size=M)
    price0 = np.where(np.arange(S)[None, :] >= capacity[:, None], LOCK, np.float32(0))
    return price0.astype(np.float32), values, value_u, job_col, active


CASES = {
    # Tp * Tp <= 4 M: the reference's (T, T) dominance table.
    "t_space": dict(T=7, Tp=8, M=40, S=2, levels=1, jitter=3),
    # Tp * Tp > 4 M: its segment max over machines.
    "m_space": dict(T=27, Tp=32, M=40, S=3),
    # Exact mode, identical rows of equal costs: every task wants every
    # machine alike, and equal bids are broken by task id.
    "price_war": dict(T=16, Tp=16, M=24, S=2, exact=True, identical=True, jitter=0,
                      forbid=0.0, n_jobs=1, levels=1),
    # The round's width: 49 chunks of 256 columns a row at the kernel's rule.
    "wide": dict(T=8, Tp=8, M=12_500, S=8),
}
MAX_ITERS = 500_000


@functools.lru_cache(maxsize=None)
def reference(case: str, max_iters: int):
    """The JAX reference's phase and the port's step-wise loop on CPU."""
    args = instance(7, **CASES[case])
    want = r_auction._auction_phase(*map(jnp.asarray, args), jnp.float32(1.0), max_iters)
    want = tuple(np.asarray(x) for x in want[:3]) + (int(want[3]),)
    got = ref.auction_phase_ref(*map(torch.from_numpy, args), 1.0, max_iters,
                                return_bidder_rows=True)
    plain = tuple(x.numpy() for x in got[:3]) + got[3:]
    for w, p in zip(want, plain):
        assert np.array_equal(w, p)
    return args, plain


def _assert_equal(got, want):
    for name, g, w in zip(("price", "owner", "assigned", "iters", "bidder_rows"), got, want):
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("min_cols", [None, 8])
@pytest.mark.parametrize("case", ["t_space", "m_space", "price_war"])
def test_twin_equals_reference_and_plain_loop(case, min_cols, seed):
    args, want = reference(case, MAX_ITERS)
    assert want[3] > 1 and want[3] < MAX_ITERS
    _assert_equal(twin_phase(*args, 1.0, MAX_ITERS, seed=seed, min_cols=min_cols), want)


def test_twin_at_the_rounds_width():
    args, want = reference("wide", MAX_ITERS)
    Tp, M = args[1].shape
    assert row_splits(Tp, default_ctas(Tp, M, 256, N_SM) * 16, M, 256) == 49
    _assert_equal(twin_phase(*args, 1.0, MAX_ITERS, seed=3), want)


@pytest.mark.parametrize("seed", range(2))
def test_twin_stops_at_the_cap(seed):
    full = reference("price_war", MAX_ITERS)[1]
    args, want = reference("price_war", 4)
    assert want[3] == 4 < full[3]
    assert (want[2] < 0).any()  # stopped with tasks unassigned
    _assert_equal(twin_phase(*args, 1.0, 4, seed=seed, min_cols=4), want)


def test_orders_of_work_change_nothing():
    args, _ = reference("m_space", MAX_ITERS)
    runs = [twin_phase(*args, 1.0, MAX_ITERS, seed=s, min_cols=4) for s in range(10, 13)]
    for run in runs[1:]:
        _assert_equal(run, runs[0])


def test_grid_and_split_rules():
    k = kernel_rules()
    assert k["threads"] % 32 == 0 and k["ctas_per_sm"] >= 1
    max_ctas = N_SM * k["ctas_per_sm"]
    assert default_ctas(1024, 12_500, k["min_cols"], max_ctas) == max_ctas
    assert default_ctas(8, 12_500, k["min_cols"], max_ctas) == 25
    assert default_ctas(8, 40, k["min_cols"], max_ctas) == 1
    # Every split of n rows fits the workspace's partials (2 per warp).
    for Tp, M in ((8, 12_500), (1024, 12_500), (2048, 12_500), (32, 40)):
        for min_cols in (k["min_cols"], 4):
            ctas = default_ctas(Tp, M, min_cols, max_ctas)
            warps = ctas * k["warps"]
            for n in range(1, Tp + 1):
                s = row_splits(n, warps, M, min_cols)
                assert 1 <= s <= -(-M // min_cols)
                assert s == 1 or n * s <= n_part(ctas)

"""repro_torch auction bid (plain version, its CPU dispatch, and the CUDA
kernel's merge algebra written out on tensors) against the reference's
oracle, exactly, the index included."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.auction_bid import ref as r_ref  # noqa: E402
from repro_torch.kernels.auction_bid import ops as t_ops  # noqa: E402
from repro_torch.kernels.auction_bid import ref as t_ref  # noqa: E402

BLOCK = 512  # the reference kernel's column block


def _check(values, p1, p2):
    want = [np.asarray(x) for x in r_ref.bid_top2_ref(*map(jnp.asarray, (values, p1, p2)))]
    args = [torch.from_numpy(x) for x in (values, p1, p2)]
    for got in (t_ref.bid_top2_ref(*args), t_ref.bid_top2_tree(*args), t_ops.bid_top2(*args)):
        assert got[0].dtype == torch.int32
        assert got[1].dtype == got[2].dtype == torch.float32
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w)


def _random(rng, T, C, spread=2**20):
    values = rng.integers(-spread, 0, size=(T, C)).astype(np.float32)
    p1 = rng.integers(0, 2**16, size=C).astype(np.float32)
    p2 = np.maximum(p1, rng.integers(0, 2**17, size=C)).astype(np.float32)
    return values, p1, p2


@pytest.mark.parametrize("T,C", [(1, 2), (5, 17), (32, 128), (50, 700), (128, 1024)])
def test_bid_matches_reference(T, C):
    _check(*_random(np.random.default_rng(T * 31 + C), T, C))


def test_bid_exact_ties_inside_and_across_blocks():
    rng = np.random.default_rng(11)
    T, C = 24, 3 * BLOCK + 37
    values, p1, p2 = _random(rng, T, C)
    top = np.float32(2**21)
    for r in range(T):
        a = int(rng.integers(0, C - 1))
        cols = {
            0: (a, a + 1),  # inside one block
            1: (a, (a + BLOCK) % C),  # across blocks
            2: (C - 1, 0),  # last and first column
        }[r % 3]
        for j in cols:
            values[r, j] = p1[j] + top
    values[-1] = p1 + np.float32(3.0)  # every column ties
    _check(values, p1, p2)


def test_bid_heavy_ties_small_range():
    rng = np.random.default_rng(5)
    values = rng.integers(-40, 0, size=(16, 2 * BLOCK + 3)).astype(np.float32)
    p1 = rng.integers(0, 8, size=values.shape[1]).astype(np.float32)
    p2 = np.maximum(p1, rng.integers(0, 16, size=values.shape[1])).astype(np.float32)
    _check(values, p1, p2)


def test_bid_single_column():
    _check(np.asarray([[-100.0], [-7.0]], np.float32),
           np.asarray([5.0], np.float32), np.asarray([9.0], np.float32))


def test_bid_price2_equals_price1():
    rng = np.random.default_rng(2)
    values, p1, _ = _random(rng, 9, 600)
    _check(values, p1, p1.copy())

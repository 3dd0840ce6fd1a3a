"""repro_torch costmap (plain version and its CPU dispatch) against the
reference's jnp oracle and its Pallas kernel in interpret mode, exactly."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import perf_model as r_perf  # noqa: E402
from repro.kernels.costmap import kernel as r_kernel  # noqa: E402
from repro.kernels.costmap import ref as r_ref  # noqa: E402
from repro_torch.core import perf_model as t_perf  # noqa: E402
from repro_torch.kernels.costmap import ops as t_ops  # noqa: E402
from repro_torch.kernels.costmap import ref as t_ref  # noqa: E402

R_LUT = r_perf.perf_lut_table()
T_LUT = t_perf.perf_lut_table()


def _check(perf_idx: np.ndarray, lat: np.ndarray) -> None:
    want = np.asarray(r_ref.costmap_ref(R_LUT, jnp.asarray(perf_idx), jnp.asarray(lat)))
    pallas = np.asarray(
        r_kernel.costmap_pallas(jnp.asarray(perf_idx), jnp.asarray(lat), interpret=True)
    )
    got = t_ref.costmap_ref(T_LUT, torch.from_numpy(perf_idx), torch.from_numpy(lat))
    assert got.dtype == torch.int32 and tuple(got.shape) == lat.shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pallas)
    via_ops = t_ops.costmap(T_LUT, torch.from_numpy(perf_idx), torch.from_numpy(lat))
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize(
    "T,M",
    [(1, 1), (3, 7), (8, 128), (17, 300), (64, 513), (256, 1024)],
)
def test_costmap_matches_reference(T, M):
    rng = np.random.default_rng(T * 1000 + M)
    perf_idx = rng.integers(0, 4, size=T).astype(np.int32)
    lat = rng.uniform(0, 1400, size=(T, M)).astype(np.float32)
    _check(perf_idx, lat)


def test_costmap_boundary_latencies():
    # Threshold edges, the LUT rounding boundary (45 -> 40 vs 50), the
    # table's ends and a negative latency, for every model.
    edges = np.asarray([0.0, 39.9, 44.9, 45.0, 45.1, 55.0, 995.0, 1005.0, -3.0],
                       np.float32)
    perf_idx = np.arange(4, dtype=np.int32)
    lat = np.tile(edges, (4, 1))
    _check(perf_idx, lat)

"""repro_torch.launch.rooftool against repro.launch.rooftool on the CPU.

The five cases of ``tests/test_rooftool.py``, each run through both
packages on the same inputs and compared with tolerance 0, except the
roofline terms: the port's constants are an H100's, the reference's a TPU
v5e's, so each package's terms are held to its own constants. Then
``comm_collectives`` on a dry reduce-scatter, under both conventions:
`Comm`'s (the input's bytes) and the reference's (the output's, as its
HLO parser reads them).
"""

import pytest

torch = pytest.importorskip("torch")

from repro.launch import rooftool as ref  # noqa: E402
from repro_torch.distributed.comm import DryComm  # noqa: E402
from repro_torch.launch import rooftool  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

HLO = """
HloModule jit_step

ENTRY %main {
  %p0 = bf16[128,1024]{1,0} parameter(0)
  %ag = bf16[2048,1024]{1,0} all-gather(%p0), replica_groups={}, dimensions={0}
  %ar = f32[256]{0} all-reduce(%x), to_apply=%add
  %rs = f32[64,32]{1,0} reduce-scatter(%y), dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(%z), source_target_pairs={{0,1}}
  %ags = bf16[4096,16]{1,0} all-gather-start(%w), dimensions={0}
  %agd = bf16[4096,16]{1,0} all-gather-done(%ags)
  %dot = f32[16,16]{1,0} dot(%a, %b)
  ROOT %t = tuple()
}
"""


def _collective_bytes():
    out = rooftool.collective_bytes(HLO)
    assert out == ref.collective_bytes(HLO)
    assert out["all-gather"] == 2048 * 1024 * 2 + 4096 * 16 * 2  # -start once, -done not
    assert out["reduce-scatter"] == 64 * 32 * 4
    assert out["count"] == 5  # dot not counted


def _shape_bytes():
    for s in ("(f32[2,2], bf16[4])", "pred[10]", "token[]", "s32[]", "f8e4m3[3,5]{1,0}"):
        assert rooftool._shape_bytes(s) == ref._shape_bytes(s), s
    assert rooftool._shape_bytes("(f32[2,2], bf16[4])") == 16 + 8
    assert rooftool._DTYPE_BYTES == ref._DTYPE_BYTES and rooftool.COLLECTIVES == ref.COLLECTIVES


def _cell_analysis():
    for mod in (rooftool, ref):
        c = mod.CellAnalysis(flops_dev=mod.PEAK_FLOPS,  # exactly 1 s of compute
                             bytes_dev=mod.HBM_BW * 2,  # 2 s of HBM
                             coll_bytes_dev=mod.ICI_BW * 3,  # 3 s on the slowest link
                             coll_by_type={}, chips=256)
        assert (c.compute_s, c.memory_s, c.collective_s) == pytest.approx((1.0, 2.0, 3.0))
        assert c.dominant == "collective" and c.bound_s == pytest.approx(3.0)
    args = dict(flops_dev=3e12, bytes_dev=4e9, coll_bytes_dev=5e7, coll_by_type={"count": 1},
                chips=8)
    got, want = rooftool.CellAnalysis(**args).summary(), ref.CellAnalysis(**args).summary()
    assert got.keys() == want.keys()
    for k in ("flops_dev", "bytes_dev", "coll_bytes_dev", "coll_by_type"):
        assert got[k] == want[k]
    # The port's terms on H100 constants (NVIDIA's data sheet; the NIC).
    assert (rooftool.PEAK_FLOPS, rooftool.PEAK_FLOPS_F32) == (989e12, 67e12)
    assert (rooftool.HBM_BW, rooftool.ICI_BW) == (3.35e12, 50e9)
    assert got["compute_s"] == 3e12 / 989e12 and got["memory_s"] == 4e9 / 3.35e12
    assert got["collective_s"] == 5e7 / 50e9 and got["dominant"] == "compute"


def _two_point():
    for f1, f2, n in ((10.0, 14.0, 1), (10.0, 14.0, 8), (14.0, 10.0, 5), (0, 7, 3)):
        assert rooftool.two_point(f1, f2, n) == ref.two_point(f1, f2, n)
    assert rooftool.two_point(10.0, 14.0, 8) == 38.0


def _model_flops():
    for n, d, kind in ((1e9, 1e6, "train"), (1e9, 1e6, "prefill"), (7.5e9, 4096, "decode")):
        assert rooftool.model_flops(n, d, kind) == ref.model_flops(n, d, kind)
    assert rooftool.model_flops(1e9, 1e6, "train") == pytest.approx(6e15)


CASES = {"collective_bytes": _collective_bytes, "shape_bytes": _shape_bytes,
         "cell_analysis": _cell_analysis, "two_point": _two_point, "model_flops": _model_flops}


@pytest.mark.parametrize("case", list(CASES))
def test_rooftool_matches_reference(case):
    CASES[case]()


def test_comm_collectives_on_a_dry_reduce_scatter():
    """A reduce-scatter of f32[256, 32] over a 4-wide ``model`` axis: `Comm`
    counts its input, the reference's HLO parser its f32[64, 32] output;
    ``comm_collectives`` of the dry `Comm`'s output bytes is the record the
    parser gives for that op."""
    comm = DryComm(make_mesh((2, 4), ("data", "model")), rank=5)
    out = comm.reduce_scatter(torch.zeros(256, 32), "model", 0)
    assert tuple(out.shape) == (64, 32)
    assert comm.bytes == {"reduce_scatter": 256 * 32 * 4}
    assert comm.out_bytes == {"reduce_scatter": 64 * 32 * 4}
    got = rooftool.comm_collectives(comm.out_bytes, sum(comm.calls.values()))
    assert got == ref.collective_bytes("%rs = f32[64,32]{1,0} reduce-scatter(%y), dimensions={0}")
    # The other kinds keep one convention, and map to the reference's keys.
    comm.all_gather(torch.zeros(3, 5), "data", 1)
    comm.all_reduce(torch.zeros(7), ("data", "model"))
    comm.ring_permute(torch.zeros(2, 2, dtype=torch.bfloat16), "model")
    comm.all_reduce(torch.zeros(7), ())  # an axis of no size: no collective
    got = rooftool.comm_collectives(comm.out_bytes, sum(comm.calls.values()))
    assert got == {"all-gather": 3 * 10 * 4, "all-reduce": 7 * 4, "reduce-scatter": 64 * 32 * 4,
                   "all-to-all": 0, "collective-permute": 2 * 2 * 2, "count": 4}
    assert {k: v for k, v in comm.bytes.items() if k != "reduce_scatter"} == {
        k: v for k, v in comm.out_bytes.items() if k != "reduce_scatter"}
    with pytest.raises(ValueError, match="gather"):
        rooftool.comm_collectives({"gather": 4})

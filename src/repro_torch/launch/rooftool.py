"""Roofline terms of one rank's step from the dry run (no wall clock).

Port of `repro.launch.rooftool`, on H100 constants. The reference reads
FLOPs and bytes from XLA's cost analysis and collective bytes from the
post-SPMD HLO text; the port's dry run (`repro_torch.launch.dryrun`)
counts FLOPs with `torch.utils.flop_counter.FlopCounterMode`, bytes with a
dispatch mode and collective bytes on a dry `Comm`
(`repro_torch.distributed.comm.DryComm`). `collective_bytes` still takes
HLO text; `comm_collectives` turns the port's bytes by collective kind
into the same record.

Convention: a collective's bytes are its OUTPUT's on this rank (the
reference parses each op's output shape). For an all-gather, all-reduce
or ring permute that is what `Comm.bytes` also counts; for a
reduce-scatter `Comm.bytes` counts the input (n times the output), so the
dry `Comm` keeps the output's bytes apart (``DryComm.out_bytes``).

Terms (seconds):
    compute    = FLOPs_dev / PEAK_FLOPS
    memory     = HBM_bytes_dev / HBM_BW
    collective = collective_bytes_dev / ICI_BW   (slowest-link proxy)
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping

# H100 SXM, NVIDIA's data sheet (dense, 700 W): bf16 on the tensor cores,
# the reference's constant being its chip's bf16 peak as well.
PEAK_FLOPS = 989e12
# float32 outside the tensor cores (same sheet): the rate of the port's f32
# products, which run with TF32 off.
PEAK_FLOPS_F32 = 67e12
HBM_BW = 3.35e12  # bytes/s, same sheet (PERF.md's kernel bounds use it)
# The slowest link an axis of the production meshes crosses: a 16-wide
# ``model`` axis spans two 8-GPU nodes, so its ring crosses the node's NIC,
# one 400 Gb/s NDR InfiniBand port per GPU = 50e9 bytes/s. Inside a node
# NVLink 4 gives 450 GB/s a direction.
ICI_BW = 50e9

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# The port's collective kinds (`Comm.bytes` keys) -> the reference's.
COMM_KINDS = {
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter": "reduce-scatter",
    "ring_permute": "collective-permute",
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    """Bytes of an HLO shape string like 'bf16[128,1024]{1,0}' or a tuple."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-device bytes by collective type, from post-SPMD HLO text."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for line in hlo_text.splitlines():
        s = line.strip()
        # '%name = <shape> <op>(' — match the op position to avoid hits in
        # metadata/comments.
        m = re.match(r"%?[\w.\-]+\s*=\s*(.+?)\s+([a-z\-]+)\(", s)
        if not m:
            continue
        op = m.group(2)
        base = next(
            (c for c in COLLECTIVES if op == c or op.startswith(c + "-")), None
        )
        if base is None:
            continue
        if op.endswith("-done"):
            continue  # paired with its -start; count the payload once
        out[base] += _shape_bytes(m.group(1))
        out["count"] += 1
    return out


def comm_collectives(bytes_by_kind: Mapping[str, int], count: int = 0) -> Dict[str, int]:
    """`collective_bytes`'s record from the port's bytes by collective kind
    (`COMM_KINDS`; the port has no all-to-all) and the number of collective
    calls. Pass output bytes (``DryComm.out_bytes``) for the reference's
    convention. A kind with no counterpart there (``gather``, to one rank)
    raises."""
    unknown = sorted(set(bytes_by_kind) - set(COMM_KINDS))
    if unknown:
        raise ValueError(f"collective kinds {unknown} have no counterpart in {COLLECTIVES}")
    out = {k: 0 for k in COLLECTIVES}
    for kind, n in bytes_by_kind.items():
        out[COMM_KINDS[kind]] += int(n)
    out["count"] = int(count)
    return out


@dataclasses.dataclass
class CellAnalysis:
    flops_dev: float
    bytes_dev: float
    coll_bytes_dev: float
    coll_by_type: Dict[str, int]
    chips: int

    @property
    def compute_s(self) -> float:
        return self.flops_dev / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_dev / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_dev / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def summary(self) -> Dict:
        return {
            "flops_dev": self.flops_dev,
            "bytes_dev": self.bytes_dev,
            "coll_bytes_dev": self.coll_bytes_dev,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "coll_by_type": self.coll_by_type,
        }


def two_point(f1: float, f2: float, n_blocks: int) -> float:
    """total(n) from measurements at 1 and 2 scanned superblocks."""
    per_block = max(0.0, f2 - f1)
    return f1 + per_block * (n_blocks - 1)


def model_flops(
    n_params_active: float, tokens: float, kind: str
) -> float:
    """Analytic MODEL_FLOPS: 6ND train, 2ND forward-only."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens

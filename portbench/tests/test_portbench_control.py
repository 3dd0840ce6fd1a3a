"""The control at a size a CPU test holds: the reference computed in TF32
(each product's operands rounded to TF32 on the CPU) put in the program's
place reads well above the program's own readings, on three seeds, as the
chip's readings at the cells' own sizes do (`calibrate.py`, PERF.md); and
the planted half-batch fault of a training cell reads above them too."""

from __future__ import annotations

import pytest
import torch

import pb_tiny

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def _readings(cell_name, seed, control, traffic=(), **arch):
    import calibrate
    import run as bench
    from harness import spec

    cell = pb_tiny.shrink(spec.load_cell(cell_name), **arch)
    cell.traffic.update(traffic)
    kind = cell.traffic["driver"]
    driver = bench.load_file(bench.HERE / "drivers" / f"{kind}.py", f"pb_ctl_{kind}")
    return calibrate.seed_readings(driver, cell, seed, control, torch.device("cpu"))


def _compared(cell_name):
    from harness import spec

    return set(spec.load_cell(cell_name).limits)


@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_and_half_batch_read_above_the_program(seed):
    cell = "qwen3-0.6b.train-4k"
    prog = _readings(cell, seed, False)["program"]
    rec = _readings(cell, seed, True)
    for what in ("control", "half_batch"):
        assert any(rec[what][k] >= 3 * prog[k] and rec[what][k] > 0
                   for k in _compared(cell)), (what, rec[what], prog)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["qwen3-0.6b.prefill-long", "dbrx-132b.chat"])
def test_serving_control_reads_above_the_program(cell, seed):
    # Enough served positions (4 x 32 of each length) that TF32's rounding
    # moves a token or a route somewhere, as it does at the cells' sizes.
    rec = _readings(cell, seed, True, dict(batch=4, gen_tokens=32, check_requests_per_len=4),
                    vocab_size=2048, d_model=128, head_dim=32)
    keys = _compared(cell)
    assert any(rec["control"][k] >= 3 * rec["program"][k] and rec["control"][k] > 0
               for k in keys), rec

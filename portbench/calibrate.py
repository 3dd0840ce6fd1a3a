"""The readings that a cell's correctness limits are set from, on the chip
at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--out FILE]

For each of ``--seeds`` the program's readings (the lower end: the program
against the reference, as a run compares them), and for each of
``--control-seeds`` the control's (the upper end): the reference computed
in TF32 put in the program's place (serving: it serves each sampled
request greedily with its own routing, and the float32 reference judges
its tokens, logits and routes as it judges the program's). A training
cell also reads the
planted fault of half the batch left out (the reference on the first half
of each batch's rows); a step that leaves the state unchanged reads 1 on
the parameters' change and needs no run. A serving cell's program runs
one cycle of its mix (every prompt length once) and compares as many
requests as a run does. Prints one JSON line per seed and a summary line:
each number's lower reading (largest over the program's seeds) and upper
readings (smallest over the control's, and the fault's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run as bench  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def seed_readings(driver, cell, seed: int, control: bool, device) -> dict:
    """One seed's readings: the program's against the reference, or (with
    ``control``) the control's and, for training, the half-batch fault's."""
    import torch

    from harness.bench import Run

    t0 = time.perf_counter()
    run = Run(cell, seed, 0.0, False, device, t0)
    rec = {"cell": cell.name, "seed": seed, "control": control}
    if cell.traffic["driver"] == "train":
        if not control:
            prog = driver.setup(run)
            prog.clear()
            rec["program"] = driver.readings(run.facts["program"],
                                             driver.reference_readings(run))
        else:
            f32 = driver.reference_readings(run, "f32")
            rec["control"] = driver.readings(driver.reference_readings(run, "tf32"), f32)
            half = slice(0, cell.traffic["batch"] // 2)
            rec["half_batch"] = driver.readings(driver.reference_readings(run, "f32", half), f32)
    else:
        prog = driver.setup(run)
        driver.measure(run, prog, cycles=1)
        params = prog["params"]
        prog.clear()
        got = driver.compare(run, params, control)
        del params
        rec["program"] = got["f32"]
        if control:
            rec["control"] = got["tf32"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(bench.ROOT / "src"))
    cell = spec.load_cell(args.workload)
    kind = cell.traffic["driver"]
    driver = bench.load_file(HERE / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    lines = []

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(rec)
        if out:
            out.write(line + "\n")
            out.flush()

    jobs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    for seed, control in jobs:
        emit(seed_readings(driver, cell, seed, control, device))

    summary = {"cell": cell.name, "lower": {}, "upper": {}}
    for rec in lines:
        if "program" in rec:
            for k, v in rec["program"].items():
                summary["lower"][k] = max(summary["lower"].get(k, 0.0), v)
        for what in ("control", "half_batch"):
            if isinstance(rec.get(what), dict):
                for k, v in rec[what].items():
                    key = f"{k}.{what}"
                    summary["upper"][key] = min(summary["upper"].get(key, float("inf")), v)
    summary["device"] = torch.cuda.get_device_name(device)
    emit(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``src/repro_torch``).
The cell's files are found by name (`harness.spec`); its driver
(``drivers/<kind>.py``) sets up the program, measures ``--seconds`` of
closed-loop work, and compares what the window produced with the plain
reference (``reference/``). ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, each read by
``metrics/<name>.py`` from a trace of the window. The numbers compared go
to standard error as its last lines, and the last line of standard output
is one JSON object. A run without a CUDA card, with fewer cards than the
cell asks for, without the port, or with a JAX package loaded exits with
another code than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Every build and kernel cache inside the checkout, at fixed paths.
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "portbench" / _dir)
os.environ["USE_FLAX"] = "0"  # keep libraries that can load JAX from loading it

sys.path.insert(0, str(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(run, torch) -> dict:
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                    else "cpu"),
           "count": run.cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    return dev


def execute(argv=None, *, need_chip: bool = True, cell_override=None, faults=()):
    """One run; returns (exit code, result dict or None). The harness's
    own tests pass ``need_chip=False`` (the CPU, plain kernel versions),
    ``cell_override`` (a function of the `Cell`) and ``faults``."""
    args = parse(argv)
    from harness import spec
    from harness.bench import Run

    cell = spec.load_cell(args.workload)
    if cell_override is not None:
        cell = cell_override(cell)
    import torch

    if need_chip:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device", file=sys.stderr)
            return 2, None
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: {cell.workload['config']} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} here", file=sys.stderr)
            return 2, None
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the port is not in this checkout ({e})", file=sys.stderr)
        return 3, None
    seed = args.seed % 2 ** 63
    run = Run(cell, seed, args.seconds, bool(args.trace), device, T_START, faults=tuple(faults))
    driver = load_file(HERE / "drivers" / f"{cell.traffic['driver']}.py",
                       f"portbench_driver_{cell.traffic['driver']}")
    driver.run(run)

    result = {"correct": None, "attempted": run.attempted, "failed": run.failed}
    if run.trace:
        metrics = {}
        from harness import trace as trace_mod

        w = trace_mod.window(run.trace_data)
        run.facts["window_ns"] = w
        for m in cell.per_layer:
            reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                               "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = device_info(run, torch)
        if w is not None:
            dev["busy_s"] = run.trace_data.busy_s(*w)
            dev["window_s"] = (w[1] - w[0]) / 1e9
            result["breakdown"] = {"device_ops": trace_mod.top_ops(run.trace_data, *w),
                                   "idle_gaps": trace_mod.idle_gaps(run.trace_data, *w)}
    else:
        e2e = dict(run.end_to_end, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
        dev = device_info(run, torch)
    ok = run.failed == 0 and all(math.isfinite(v) and v <= lim for v, lim in run.checks.values())
    result.update(correct=bool(ok and run.checks), metrics=metrics, device=dev,
                  check_s=run.facts.get("check_s"))
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    bad = forbidden_modules()  # last: the readers have loaded what they load
    if bad:
        print(f"portbench: loaded {bad}, modules of JAX or the JAX package", file=sys.stderr)
        return 4, None
    return 0, result


def main(argv=None) -> int:
    code, result = execute(argv)
    if result is None:
        return code
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())

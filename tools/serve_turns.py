#!/usr/bin/env python3
"""One serving phase of ``chip_smoke.py`` from two checkouts, in turns.

    python3 tools/serve_turns.py BEFORE AFTER [--arch rwkv6-7b]

BEFORE and AFTER are checkouts of the repository (for instance a
``git archive`` of the parent commit and of the change, unpacked into an
ignored directory). Each turn runs that checkout's own
``chip_smoke.phase_serve`` for ``--arch`` at its full-width serving shape
(``RECURRENT_SERVES``, or the qwen3-0.6b serve) in a fresh process, in the
order BEFORE, AFTER, AFTER, BEFORE, so that both meet the card and its host
in the same states. Prints one JSON line per turn: prefill seconds, decode
ms per step, tokens per second, launches, the card's busy ms per decode
step, and the port kernels' device ms per call in prefill and decode where
that checkout's profile reports them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

CODE = """
import chip_smoke as c
arch = {arch!r}
kw = dict(c.RECURRENT_SERVES[arch]) if arch in c.RECURRENT_SERVES else {{}}
c.phase_serve(arch=arch, **kw)
"""


def turn(label: str, path: str, arch: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CODE.format(arch=arch)], cwd=path,
                          capture_output=True, text=True, timeout=1800)
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("{") and '"serve' in ln[:30]), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"{label} ({path}) failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    d = json.loads(line)
    prof = d["decode_profile"]
    return {
        "checkout": label, "path": path, "phase": d["phase"], "prefill_s": d["prefill_s"],
        "decode_ms_per_step": d["decode_ms_per_step"], "tokens_per_s": d["tokens_per_s"],
        "launches": d["launches"], "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "prefill_kernels": prof.get("prefill_kernels_device_ms_per_call"),
        "decode_kernels": prof.get("kernels_device_ms_per_call"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--arch", default="rwkv6-7b")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for label, path in (("before", args.before), ("after", args.after), ("after", args.after),
                        ("before", args.before)):
        print(json.dumps(turn(label, path, args.arch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

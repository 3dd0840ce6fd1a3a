#!/usr/bin/env python3
"""Two reads of one train step's CUDA trace, on the card: the sum of the
CUDA kernels' device time that `chip_smoke.py`'s `_train_profile` takes
as the step's busy time, once through ``key_averages()`` and once through
the trace's own events (``prof.profiler.kineto_results.events()``).

    python3 tools/profile_read.py

For qwen3-0.6b (8 layers) and rwkv6-7b (1 layer) at full width, 8 x
1,024, f32, remat: each read's busy ms, kernel count and seconds, whether
the kernel names agree, and the largest difference of one name's summed
ms. Prints one JSON line.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

RUNS = (("qwen3-0.6b", 8), ("rwkv6-7b", 1))  # (arch, layers)
BATCH, SEQ = 8, 1024


def _reads(prof) -> dict:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    t0 = time.perf_counter()
    own, own_n = collections.Counter(), 0
    for e in prof.profiler.kineto_results.events():
        ms = e.duration_ns() / 1e6
        if e.device_type() == cuda and ms > 0:
            own[e.name()] += ms
            own_n += 1
    own_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    avg, avg_n = {}, 0
    for evt in prof.key_averages():
        dev = getattr(evt, "device_time_total", 0.0) or 0.0
        if getattr(evt, "device_type", None) == cuda and dev > 0:
            avg[evt.key] = dev / 1e3
            avg_n += evt.count
    avg_s = time.perf_counter() - t0
    return {"events": [sum(own.values()), own_n, own_s],
            "key_averages": [sum(avg.values()), avg_n, avg_s],
            "names_equal": set(own) == set(avg),
            "worst_name_ms_diff": max(abs(own[n] - v) for n, v in avg.items())}


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch import configs
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import build_train_step

    if not torch.cuda.is_available():
        print("profile_read: needs a CUDA GPU", file=sys.stderr)
        return 1
    chip_smoke.phase_device()
    chip_smoke.phase_build()
    out = {}
    for arch, layers in RUNS:
        cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
        lm = LM(cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, SEQ), device="cuda")}
        opt = AdamW(AdamWConfig())
        state = opt.init(lm.init(torch.Generator(device="cuda").manual_seed(0), torch.float32))
        step = build_train_step(lm, opt, remat=True)
        step(state, batch)  # warm-up
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            float(step(state, batch)[1]["loss"])
        out[arch] = _reads(prof)
        del state
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

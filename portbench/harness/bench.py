"""One run of a cell: what the drivers fill in and the readers read.

Spans are the benchmark's own, recorded from its files around the calls
into the program's layers (`span`): a `torch.profiler.record_function`
range named ``portbench.<name>``, which a traced run's trace holds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from .spec import Cell
from .trace import SPAN_PREFIX, Trace


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t_start: float  # perf_counter at process start
    setup_s: Optional[float] = None
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: Optional[int] = None
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace_data: Optional[Trace] = None
    faults: Tuple[str, ...] = ()  # planted faults, for the harness's own tests

    @property
    def arch(self) -> Dict[str, Any]:
        return self.cell.arch


@contextlib.contextmanager
def span(name: str):
    import torch

    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@contextlib.contextmanager
def profiled(run: Run):
    """Around the measured window: a CPU and CUDA trace when ``run.trace``,
    read into ``run.trace_data`` when it stops."""
    if not run.trace:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import trace as trace_mod

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    t0 = time.perf_counter()
    run.trace_data = trace_mod.read(prof)
    run.facts["trace_read_s"] = time.perf_counter() - t0


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_arch(arch: Dict[str, Any]):
    """The port's `ArchConfig` for the configuration's ``arch`` fields."""
    from repro_torch.configs.base import ArchConfig

    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in arch.items()})


def check_layout(lm, params) -> None:
    """The benchmark's weights have the shapes the port's model declares."""
    from repro_torch.models.layers import tree_map

    from . import weights

    want = tree_map(lambda p: tuple(p.shape), lm.param_specs())
    got = weights.shapes(params)
    if want != got:
        raise ValueError(f"weight layout differs from the port's param_specs:\n{got}\n{want}")


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile, linear between order statistics."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), q))

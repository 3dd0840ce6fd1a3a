"""Optimizer and learning-rate schedule (port of `repro.optim`).

Gradient compression (`repro.optim.compression`) belongs to the
data-parallel slice of the port (ROADMAP.md, module queue).
"""

from .adamw import AdamW, AdamWConfig, TrainState  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401

"""Optimizer, learning-rate schedule and int8 error-feedback gradient
compression (port of `repro.optim`)."""

from .adamw import AdamW, AdamWConfig, TrainState  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401

"""The LM substrate, dense serving path: layers, attention, blocks, LM."""

from .lm import LM  # noqa: F401

"""The one traffic generator: token batches from the seed and a mix's
parameters.

`train_batch` is the arithmetic of the port's synthetic pipeline
(`src/repro_torch/data/pipeline.py`, ``SyntheticLMData.batch`` in its
``uniform`` mode, itself a copy of the JAX package's), frozen here: batch
``step`` is i.i.d. tokens from numpy's Philox with key ``seed`` and
counter ``[0, 0, step, 0]``, so every step's rows differ and a seed
replays its stream. Serving prompts take counter ``[0, 1, i, 0]`` for
batch ``i``.

A serving mix's batches run in cycles of its ``prompt_lens``, one length a
batch (a length-bucketing batcher's groups), in the same order for every
seed: the seed draws the tokens and the weights, and every seed does the
same work.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=int(seed), counter=[0, stream, index, 0]))


def train_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int) -> np.ndarray:
    """(batch, seq_len) int32 tokens of train step ``step``."""
    return _rng(seed, 0, step).integers(0, vocab, size=(batch, seq_len), dtype=np.int32)


def prompt_len(traffic: Dict[str, Any], i: int) -> int:
    lens = traffic["prompt_lens"]
    return int(lens[i % len(lens)])


def prompts(seed: int, i: int, traffic: Dict[str, Any], vocab: int) -> np.ndarray:
    """(batch, prompt_len) int32 prompts of serving batch ``i``."""
    return _rng(seed, 1, i).integers(0, vocab, size=(traffic["batch"], prompt_len(traffic, i)),
                                     dtype=np.int32)


def check_rows(seed: int, i: int, batch: int, n: int) -> np.ndarray:
    """The rows of serving batch ``i`` whose logits a run keeps for its
    check: ``n`` of ``batch``, drawn from the seed before the batch is sent."""
    return np.sort(_rng(seed, 4, i).choice(batch, size=min(n, batch), replace=False))


def sample_rng(seed: int) -> np.random.Generator:
    """The stream that draws which finished requests the check compares."""
    return _rng(seed, 2, 0)

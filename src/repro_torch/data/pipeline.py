"""Deterministic synthetic token pipeline with per-host sharded loading.

A numpy copy of `repro.data.pipeline` (which imports no jax, but
importing it would pull in the reference package); its batches equal the
reference's element for element.

Two stream modes:
  uniform - i.i.d. tokens (throughput benchmarking; shape exercises).
  markov  - a fixed random first-order process, so models can actually
            learn structure and examples show decreasing loss.

Determinism: batch(step) is a pure function of (seed, step, host shard) via
numpy Philox counters: restarts replay the exact stream (a checkpoint
stores only ``step``). A host loads only its shard: ``batch(step, host_id,
n_hosts)`` returns global_batch / n_hosts rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "markov"  # uniform | markov
    markov_states: int = 64


class SyntheticLMData:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.mode == "markov":
            rng = np.random.default_rng(cfg.seed ^ 0xC0FFEE)
            k = cfg.markov_states
            # Sparse-ish row-stochastic transition matrix over a small state
            # space, mapped onto the vocab by modulo.
            logits = rng.normal(0, 2.0, size=(k, k))
            self.trans = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            self.trans_cdf = np.cumsum(self.trans, axis=1)

    def batch(self, step: int, host_id: int = 0, n_hosts: int = 1) -> dict:
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over "
                             f"{n_hosts} hosts")
        local = cfg.global_batch // n_hosts
        rng = np.random.Generator(
            np.random.Philox(key=cfg.seed, counter=[0, 0, step, host_id])
        )
        if cfg.mode == "uniform":
            toks = rng.integers(
                0, cfg.vocab_size, size=(local, cfg.seq_len), dtype=np.int32
            )
            return {"tokens": toks}
        k = cfg.markov_states
        state = rng.integers(0, k, size=(local,))
        toks = np.empty((local, cfg.seq_len), np.int32)
        u = rng.random(size=(local, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t] = state % cfg.vocab_size
            rows = self.trans_cdf[state]
            state = (rows < u[:, t : t + 1]).sum(axis=1)
        return {"tokens": toks}


def pack_documents(
    docs: list[np.ndarray], seq_len: int, eos: int, pad: Optional[int] = None
) -> np.ndarray:
    """Pack variable-length documents into fixed-length rows with EOS."""
    pad = eos if pad is None else pad
    rows, cur = [], []
    for d in docs:
        cur.extend(d.tolist() + [eos])
        while len(cur) >= seq_len:
            rows.append(cur[:seq_len])
            cur = cur[seq_len:]
    if cur:
        rows.append(cur + [pad] * (seq_len - len(cur)))
    return np.asarray(rows, np.int32)

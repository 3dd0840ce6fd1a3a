"""Plain PyTorch versions of the auction bidding reduction (any device).

Given the value matrix V (T, C), per-column lowest slot price `price1` and
second-lowest slot price `price2`, each row's bid needs:

  best column  j* = argmax_j (V[t,j] - price1[j])     first index on ties
  best value   v1 = max_j    (V[t,j] - price1[j])
  second value v2 = max( max_{j != j*} (V[t,j] - price1[j]),
                         V[t,j*] - price2[j*] )

The runner-up may be the same machine's next-cheapest slot (Bertsekas &
Castanon 1989). `bid_top2_ref` is the reference's `bid_top2_ref`, op for
op, and the version the CUDA kernel is checked against. `bid_top2_tree` is
the kernel's own algebra (per-column seed triples combined by its merge in
a pairwise tree) written out on tensors, so the CPU tests hold that algebra
against `bid_top2_ref` where the kernel itself cannot run.
"""

from __future__ import annotations

import torch

NEG_INF = -(2.0**62)


def bid_top2_ref(values, price1, price2):
    T, C = values.shape
    v1 = values - price1[None, :]
    best_idx = torch.argmax(v1, dim=1)
    best_val = torch.amax(v1, dim=1)
    cols = torch.arange(C, device=values.device)
    neg = torch.tensor(NEG_INF, dtype=values.dtype, device=values.device)
    masked = torch.where(cols[None, :] == best_idx[:, None], neg, v1)
    runner_other = torch.amax(masked, dim=1)
    rows = torch.arange(T, device=values.device)
    runner_same = values[rows, best_idx] - price2[best_idx]
    second_val = torch.maximum(runner_other, runner_same)
    return best_idx.to(torch.int32), best_val, second_val


def _merge(a, b):
    ab, ai, as_ = a
    bb, bi, bs = b
    idx = torch.where((bb > ab) | ((bb == ab) & (bi < ai)), bi, ai)
    second = torch.maximum(torch.minimum(ab, bb), torch.maximum(as_, bs))
    return torch.maximum(ab, bb), idx, second


def bid_top2_tree(values, price1, price2):
    """The CUDA kernel's reduction: seed each column with
    (V - p1, j, max(V - p2, -2^62)) and merge pairwise until one triple per
    row is left. Equal to `bid_top2_ref` whenever price2 >= price1."""
    T, C = values.shape
    neg = torch.tensor(NEG_INF, dtype=values.dtype, device=values.device)
    best = values - price1[None, :]
    second = torch.maximum(values - price2[None, :], neg)
    idx = torch.arange(C, dtype=torch.int32, device=values.device).expand(T, C)
    while best.shape[1] > 1:
        if best.shape[1] % 2:  # pad with the merge's identity
            pad = (0, 1)
            best = torch.nn.functional.pad(best, pad, value=float("-inf"))
            second = torch.nn.functional.pad(second, pad, value=float("-inf"))
            idx = torch.nn.functional.pad(idx, pad, value=torch.iinfo(torch.int32).max)
        best, idx, second = _merge(
            (best[:, 0::2], idx[:, 0::2], second[:, 0::2]),
            (best[:, 1::2], idx[:, 1::2], second[:, 1::2]),
        )
    return idx[:, 0].contiguous(), best[:, 0].contiguous(), second[:, 0].contiguous()

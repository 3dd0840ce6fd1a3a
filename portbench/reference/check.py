"""The numbers that decide ``correct``, from the program's outputs and the
reference's.

Training: per leaf (each layer's slice of a stacked tensor is a leaf), the
gap between the program's norm and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf; the worst leaf
counts. Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of both the
gradient and the change (`moving`).

Serving: the widest gap by which a served token's reference logit lies
below the reference's best at its position, and the widest distance
between the logits each token was drawn from and the reference's. Routing: the widest amount by which an
expert the program chose scores below the reference's K-th best, or below
the expert chosen after it, in router logits.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional

import torch

ZERO_GRAD = 1e-3  # a leaf under this share of the median leaf's gradient norm


def leaf_norms(tree, stacked_key: str = "blocks") -> Dict[str, float]:
    """{leaf name: float64 norm}; each layer of a stacked leaf its own."""
    from .lm import leaves

    norms: Dict[str, torch.Tensor] = {}
    for path, t in leaves(tree):
        name = ".".join(path)
        if path[0] == stacked_key:
            per = torch.linalg.vector_norm(t.detach().double().reshape(t.shape[0], -1), dim=1)
            for l, v in enumerate(per):
                norms[f"{name}[{l}]"] = v
        else:
            norms[name] = torch.linalg.vector_norm(t.detach().double())
    vals = torch.stack(list(norms.values())).cpu().tolist()
    return dict(zip(norms, vals))


def moving(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= ZERO_GRAD * med]


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               names: Optional[Iterable[str]] = None) -> float:
    names = list(names) if names is not None else list(ref)
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def served_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """ref_logits (N, V) at the positions that produced ``tokens`` (N,)."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.long().to(ref_logits.device)[:, None])[:, 0]
    return float((best - got).max())


def logit_err(ref_logits: torch.Tensor, logits) -> float:
    """The widest distance between the logits a token was drawn from and
    the reference's, over every position and vocabulary entry."""
    got = torch.as_tensor(logits, dtype=torch.float32).to(ref_logits.device)
    return float((got - ref_logits.float()).abs().max())


def route_gap(router_logits: List[torch.Tensor], choices: List[torch.Tensor]) -> float:
    """router_logits per layer (T, E) from the reference; choices (T, K)
    in the order the router ranked them."""
    worst = 0.0
    for lg, ch in zip(router_logits, choices):
        lg = lg.float()
        ch = ch.long().to(lg.device)
        K = ch.shape[1]
        kth = torch.sort(lg, dim=-1, descending=True).values[:, K - 1]
        picked = lg.gather(1, ch)
        worst = max(worst, float((kth - picked.min(dim=1).values).clamp(min=0).max()))
        if K > 1:
            worst = max(worst, float((picked[:, 1:] - picked[:, :-1]).clamp(min=0).max()))
    return worst

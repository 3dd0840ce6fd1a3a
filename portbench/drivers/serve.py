"""The serving driver: the port's `serve_batch` on batches of one prompt
length, in closed loop.

One batch is in flight at a time; batches run in cycles of the mix's
``prompt_lens``, and the cycle in flight when ``--seconds`` have passed
finishes and counts, so that every run does whole cycles of the same work.
The benchmark wraps the model's ``prefill`` and ``decode_step`` (spans;
the first decode call of a batch waits for the card and stamps the first
token: time to first token is taken on the benchmark's own clock), and
keeps on the card, from what those calls return, the logits of the rows
of each batch that the check may compare (``check_rows_per_batch``, drawn
from the seed before the batch is sent). For an MoE model it also keeps a
copy of what the port's dispatch returns (each group's experts in sorted
order and the sort's permutation), so that the reference can follow the
routing the program chose and hold each choice to its own router scores
(see PERF.md); a run whose dispatch records do not come one an MoE layer
a step stops without a result.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from harness import kinds, traffic as tr, weights
from harness.bench import (Run, check_layout, percentile, profiled, program_arch, span,
                           synchronize)


class _Hooks:
    """Spans around the model's calls, the first-token stamp, the kept
    rows' logits, and the MoE dispatch's records."""

    def __init__(self, lm, device, moe: bool):
        self.device = device
        self.start(None)
        prefill, decode = lm.prefill, lm.decode_step

        def keep(out):
            if self.rows is not None:
                self.logits.append(out[0].index_select(0, self.rows))
            return out

        def prefill_hook(*a, **k):
            with span("prefill"):
                return keep(prefill(*a, **k))

        def decode_hook(*a, **k):
            if self.first is None:
                synchronize(self.device)
                self.first = time.perf_counter()
            with span("decode"):
                return keep(decode(*a, **k))

        lm.prefill, lm.decode_step = prefill_hook, decode_hook
        if moe:
            from repro_torch.models import blocks

            dispatch = getattr(blocks._moe_dispatch, "portbench_original", blocks._moe_dispatch)

            def dispatch_hook(cfg, router, xt):
                buf, meta = dispatch(cfg, router, xt)
                if self.rows is not None:
                    self.routes.append((meta[0].clone(), meta[5].clone()))
                return buf, meta

            dispatch_hook.portbench_original = dispatch
            blocks._moe_dispatch = dispatch_hook

    def start(self, rows) -> None:
        """A new batch; ``rows`` (an index tensor on the card) are the rows
        kept for the check, or None."""
        self.first, self.routes, self.logits, self.rows = None, [], [], rows


def _rows(run: Run, i: int, batch: int) -> np.ndarray:
    return tr.check_rows(run.seed, i, batch, run.cell.traffic["check_rows_per_batch"])


def setup(run: Run) -> Dict[str, Any]:
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, a = run.cell.traffic, run.arch
    lm = LM(program_arch(a))
    params = weights.make(a, run.seed, run.device)
    check_layout(lm, params)
    hooks = _Hooks(lm, run.device, kinds.has(a, "moe"))
    serve = serve_batch
    if "alter_token" in run.faults:
        def serve(*args, **kw):
            out = serve_batch(*args, **kw)
            out[:, 0] = (out[:, 0] + 1) % a["vocab_size"]
            return out
    # Warm-up: one batch of each of the mix's prompt lengths, a few tokens.
    warm = np.random.Generator(np.random.Philox(key=run.seed, counter=[0, 3, 0, 0]))
    for j, P in enumerate(t["prompt_lens"]):
        hooks.start(torch.as_tensor(_rows(run, j, t["batch"]), device=run.device))
        prompts = warm.integers(0, a["vocab_size"], size=(t["batch"], P), dtype=np.int32)
        serve(lm, params, prompts, t["warm_gen_tokens"], timings={})
    hooks.start(None)
    return {"lm": lm, "params": params, "hooks": hooks, "serve": serve}


def measure(run: Run, prog: Dict[str, Any], cycles: int = 0) -> None:
    """Whole cycles until ``run.seconds`` have passed (or ``cycles`` of them)."""
    t, a = run.cell.traffic, run.arch
    lm, params, hooks, serve = prog["lm"], prog["params"], prog["hooks"], prog["serve"]
    batches: List[Dict[str, Any]] = []
    n_len = len(t["prompt_lens"])
    synchronize(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    with profiled(run), span("window"):
        t0 = time.perf_counter()
        i = 0
        while True:
            for _ in range(n_len):
                prompts = tr.prompts(run.seed, i, t, a["vocab_size"])
                rows = _rows(run, i, prompts.shape[0])
                hooks.start(torch.as_tensor(rows, device=run.device))
                timings: Dict[str, float] = {}
                submit = time.perf_counter()
                with span("batch"):
                    out = serve(lm, params, prompts, t["gen_tokens"],
                                temperature=t["temperature"], timings=timings)
                done = time.perf_counter()
                run.attempted += prompts.shape[0]
                batches.append({"i": i, "P": prompts.shape[1], "B": prompts.shape[0],
                                "gen": t["gen_tokens"], "submit": submit, "first": hooks.first,
                                "done": done, "timings": timings, "tokens": out,
                                "rows": rows.tolist(), "logits": hooks.logits,
                                "routes": hooks.routes})
                i += 1
            elapsed = time.perf_counter() - t0
            if (cycles and i >= cycles * n_len) or (not cycles and elapsed >= run.seconds):
                break
        t1 = time.perf_counter()
    hooks.start(None)
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)
    tokens = sum(b["B"] * (b["P"] + b["gen"]) for b in batches)
    ttft = [(b["first"] - b["submit"]) * 1e3 for b in batches for _ in range(b["B"])]
    run.end_to_end.update(
        serve_tokens_per_s=tokens / (t1 - t0),
        ttft_p95_ms=percentile(ttft, 95),
        tpot_ms=1e3 * sum(b["done"] - b["first"] for b in batches)
        / sum(b["gen"] - 1 for b in batches))
    run.facts.update(batches=batches, window=(t0, t1))


def _routes_of(run: Run, b: Dict[str, Any], row: int) -> List[torch.Tensor]:
    """The experts the program chose for request ``row`` of batch ``b``,
    per MoE layer: (P + gen - 1, K), in the order the router ranked them."""
    L, K = kinds.layers(run.arch).count("moe"), run.arch["experts_per_token"]
    P, B = b["P"], b["B"]
    recs = b["routes"]
    want = [B * P * K] + [B * K] * (b["gen"] - 1)
    if len(recs) != L * b["gen"] or any(
            e.numel() != want[n // L] or e.shape != o.shape for n, (e, o) in enumerate(recs)):
        raise RuntimeError(
            f"the MoE dispatch was recorded {len(recs)} times with shapes "
            f"{sorted({tuple(e.shape) for e, _ in recs})}; the check needs one record an MoE "
            f"layer a step ({L * b['gen']}), of {want[0]} prefill and {want[-1]} decode choices")
    out = []
    for l in range(L):
        rows = []
        for j, (e_sorted, order) in enumerate(recs[l::L]):
            flat = torch.empty_like(e_sorted).scatter_(1, order, e_sorted)
            per_tok = flat.reshape(-1, K)
            rows.append(per_tok[row * P:(row + 1) * P] if j == 0 else per_tok[row:row + 1])
        out.append(torch.cat(rows))
    return out


def sample(run: Run) -> List[tuple]:
    """(batch, row) of the requests the check compares: drawn from the
    seed among the rows each batch kept, ``check_requests_per_len`` of each
    prompt length, the longest included."""
    t = run.cell.traffic
    rng = tr.sample_rng(run.seed)
    out = []
    for P in t["prompt_lens"]:
        pool = [(bi, r) for bi, b in enumerate(run.facts["batches"]) if b["P"] == P
                for r in b["rows"]]
        pick = rng.choice(len(pool), size=min(t["check_requests_per_len"], len(pool)),
                          replace=False)
        out += [pool[k] for k in sorted(pick)]
    return out


def _numbers(a, params, prompt, served, logits, routes, P: int, B: int,
             config: Dict[str, Any]) -> Dict[str, float]:
    """One request's numbers: the float32 reference follows the served
    sequence (and the routing it was served with) and judges the served
    tokens (``gap``), the logits they were chosen from (``logit_err``) and
    each routing choice (``route_gap``)."""
    from reference import check, lm as ref

    seq = torch.cat([prompt, served[:-1]])
    with torch.no_grad(), ref.precision("f32"):
        ref_logits, rlog, _ = ref.serve(a, params, seq, P, B, config, routes)
    out = {"gap": check.served_gap(ref_logits, served),
           "logit_err": check.logit_err(ref_logits, logits)}
    if routes is not None:
        out["route_gap"] = check.route_gap(rlog, routes)
    return out


def compare(run: Run, params, control: bool = False) -> Dict[str, Dict[str, float]]:
    """The check's numbers over the sampled requests: the program's
    ("f32"), and with ``control`` the control's ("tf32"): the reference in
    TF32 put in the program's place, serving each sampled request greedily
    with its own routing, and judged by the same numbers."""
    from reference import lm as ref

    a, config = run.arch, run.cell.config
    moe = kinds.has(a, "moe")
    out: Dict[str, Dict[str, float]] = {}

    def fold(mode, got):
        acc = out.setdefault(mode, {})
        for k, v in got.items():
            acc[k] = max(acc.get(k, 0.0), v)

    for bi, row in sample(run):
        b = run.facts["batches"][bi]
        served = torch.as_tensor(np.asarray(b["tokens"][row]), dtype=torch.long,
                                 device=run.device)
        prompt = torch.as_tensor(tr.prompts(run.seed, b["i"], run.cell.traffic,
                                            a["vocab_size"])[row], dtype=torch.long,
                                 device=run.device)
        logits = torch.stack([step[b["rows"].index(row)] for step in b["logits"]])
        routes = _routes_of(run, b, row) if moe else None
        fold("f32", _numbers(a, params, prompt, served, logits, routes, b["P"], b["B"], config))
        if control:
            with torch.no_grad(), ref.precision("tf32"):
                c_served, c_logits, c_routes = ref.serve_greedy(a, params, prompt, b["gen"],
                                                                b["B"], config)
            fold("tf32", _numbers(a, params, prompt, c_served, c_logits, c_routes, b["P"],
                                  b["B"], config))
    return out


def check(run: Run, prog: Dict[str, Any]) -> None:
    params = prog["params"]
    prog.clear()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = compare(run, params)["f32"]
    run.facts["check_s"] = time.perf_counter() - t0
    for k, lim in run.cell.limits.items():
        run.checks[k] = (got[k], lim)


def run(run: Run) -> None:
    prog = setup(run)
    synchronize(run.device)
    run.setup_s = time.perf_counter() - run.t_start
    measure(run, prog)
    check(run, prog)

"""serve_tokens_per_s.prefill: prompt plus generated tokens of every batch
over the window, in the long-prompt cell, where the decode steps between
prefills are paced by the host and the rate spreads too widely between
runs to hold a bound (PERF.md); read in the traced run."""


def read(run):
    batches, w = run.facts.get("batches"), run.facts.get("window")
    if not batches or not w:
        return None
    return sum(b["B"] * (b["P"] + b["gen"]) for b in batches) / (w[1] - w[0])

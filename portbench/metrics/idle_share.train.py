"""idle_share.train: the share of the traced window in which no operation
ran on the device, in the training cell (`harness.trace.idle_share_pct`)."""

from harness.trace import idle_share_pct


def read(run):
    return idle_share_pct(run) if run.facts.get("steps") else None

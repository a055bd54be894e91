"""device_idle_pct.prove: the share of a traced statement's prove span in
which no operation runs on the card, in %."""

from prover_bench.layers import idle_pct

SPANS = []


def read(run):
    return idle_pct(run.spans, "prove")

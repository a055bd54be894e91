"""trace_build_s: seconds a statement spends building its AIR and its
trace (`Sha256Air(messages)` and `build_trace`), per statement."""

from prover_bench.layers import per_statement

SPANS = []


def read(run):
    return per_statement(run.spans, "trace_build", len(run.prove_s))

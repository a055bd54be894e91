"""commit_s: seconds a statement's proof spends in `stages.commit_rows`
(the constant, trace and quotient commitments), per statement."""

from prover_bench.layers import COMMIT_SPANS, per_statement

SPANS = COMMIT_SPANS


def read(run):
    return per_statement(run.spans, "commit", len(run.prove_s))

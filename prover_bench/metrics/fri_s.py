"""fri_s: seconds a statement's proof spends in FRI's prover stages
(`fri_commit_layer`, `fri_fold`, `fri_final_coeffs`, `grind`), per
statement."""

from prover_bench.layers import FRI_SPANS, per_statement

SPANS = FRI_SPANS


def read(run):
    return per_statement(run.spans, "fri", len(run.prove_s))

"""constraints_s.ladder: seconds a proved statement spends evaluating its
constraints coset by coset (the program's `prover.composition_coset` spans
of the streamed prove: each coset's evaluation of the trace, aux and
constant rows, the ladder's and the lookups' transition constraints and
their weighted sum) inside the harness's prove spans, per proved statement.
None where no `stark.prove_streamed` span lies in them."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    return progtrace.per_statement(run, "prove", "prover.composition_coset",
                                   "stark.prove_streamed",
                                   lambda r: r.ns / 1e9)

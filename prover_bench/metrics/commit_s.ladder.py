"""commit_s.ladder: seconds a proved statement spends in its streamed
commitments (the program's `stages.commit_streamed` spans: the constant,
trace, aux and quotient groups, each extended a block of rows at a time and
absorbed into the leaf sponges, and each tree) inside the harness's prove
spans, per proved statement. The streamed counterpart of `commit_s`, whose
`stages.commit_rows` a streamed prove never calls. None where no
`stark.prove_streamed` span lies in them."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    return progtrace.per_statement(run, "prove", "stages.commit_streamed",
                                   "stark.prove_streamed",
                                   lambda r: r.ns / 1e9)

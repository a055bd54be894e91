"""aux_s.ladder: seconds a proved statement spends building the LogUp running
sums of its byte-table lookups (the program's `prover.aux_witness` spans)
inside the harness's prove spans, per proved statement. None where no
`stark.prove_streamed` span lies in them."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    return progtrace.per_statement(run, "prove", "prover.aux_witness",
                                   "stark.prove_streamed",
                                   lambda r: r.ns / 1e9)

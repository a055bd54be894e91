"""trace_build_s.ladder: seconds a proved statement spends building its ladder
trace (the program's `ed25519_ladder.build_trace` spans: the Python-int
ladder, then the numpy limbs and carries) inside the harness's prove spans,
per proved statement. None where no `stark.prove_streamed` span lies in
them."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    return progtrace.per_statement(run, "prove", "ed25519_ladder.build_trace",
                                   "stark.prove_streamed",
                                   lambda r: r.ns / 1e9)

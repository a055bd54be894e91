"""poseidon_calls: Poseidon permutation calls (the program's
`poseidon.permute` spans) inside the harness's prove spans, per proved
statement."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    return progtrace.per_statement(run, "prove", "poseidon.permute",
                                   "stark.prove", lambda r: 1)

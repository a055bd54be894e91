"""poseidon_s: seconds a statement's proof spends inside calls into
Poseidon (`hash_no_pad`, `two_to_one`, and `permute` where it is called
from outside them), per statement."""

from prover_bench.layers import POSEIDON_SPANS, per_statement

SPANS = POSEIDON_SPANS


def read(run):
    return per_statement(run.spans, "poseidon", len(run.prove_s))

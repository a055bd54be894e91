"""ntt_s: seconds a statement's proof spends inside NTT dispatch
(`ntt._transform`, `cuda_ntt.coset_lde`), per statement."""

from prover_bench.layers import NTT_SPANS, per_statement

SPANS = NTT_SPANS


def read(run):
    return per_statement(run.spans, "ntt", len(run.prove_s))

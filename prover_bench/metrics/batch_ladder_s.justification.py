"""batch_ladder_s.justification: seconds a verified justification spends in
the batched signature check's curve work on the card (the program's
`ed25519_batch.ladder` spans: one double-and-add ladder over the 2n + 1
terms, the pairwise reduction and the identity test) inside the harness's
verify spans, per verified statement. None where no
`ed25519_batch.batch_verify` span lies in them. The program's tracer is
armed only where the check records spans (`justification_spans`), so a
program without them reads None and its traced run still ends."""

from prover_bench import justification_spans, progtrace

SPANS = []
justification_spans.arm()


def read(run):
    return progtrace.per_statement(run, "verify", "ed25519_batch.ladder",
                                   "ed25519_batch.batch_verify",
                                   lambda r: r.ns / 1e9)

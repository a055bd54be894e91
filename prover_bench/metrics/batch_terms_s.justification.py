"""batch_terms_s.justification: seconds a verified justification spends making
the batched signature check's terms on the host (the program's
`ed25519_batch.terms` spans: each signature's point decompressions, SHA-512
challenge and randomizer) inside the harness's verify spans, per verified
statement. None where no `ed25519_batch.batch_verify` span lies in them.
The program's tracer is armed only where the check records spans
(`justification_spans`), so a program without them reads None and its
traced run still ends."""

from prover_bench import justification_spans, progtrace

SPANS = []
justification_spans.arm()


def read(run):
    return progtrace.per_statement(run, "verify", "ed25519_batch.terms",
                                   "ed25519_batch.batch_verify",
                                   lambda r: r.ns / 1e9)

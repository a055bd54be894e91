"""vk_derive_s: seconds a verified statement spends deriving its
verification key again (the program's `vk.derive` spans: `stark/vk.py`
`constants_cap` on a cache miss), inside the harness's verify spans, per
verified statement."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    return progtrace.per_statement(run, "verify", "vk.derive", "stark.verify",
                                   lambda r: r.ns / 1e9)

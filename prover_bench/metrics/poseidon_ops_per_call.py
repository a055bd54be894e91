"""poseidon_ops_per_call: device operations charged to the program's
`poseidon.permute` spans (each operation to the program span open on the
host when it started, `progtrace`), over those calls, in the traced
statement's prove span."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    prove = (progtrace.STATE.result or {}).get("prove")
    return None if prove is None else prove.ops_per_call("poseidon.permute")

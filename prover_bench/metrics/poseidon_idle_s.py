"""poseidon_idle_s: seconds the card idles while the host is inside the
program's `poseidon.permute` spans (each idle gap charged to the innermost
program span open on the host across it, `progtrace`), in the traced
statement's prove span."""

from prover_bench import progtrace

SPANS = []
progtrace.arm()


def read(run):
    prove = (progtrace.STATE.result or {}).get("prove")
    if prove is None or "poseidon.permute" not in prove.calls:
        return None
    return prove.idle.get("poseidon.permute", 0.0)

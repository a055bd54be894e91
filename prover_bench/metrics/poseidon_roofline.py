"""poseidon_roofline: the least time of the Poseidon permutations a traced
statement's proof performs on the card (counted from the shapes at the
layer's entries, `roofline.poseidon_work`), as a share of the device time
of the operations launched inside those calls, in %."""

from prover_bench import roofline
from prover_bench.layers import POSEIDON_SPANS, proving

SPANS = POSEIDON_SPANS


def read(run):
    sel = [s for s in proving(run.spans, "poseidon") if s.traced]
    device = sum(s.kernel_s for s in sel)
    least = sum(roofline.least_seconds(*roofline.poseidon_work(
        s.counts.get("states", 0)))[0] for s in sel)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device

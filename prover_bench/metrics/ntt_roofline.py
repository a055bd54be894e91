"""ntt_roofline: the least time of the transforms and LDEs a traced
statement's proof runs on the card (counted from each call's shape,
`roofline.transform_work` / `lde_work`, whatever plan runs), as a share of
the device time of the NTT kernels (`csrc/ntt.cu`: K1 `ntt_tile`, K3
`ntt_tile_lde`, K4 `ntt_tile_t`, by name) inside those calls, in %."""

from prover_bench import roofline
from prover_bench.layers import NTT_SPANS, proving

SPANS = NTT_SPANS
KERNEL = "ntt_tile"


def read(run):
    sel = [s for s in proving(run.spans, "ntt") if s.traced and s.counts]
    device = sum(sec for s in sel for name, sec in s.kernels.items()
                 if KERNEL in name)
    least = 0.0
    for s in sel:
        c = s.counts
        work = (roofline.lde_work(c["rows"], c["log_n"], c["rate_bits"])
                if c["lde"] else roofline.transform_work(c["rows"],
                                                         c["log_n"]))
        least += roofline.least_seconds(*work)[0]
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device

"""device_idle_pct.verify.justification: `device_idle_pct.verify`
(`metrics/device_idle_pct.verify.py`) read in the cell
header_range_256.justification under a name of its own: the gateway's
justification check, host terms then one batched ladder on the card, is
another verify than a STARK chunk's, so each cell's reading is a series of
its own. It moves `verify_s`."""

from prover_bench.harness import reader

_base = reader("device_idle_pct.verify")
SPANS = getattr(_base, "SPANS", [])
read = _base.read

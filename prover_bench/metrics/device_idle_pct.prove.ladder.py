"""device_idle_pct.prove.ladder: `device_idle_pct.prove`
(`metrics/device_idle_pct.prove.py`) read in the cell
zk_justification_300.ladder under a name of its own: the streamed
3520-column ladder prove, host-bound in its Python-int witness and its
launches, is another prove than the SHA-256 chunks of
`header_range_256.roots`, so each cell's reading is a series of its own. It
moves `prove_s`."""

from prover_bench.harness import reader

_base = reader("device_idle_pct.prove")
SPANS = getattr(_base, "SPANS", [])
read = _base.read

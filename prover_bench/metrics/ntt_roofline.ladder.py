"""ntt_roofline.ladder: `ntt_roofline` (`metrics/ntt_roofline.py`) read in the
cell zk_justification_300.ladder under a name of its own: the ladder's
streamed prove transforms 5763 committed columns a block or a coset at a
time, another NTT workload than the SHA-256 chunks of
`header_range_256.roots`, so each cell's reading is a series of its own. It
moves `prove_s`."""

from prover_bench.harness import reader

_base = reader("ntt_roofline")
SPANS = getattr(_base, "SPANS", [])
read = _base.read

"""poseidon_roofline.ladder: `poseidon_roofline`
(`metrics/poseidon_roofline.py`) read in the cell
zk_justification_300.ladder under a name of its own: the ladder's streamed
commitments absorb 721 permutations a leaf over 2^17 leaf states, another
Poseidon workload than the SHA-256 chunks of `header_range_256.roots`, so
each cell's reading is a series of its own. It moves `prove_s`."""

from prover_bench.harness import reader

_base = reader("poseidon_roofline")
SPANS = getattr(_base, "SPANS", [])
read = _base.read

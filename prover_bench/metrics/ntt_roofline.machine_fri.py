"""ntt_roofline.machine_fri: `ntt_roofline` (`metrics/ntt_roofline.py`) in
the cell rotate_300.machine_fri, whose prove seconds swing with the host's
speed past what an end-to-end bound admits (PERF.md §2).  There it is a
per-layer metric, and it names the cell's other end-to-end metric,
`peak_device_gib`, as the one it moves, since a per-layer metric names one
that each of its cells reports."""

from prover_bench.harness import reader

_base = reader("ntt_roofline")
SPANS = getattr(_base, "SPANS", [])
read = _base.read

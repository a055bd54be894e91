"""Recursive proof aggregation on the port: the STARK verifier of many
child proofs replayed inside ONE wide trace — a row-programmed "verifier
VM" whose constraints are stacked device ops.  Port of
`vectorx_tpu.recursion`.

Modules:
* `ssa`       — the op tape: symbolic values, Poseidon duplexes, bit
                decompositions, fused mul-adds, assertions.
* `shadow`    — replays `stark.verifier.verify` onto a tape (program is a
                function of the child statement + config only; a concrete
                proof binds the witness values; publics can be wired).
* `machine`   — the verifier-VM AIR executing a tape: dual-FMA rows,
                packed 9-row Poseidon slots, multi-write rows, and an
                8-port LogUp memory bus.
* `progcache` — content-addressed statement-mode programs.
* `aggregate` — N child proofs -> ONE machine proof; the verifier
                re-derives the program from the child statements.
* `succinct`  — child proofs wired inside ONE machine proof: a SHA-256
                Merkle tree (leaves and root public) and a Blake2b hash
                chain (trusted and final hash public).
"""

from vectorx_tpu_torch.recursion.ssa import Builder
from vectorx_tpu_torch.recursion.shadow import verifier_tape
from vectorx_tpu_torch.recursion.machine import MachineAir, compile_tape
from vectorx_tpu_torch.recursion.aggregate import (aggregate_prove,
                                                   aggregate_verify)

__all__ = ["Builder", "verifier_tape", "MachineAir", "compile_tape",
           "aggregate_prove", "aggregate_verify"]

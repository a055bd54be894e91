"""Proof aggregation: N child STARK verifications in ONE machine proof.

Port of `vectorx_tpu.recursion.aggregate`.  Every child verification is
replayed onto one shared tape (shadow.py) and the whole tape is proven as
one verifier-VM STARK (machine.py), on the device the caller names.

Binding: each child's statement enters the tape through its public inputs
(exposed as machine publics at a per-child offset) and through its
preprocessed-columns cap (derived from the child AIR, burned into the
machine program as constants).  The aggregate verifier re-derives the
machine program from the claimed child statements alone, so a proof for
different statements has a different program commitment and cannot
verify.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from vectorx_tpu_torch.recursion import machine, progcache
from vectorx_tpu_torch.recursion.machine import MachineAir, compile_tape
from vectorx_tpu_torch.recursion.shadow import verifier_tape
from vectorx_tpu_torch.recursion.ssa import Builder
from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.verifier import verify
from vectorx_tpu_torch.stark.vk import cache_key as vk_key


@dataclass
class AggregationResult:
    machine_air: MachineAir
    proof: object                 # the single outer StarkProof
    public_offsets: list          # child i's publics start here


def _stmt_key(children, child_config: StarkConfig) -> str:
    """Content address of the statement-mode program (recursion/progcache):
    the claimed child statements, the child config and the machine
    layout."""
    h = hashlib.sha256()
    f = child_config.fri
    h.update(f"machine:{machine.MACHINE_FORMAT_VERSION}|cfg:{f.rate_bits}:"
             f"{f.cap_height}:{f.num_queries}:{f.final_poly_len}:"
             f"{f.pow_bits}".encode())
    for air in children:
        h.update(f"|{type(air).__module__}.{type(air).__qualname__}:"
                 f"{air.log_n}:{air.width}:{air.constraint_degree}".encode())
        h.update(repr(air.public_inputs()).encode())
        h.update(vk_key(air.constant_columns(), child_config).encode())
    return h.hexdigest()


def _build_tape(children, child_config, proofs=None, *, device):
    """One tape verifying every child; returns (builder, offsets).
    `proofs=None` builds the statement tape (program only)."""
    b = Builder(witness=proofs is not None)
    offsets = []
    off = 0
    for i, air in enumerate(children):
        offsets.append(off)
        off += verifier_tape(
            b, air, child_config,
            proof=proofs[i] if proofs is not None else None,
            public_offset=off, device=device)
    return b, offsets


def aggregate_prove(children, proofs, child_config: StarkConfig,
                    outer_config: StarkConfig | None = None, *,
                    device) -> AggregationResult:
    """Prove "child proof i verifies against statement i" for all i, as
    one machine STARK on `device`.  Raises TapeCheckFailed if any child
    proof is invalid (the tape rejects exactly what the host verifier
    rejects)."""
    outer_config = outer_config or child_config
    b, offsets = _build_tape(children, child_config, proofs=proofs,
                             device=device)
    prog = compile_tape(b)
    # key the caller's program too (progcache.put), so this MachineAir and
    # the verifier's share one VK-cache token
    progcache.put(_stmt_key(children, child_config), prog,
                  meta=list(offsets))
    air = MachineAir(prog)
    proof = prove(air, air.build_trace(), outer_config, device=device)
    return AggregationResult(machine_air=air, proof=proof,
                             public_offsets=offsets)


def aggregate_verify(children, agg_proof, child_config: StarkConfig,
                     outer_config: StarkConfig | None = None, *,
                     device) -> bool:
    """Verify ONE machine proof against the claimed child statements.

    Touches no child proof data: the machine program is re-derived from
    the statements (or served by the progcache), and the outer STARK is
    checked against it.  Any failure is a rejection."""
    outer_config = outer_config or child_config
    try:
        key = _stmt_key(children, child_config)
        hit = progcache.get(key)
        if hit is not None:
            prog = hit[0]
        else:
            b, offsets = _build_tape(children, child_config, proofs=None,
                                     device=device)
            prog = compile_tape(b)
            progcache.put(key, prog, meta=list(offsets))
        air = MachineAir(prog)
        return verify(air, agg_proof, outer_config, device=device)
    except Exception:
        return False

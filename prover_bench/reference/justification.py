"""The benchmark's two GRANDPA justification statements, worked out plainly:
a ladder chunk's proof (`Ed25519LadderAir` proved by `lookup_prover`) and
the verdict of a simple justification's check (succinctlabs/vectorx
`GrandpaJustificationVerifier::verify_simple_justification`,
circuits/builder/justification.rs:195-257)."""

from __future__ import annotations

import hashlib


def ladder_chunk_proof(sigs, nbits: int, fri_config: dict, device):
    """(trace (W, n) uint64, StarkProof) of `Ed25519LadderAir(sigs, nbits)`
    proved at FriConfig(**fri_config) on `device`; `sigs` are
    (A_cmp, R_cmp, S, h mod L) tuples."""
    from .ed25519_ladder_air import Ed25519LadderAir
    from .fri import FriConfig
    from .lookup_prover import prove
    from .prover import StarkConfig

    air = Ed25519LadderAir(sigs, nbits=nbits)
    trace = air.build_trace()
    cfg = StarkConfig(fri=FriConfig(**fri_config))
    return trace, prove(air, trace, cfg, device=device)


def authority_set_commitment(pubkeys) -> bytes:
    """Chained SHA-256 of the keys: H(..H(H(k0) ‖ k1) ‖ k2 ..)
    (justification.rs:127-162)."""
    acc = b""
    for key in pubkeys:
        acc = hashlib.sha256(acc + key).digest()
    return acc


def justification_verdict(pubkeys, signatures, validator_signed,
                          num_authorities: int, signed_message: bytes,
                          block_number: int, block_hash: bytes,
                          authority_set_id: int,
                          authority_set_hash: bytes) -> bool:
    """Whether the justification holds: the first `num_authorities` keys
    commit to `authority_set_hash`, no signature is marked outside them,
    the 53-byte precommit names the block and the set, every marked
    signature verifies by RFC 8032 over it, and more than 2/3 of the set
    signed."""
    from . import ed25519

    if not (len(pubkeys) == len(signatures) == len(validator_signed)):
        return False
    if not 0 < num_authorities <= len(pubkeys) or \
            any(validator_signed[num_authorities:]):
        return False
    if authority_set_commitment(pubkeys[:num_authorities]) != \
            authority_set_hash:
        return False
    m = signed_message
    if len(m) != 53 or m[0] != 1 or m[1:33] != block_hash or \
            int.from_bytes(m[33:37], "little") != block_number or \
            int.from_bytes(m[45:53], "little") != authority_set_id:
        return False
    if not all(ed25519.verify(pubkeys[i], m, signatures[i])
               for i in range(num_authorities) if validator_signed[i]):
        return False
    return 3 * sum(map(bool, validator_signed)) > 2 * num_authorities

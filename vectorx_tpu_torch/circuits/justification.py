"""GRANDPA simple-justification verification (C5).

Port of `vectorx_tpu.circuits.justification`; equivalent of
`GrandpaJustificationVerifier`
(upstream circuits/builder/justification.rs:86-257).  The checks —
authority-set commitment, precommit consistency, batched signature
verification, >2/3 threshold — run as verified witness computation here;
the STARK AIRs that prove them in zero knowledge plug in via
`vectorx_tpu_torch.stark` (SURVEY.md §7 layers 6-7).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.curves import ed25519
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io.fixtures import JustificationData


class JustificationError(ValueError):
    pass


def compute_authority_set_commitment(num_active: int,
                                     pubkeys: list[bytes]) -> bytes:
    """Chained SHA-256 of the first `num_active` pubkeys
    (justification.rs:127-162: SHA256(SHA256(SHA256(k0) || k1) || k2)…)."""
    if num_active == 0:
        raise JustificationError("authority set must be non-empty")
    return chained_hash(pubkeys[:num_active])


def verify_voting_threshold(num_active: int, validator_signed: list[bool],
                            numerator: int = 2, denominator: int = 3) -> None:
    """num_signed / num_active > numerator / denominator
    (justification.rs:164-186)."""
    num_signed = sum(bool(b) for b in validator_signed)
    if not num_signed * denominator > num_active * numerator:
        raise JustificationError(
            f"insufficient votes: {num_signed}/{num_active}")


def verify_simple_justification(justification: JustificationData,
                                block_number: int, block_hash: bytes,
                                authority_set_id: int,
                                authority_set_hash: bytes,
                                signature_backend: str = "host", *,
                                device=None, rng=None) -> None:
    """Full simple-justification check (justification.rs:195-257):
    1) authority-set commitment matches, 2) precommit matches the target
    block/set, 3) every marked signature verifies over the shared 53-byte
    message, 4) >2/3 of the set signed.

    signature_backend: "host" checks each signature with the scalar RFC 8032
    path; "device" runs the conditional batched verification on `device`
    (`curves/ed25519_batch.py` — the curta_eddsa_verify_sigs_conditional
    equivalent), with its 128-bit randomizers drawn from `rng` (a
    `random.Random`; the system's secure generator when None)."""
    j = justification
    # shape bounds: entries at indices >= num_authorities are outside the
    # committed authority set and must not be counted or verified (the
    # reference fixes arrays at MAX_NUM_AUTHORITIES and masks by num_active;
    # unbounded lists would let attacker-keyed tail entries inflate the
    # voting threshold)
    if not (len(j.validator_signed) == len(j.pubkeys) == len(j.signatures)):
        raise JustificationError("witness array length mismatch")
    if j.num_authorities <= 0 or j.num_authorities > len(j.pubkeys):
        raise JustificationError("num_authorities out of range")
    if any(j.validator_signed[i] for i in range(j.num_authorities,
                                                len(j.validator_signed))):
        raise JustificationError(
            "signature marked outside the active authority set")
    commitment = compute_authority_set_commitment(j.num_authorities, j.pubkeys)
    if commitment != authority_set_hash:
        raise JustificationError("authority set hash mismatch")

    bh, bn, _round, sid = scale.decode_precommit(j.signed_message)
    if bn != block_number:
        raise JustificationError("precommit block number mismatch")
    if sid != authority_set_id:
        raise JustificationError("precommit authority set id mismatch")
    if bh != block_hash:
        raise JustificationError("precommit block hash mismatch")

    if signature_backend == "device":
        from vectorx_tpu_torch.curves.ed25519_batch import batch_verify

        n = len(j.pubkeys)
        if device is None:
            raise ValueError('signature_backend="device" needs a device')
        if not batch_verify(j.pubkeys, [j.signed_message] * n, j.signatures,
                            signed_mask=list(j.validator_signed),
                            rng=rng or secrets.SystemRandom(),
                            device=device):
            raise JustificationError("batched signature verification failed")
    else:
        for i, signed in enumerate(j.validator_signed):
            if not signed:
                continue
            if not ed25519.verify(j.pubkeys[i], j.signed_message,
                                  j.signatures[i]):
                raise JustificationError(
                    f"invalid signature from validator {i}")

    verify_voting_threshold(j.num_authorities, j.validator_signed)

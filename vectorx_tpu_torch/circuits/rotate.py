"""Authority-set rotation verification (C7).

Port of `vectorx_tpu.circuits.rotate` (host code); equivalent of
`RotateMethods`
(upstream circuits/builder/rotate.rs:17-324): validates that an
epoch-end header is correctly signed by the current authority set and that
its ScheduledChange consensus log encodes exactly the claimed new authority
set, then returns the new set's chained-SHA256 commitment.

The byte-layout checks reproduce the circuit's walk exactly:
consensus-flag 0x04 + engine id "FRNK" (rotate.rs:74-94), compact
scheduled-change message length + 0x01 flag (:96-136), encoded authority
count equality (:138-167), and the per-validator pubkey/weight(=1u64
LE)/delay(=0) scan with end-of-set masking over the
MAX_SUBARRAY_SIZE window (:169-276).
"""

from __future__ import annotations

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.circuits.justification import (
    compute_authority_set_commitment, verify_simple_justification)
from vectorx_tpu_torch.hash.blake2b import blake2b_256
from vectorx_tpu_torch.io.fixtures import HeaderRotateData, JustificationData

WEIGHT_BYTES = (1).to_bytes(8, "little")   # consts.rs:22-28, all weights = 1
DELAY_BYTES = b"\x00" * 4
VALIDATOR_LENGTH = 40


class RotateError(ValueError):
    pass


def verify_epoch_end_header(header_bytes: bytes, header_size: int,
                            num_authorities: int, start_position: int,
                            new_pubkeys: list[bytes],
                            max_authorities: int) -> None:
    """rotate.rs:169-276 — all checks on the encoded epoch-end header.

    The scan is bounded by `header_size`: the justification only binds
    blake2b(header_bytes[:header_size]), so bytes past it are unattested
    (the reference masks by the subarray end position, rotate.rs:194).
    """
    if num_authorities == 0:
        raise RotateError("num_authorities must be non-zero")
    if num_authorities > max_authorities:
        raise RotateError(
            f"num_authorities {num_authorities} > max {max_authorities}")
    if len(new_pubkeys) < num_authorities:
        raise RotateError("fewer pubkeys than num_authorities")
    if not 0 <= start_position <= header_size <= len(header_bytes):
        raise RotateError("scan window outside the hashed header region")

    sub = header_bytes[start_position:header_size]
    if len(sub) < 8:
        raise RotateError("scan window too short for a consensus log")
    # verify_consensus_log (rotate.rs:74-94): skip 1 byte, flag, engine id
    if sub[1] != 4:
        raise RotateError("missing consensus flag 0x04")
    if sub[2:6] != scale.CONSENSUS_ENGINE_ID:
        raise RotateError("missing FRNK engine id")

    # scheduled-change message length + flag (rotate.rs:96-136)
    cursor = 6
    try:
        _msg_len, mode, consumed = scale.compact_decode(sub[cursor:cursor + 5])
    except Exception as e:
        raise RotateError(f"bad scheduled-change length encoding: {e}")
    cursor += consumed
    if cursor >= len(sub):
        raise RotateError("scan window ends inside the consensus log")
    if sub[cursor] != 1:
        raise RotateError("missing ScheduledChange flag 0x01")
    cursor += 1

    # encoded authority count (rotate.rs:138-167)
    try:
        count, _mode, consumed = scale.compact_decode(sub[cursor:cursor + 5])
    except Exception as e:
        raise RotateError(f"bad authority count encoding: {e}")
    if count != num_authorities:
        raise RotateError(
            f"encoded authority count {count} != hinted {num_authorities}")
    cursor += consumed

    # per-validator scan over the fixed window (rotate.rs:169-276), fully
    # inside the hashed region: window ends at header_size by construction
    window = sub[cursor:]
    if num_authorities * VALIDATOR_LENGTH + 4 > len(window):
        raise RotateError("validator list extends past the hashed region")
    for i in range(num_authorities):
        off = i * VALIDATOR_LENGTH
        pk = window[off:off + 32]
        if pk != new_pubkeys[i]:
            raise RotateError(f"pubkey mismatch for validator {i}")
        if window[off + 32:off + 40] != WEIGHT_BYTES:
            raise RotateError(f"weight != 1 for validator {i}")
    delay_off = num_authorities * VALIDATOR_LENGTH
    if window[delay_off:delay_off + 4] != DELAY_BYTES:
        raise RotateError("delay != 0")


def rotate(rotate_data: HeaderRotateData,
           justification: JustificationData,
           current_authority_set_id: int,
           current_authority_set_hash: bytes,
           epoch_end_block_number: int,
           max_authorities: int) -> bytes:
    """rotate.rs:278-324 — hash the epoch-end header, verify the current
    set's justification on it, validate the encoded new set, and return the
    new authority-set commitment."""
    target_header_hash = blake2b_256(
        rotate_data.header_bytes[:rotate_data.header_size])

    verify_simple_justification(
        justification, epoch_end_block_number, target_header_hash,
        current_authority_set_id, current_authority_set_hash)

    verify_epoch_end_header(
        rotate_data.header_bytes, rotate_data.header_size,
        rotate_data.num_authorities, rotate_data.start_position,
        rotate_data.padded_pubkeys, max_authorities)

    return compute_authority_set_commitment(
        rotate_data.num_authorities, rotate_data.padded_pubkeys)

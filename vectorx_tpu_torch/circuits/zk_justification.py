"""GRANDPA justification in zero knowledge — the full C5 statement.

Port of `vectorx_tpu.circuits.zk_justification`.  Carries
`verify_simple_justification` (justification.py) into ZK with the same
public-wiring pattern as the other circuits: for every ENABLED signature i
over the shared 53-byte precommit message M,

  1. a batched `Sha512Air` proof binds  digest_i = SHA512(R_i ‖ A_i ‖ M)
     (the challenge hash — curta's `curta_eddsa_verify_sigs_conditional`
     derives the same scalar, upstream
     circuits/builder/justification.rs:237-243);
  2. the verifier reduces h_i = digest_i mod L host-side (public data);
  3. a batched `Ed25519LadderAir` proof binds  [S_i]B = R_i + [h_i]A_i;
  4. `zk_commitment` binds the authority set hash to the pubkey list;
  5. threshold (>2/3 of num_authorities), precommit decode, and S_i < L
     canonicality are checked on public data.

Conditional masking: the upstream circuit proves ≤300 signatures with
per-sig enable bits inside a fixed-shape circuit; here the
statement-derived preprocessed commitment lets the trace contain exactly
the enabled signatures, and the verifier checks the enabled set against
validator_signed and the threshold.

Every proof runs on the `device` the caller names.  The verifier checks
the public data first and the STARK proofs last (the reference verifies
the commitment proof before the challenge and ladder wiring); the result
is the same conjunction.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.circuits.zk_commitment import (
    AuthorityCommitmentProof, chunk_by_rows, prove_authority_commitment,
    verify_authority_commitment)
from vectorx_tpu_torch.curves.ed25519 import L
from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir
from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.sha512_air import SECTION as S512_SECTION
from vectorx_tpu_torch.stark.sha512_air import Sha512Air, sha512_pad
from vectorx_tpu_torch.stark.verifier import verify

# trace-row budget per ladder proof (2^14 rows ≈ 16 real signatures)
MAX_LADDER_ROWS = 1 << 14
# rows of one signature at the real scalar width (253 bits)
LADDER_ROWS_PER_SIG = 4 * 253 + 4


def _sha512_rows(msg: bytes) -> int:
    return S512_SECTION * (len(sha512_pad(msg)) // 128) + 1


def _safe_verify(air, proof, config, device) -> bool:
    """A malformed child proof is a rejection, never an exception."""
    try:
        return verify(air, proof, config, device=device)
    except Exception:
        return False


@dataclass
class ZkJustificationProof:
    # public statement (mirrors JustificationData)
    signed_message: bytes
    pubkeys: list
    signatures: list
    validator_signed: list
    num_authorities: int
    # claimed SHA-512 digests of the per-signature challenge messages
    challenge_digests: list
    # component proofs
    commitment_proof: AuthorityCommitmentProof
    sha_chunk_sizes: list
    sha_proofs: list
    ladder_chunk_sizes: list
    ladder_proofs: list


def _enabled_indices(j) -> list[int]:
    return [i for i in range(j.num_authorities) if j.validator_signed[i]]


def challenge_messages(pubkeys, signatures, signed_message,
                       enabled) -> list[bytes]:
    """R_i ‖ A_i ‖ M for every enabled signature i."""
    return [signatures[i][:32] + pubkeys[i] + signed_message
            for i in enabled]


def ladder_chunk_sizes(n_sigs: int) -> list[int]:
    """Signatures per ladder proof: full chunks of MAX_LADDER_ROWS //
    LADDER_ROWS_PER_SIG (16), the remainder last."""
    per_proof = max(1, MAX_LADDER_ROWS // LADDER_ROWS_PER_SIG)
    return [min(per_proof, n_sigs - i) for i in range(0, n_sigs, per_proof)]


def _ladder_sigs(pubkeys, signatures, signed_message, enabled,
                 digests):
    """(A_cmp, R_cmp, S, h) tuples for the ladder statement; raises on a
    non-canonical S."""
    sigs = []
    for t, i in enumerate(enabled):
        r_cmp = signatures[i][:32]
        s_int = int.from_bytes(signatures[i][32:], "little")
        if s_int >= L:
            raise ValueError(f"non-canonical S in signature {i}")
        h_int = int.from_bytes(digests[t], "little") % L
        sigs.append((pubkeys[i], r_cmp, s_int, h_int))
    return sigs


def prove_justification_zk(justification, authority_set_hash: bytes,
                           config: StarkConfig = StarkConfig(), *,
                           device) -> ZkJustificationProof:
    j = justification
    enabled = _enabled_indices(j)
    msgs = challenge_messages(j.pubkeys, j.signatures, j.signed_message,
                              enabled)
    digests = [hashlib.sha512(m).digest() for m in msgs]

    commitment_proof = prove_authority_commitment(
        j.pubkeys[:j.num_authorities], config, device=device)
    assert commitment_proof.commitment == authority_set_hash

    sha_sizes = chunk_by_rows(msgs, _sha512_rows)
    sha_proofs, pos = [], 0
    for sz in sha_sizes:
        air = Sha512Air(msgs[pos:pos + sz])
        assert air.digest_bytes_list() == digests[pos:pos + sz]
        sha_proofs.append(prove(air, air.build_trace(), config,
                                device=device))
        pos += sz

    sigs = _ladder_sigs(j.pubkeys, j.signatures, j.signed_message,
                        enabled, digests)
    ladder_sizes = ladder_chunk_sizes(len(sigs))
    ladder_proofs, pos = [], 0
    for sz in ladder_sizes:
        air = Ed25519LadderAir(sigs[pos:pos + sz])
        ladder_proofs.append(prove(air, air.build_trace(), config,
                                   device=device))
        pos += sz

    return ZkJustificationProof(
        signed_message=j.signed_message, pubkeys=list(j.pubkeys),
        signatures=list(j.signatures),
        validator_signed=list(j.validator_signed),
        num_authorities=j.num_authorities,
        challenge_digests=digests,
        commitment_proof=commitment_proof,
        sha_chunk_sizes=sha_sizes, sha_proofs=sha_proofs,
        ladder_chunk_sizes=ladder_sizes, ladder_proofs=ladder_proofs)


def _chunks_ok(sizes, proofs, total: int) -> bool:
    return not [s for s in sizes if s < 1] and sum(sizes) == total \
        and len(proofs) == len(sizes)


def verify_justification_zk(proof: ZkJustificationProof, block_number: int,
                            block_hash: bytes, authority_set_id: int,
                            authority_set_hash: bytes,
                            config: StarkConfig = StarkConfig(), *,
                            device) -> bool:
    """Checks the whole statement against public data + the ZK proofs —
    never verifying a signature or hashing a challenge itself."""
    p = proof
    # shape + bounds (mirrors justification.py's host checks)
    if not (len(p.validator_signed) == len(p.pubkeys) == len(p.signatures)):
        return False
    if p.num_authorities <= 0 or p.num_authorities > len(p.pubkeys):
        return False
    if any(p.validator_signed[i] for i in range(p.num_authorities,
                                                len(p.validator_signed))):
        return False
    # precommit consistency (public 53-byte message)
    try:
        bh, bn, _round, sid = scale.decode_precommit(p.signed_message)
    except Exception:
        return False
    if bh != block_hash or bn != block_number or sid != authority_set_id:
        return False
    # threshold over the full set
    num_signed = sum(bool(b) for b in p.validator_signed)
    if not num_signed * 3 > p.num_authorities * 2:
        return False
    # authority-set commitment: the public side
    if p.commitment_proof.pubkeys != list(p.pubkeys[:p.num_authorities]):
        return False
    if p.commitment_proof.commitment != authority_set_hash:
        return False
    # challenge wiring: the statement side of the SHA-512 chunks
    enabled = [i for i in range(p.num_authorities) if p.validator_signed[i]]
    msgs = challenge_messages(p.pubkeys, p.signatures, p.signed_message,
                              enabled)
    if len(p.challenge_digests) != len(msgs) or \
            any(len(d) != 64 for d in p.challenge_digests):
        return False
    if not _chunks_ok(p.sha_chunk_sizes, p.sha_proofs, len(msgs)):
        return False
    # EdDSA equations: the statement side of the ladder chunks
    try:
        sigs = _ladder_sigs(p.pubkeys, p.signatures, p.signed_message,
                            enabled, p.challenge_digests)
    except ValueError:
        return False
    if not _chunks_ok(p.ladder_chunk_sizes, p.ladder_proofs, len(sigs)):
        return False
    # the proofs: commitment, challenge hashes, ladders
    try:
        if not verify_authority_commitment(p.commitment_proof, config,
                                           device=device):
            return False
    except Exception:
        return False
    pos = 0
    for sz, stark in zip(p.sha_chunk_sizes, p.sha_proofs):
        air = Sha512Air.statement(msgs[pos:pos + sz],
                                  p.challenge_digests[pos:pos + sz])
        if not _safe_verify(air, stark, config, device):
            return False
        pos += sz
    pos = 0
    for sz, stark in zip(p.ladder_chunk_sizes, p.ladder_proofs):
        air = Ed25519LadderAir.statement(sigs[pos:pos + sz])
        if not _safe_verify(air, stark, config, device):
            return False
        pos += sz
    return True

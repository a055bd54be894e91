"""ZK proof of the GRANDPA authority-set commitment (C5's hash, in ZK).

The commitment is the chained hash
    SHA256( … SHA256( SHA256(k₀) ‖ k₁ ) … ‖ k_{n−1} )
(upstream circuits/builder/justification.rs:127-162).  ALL chain
steps are proven in a handful of BATCHED `Sha256Air` proofs (many
independent messages per trace — the same batching curta uses); steps are
glued by PUBLIC wiring — step i's claimed digest is the first 32 bytes of
step i+1's message — which the verifier checks directly when it rebuilds
the statement, so no in-circuit copy constraints are needed.

A 300-authority commitment is ~3 proofs instead of 300.

Port of `vectorx_tpu.circuits.zk_commitment`: the proofs run on the
`device` the caller names.  The chunk boundaries (`MAX_BATCH_LOG_N`) are
the reference's, since they are part of the proof object.
"""

from __future__ import annotations

from dataclasses import dataclass

from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.sha256_air import SECTION, Sha256Air, sha256_pad
from vectorx_tpu_torch.stark.verifier import verify

# Trace-row budget per batched proof (2^MAX_BATCH_LOG_N rows).  Bounds
# prover memory while still collapsing hundreds of proofs into a few.
MAX_BATCH_LOG_N = 14


def _sha_rows(msg: bytes) -> int:
    return SECTION * (len(sha256_pad(msg)) // 64) + 1


def chunk_by_rows(messages, rows_fn, max_rows: int = 1 << MAX_BATCH_LOG_N):
    """Greedy order-preserving partition of messages into batches whose
    total trace rows stay under max_rows.  Chunk boundaries are not
    soundness-relevant (every message/digest is bound in some chunk and
    the verifier rebuilds the wiring), only a memory knob."""
    sizes, cur, cur_rows = [], 0, 0
    for m in messages:
        r = rows_fn(m)
        if cur and cur_rows + r > max_rows:
            sizes.append(cur)
            cur, cur_rows = 0, 0
        cur += 1
        cur_rows += r
    if cur:
        sizes.append(cur)
    return sizes


@dataclass
class AuthorityCommitmentProof:
    pubkeys: list          # the public statement
    step_digests: list     # claimed digest after each chain step (bytes)
    chunk_sizes: list      # chain steps covered by each batched proof
    step_proofs: list      # one StarkProof per chunk (batched Sha256Air)
    commitment: bytes      # claimed final digest (== step_digests[-1])


def prove_authority_commitment(pubkeys: list[bytes],
                               config: StarkConfig = StarkConfig(), *,
                               device) -> AuthorityCommitmentProof:
    import hashlib

    assert pubkeys and all(len(pk) == 32 for pk in pubkeys)
    acc = b""
    messages, digests = [], []
    for pk in pubkeys:
        messages.append(acc + pk)
        acc = hashlib.sha256(acc + pk).digest()
        digests.append(acc)
    sizes = chunk_by_rows(messages, _sha_rows)
    proofs, pos = [], 0
    for sz in sizes:
        air = Sha256Air(messages[pos:pos + sz])
        assert air.digest_bytes_list() == digests[pos:pos + sz]
        proofs.append(prove(air, air.build_trace(), config,
                            device=device))
        pos += sz
    return AuthorityCommitmentProof(pubkeys=list(pubkeys),
                                    step_digests=digests,
                                    chunk_sizes=sizes,
                                    step_proofs=proofs, commitment=acc)


def verify_authority_commitment(proof: AuthorityCommitmentProof,
                                config: StarkConfig = StarkConfig(), *,
                                device) -> bool:
    """Check every batched proof against its rebuilt statement and the
    public wiring between steps — the verifier never hashes anything."""
    n = len(proof.pubkeys)
    if not n or len(proof.step_digests) != n:
        return False
    if [s for s in proof.chunk_sizes if s < 1] or \
            sum(proof.chunk_sizes) != n or \
            len(proof.step_proofs) != len(proof.chunk_sizes):
        return False
    # rebuild the chain-step messages from the claimed digests (wiring)
    messages = []
    acc = b""
    for pk, digest in zip(proof.pubkeys, proof.step_digests):
        if len(digest) != 32:
            return False
        messages.append(acc + pk)
        acc = digest
    pos = 0
    for sz, stark in zip(proof.chunk_sizes, proof.step_proofs):
        air = Sha256Air.statement(messages[pos:pos + sz],
                                  proof.step_digests[pos:pos + sz])
        try:
            if not verify(air, stark, config, device=device):
                return False
        except Exception:
            return False
        pos += sz
    return acc == proof.commitment

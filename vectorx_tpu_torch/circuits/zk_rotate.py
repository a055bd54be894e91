"""rotate in zero knowledge — the ZK variant of the Rotate circuit.

For input (authority_set_id, authority_set_hash), the epoch-end header of
that set (a) hashes to a target the set's justification finalizes, (b)
carries a valid ScheduledChange consensus log, and (c) the encoded new
authority set commits to the returned new_authority_set_hash.

ZK composition (the component statements are public, the hash work is
proven, the structural byte checks run on public data):

* epoch-end header hash: ONE batched `Blake2bAir` proof;
* justification: the device-batched ed25519 check;
* new-set commitment: chained SHA-256 proofs (`zk_commitment`);
* consensus-log walk / validator scan: `verify_epoch_end_header` on the
  public header bytes.

`aggregate_rotate_proof` folds every component STARK into ONE verifier-VM
proof (recursion/aggregate.py).

Port of `vectorx_tpu.circuits.zk_rotate`, all of it (that module has no
in-ZK justification code; `zk_justification` is its own module, ROADMAP
A-4): every proof runs on the `device` the caller names, and the
verifiers derive their verification keys and run the batched signature
check there, with the randomizers drawn from `rng`.
"""

from __future__ import annotations

from dataclasses import dataclass

from vectorx_tpu_torch.circuits.justification import verify_simple_justification
from vectorx_tpu_torch.circuits.rotate import verify_epoch_end_header
from vectorx_tpu_torch.circuits.zk_commitment import (AuthorityCommitmentProof,
                                                      prove_authority_commitment,
                                                      verify_authority_commitment)
from vectorx_tpu_torch.hash.blake2b import blake2b_256
from vectorx_tpu_torch.io.abi import RotateInput, RotateOutput
from vectorx_tpu_torch.recursion.aggregate import (aggregate_prove,
                                                   aggregate_verify)
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.sha256_air import Sha256Air
from vectorx_tpu_torch.stark.verifier import verify


def _safe_verify(air, proof, config, device) -> bool:
    """Adversarial proof objects must reject, not raise."""
    try:
        return verify(air, proof, config, device=device)
    except Exception:
        return False


@dataclass
class ZkRotateProof:
    input_bytes: bytes
    output_bytes: bytes
    epoch_end_block: int
    # public rotate witness (reference HeaderRotateData)
    header_bytes: bytes
    header_size: int
    num_authorities: int
    start_position: int
    header_hash: bytes
    # component proofs
    header_proof: object                     # Blake2bAir STARK
    commitment: AuthorityCommitmentProof     # new-set chained SHA-256
    justification: object                    # JustificationData


def prove_rotate_zk(fetcher, input_bytes: bytes, max_authorities: int = 300,
                    config: StarkConfig = StarkConfig(), *,
                    device) -> ZkRotateProof:
    inp = RotateInput.decode(input_bytes)
    epoch_end = fetcher.last_justified_block(inp.authority_set_id)
    rd = fetcher.get_header_rotate(epoch_end)
    hdr = rd.header_bytes[:rd.header_size]

    air = Blake2bAir([hdr])
    header_hash = air.digest_bytes_list()[0]
    assert header_hash == blake2b_256(hdr)
    header_proof = prove(air, air.build_trace(), config, device=device)

    justification = fetcher.get_justification(
        epoch_end, max_authorities=max_authorities)

    new_pubkeys = rd.padded_pubkeys[:rd.num_authorities]
    commitment = prove_authority_commitment(new_pubkeys, config,
                                            device=device)
    assert commitment.commitment == rd.new_authority_set_hash

    out = RotateOutput(new_authority_set_hash=commitment.commitment)
    return ZkRotateProof(
        input_bytes=input_bytes, output_bytes=out.encode(),
        epoch_end_block=epoch_end,
        header_bytes=hdr, header_size=rd.header_size,
        num_authorities=rd.num_authorities,
        start_position=rd.start_position,
        header_hash=header_hash,
        header_proof=header_proof, commitment=commitment,
        justification=justification)


def _justified(proof, inp: RotateInput, device, rng) -> bool:
    """The current set's justification of the claimed header hash."""
    try:
        verify_simple_justification(
            proof.justification, proof.epoch_end_block, proof.header_hash,
            inp.authority_set_id, inp.authority_set_hash,
            signature_backend="device", device=device, rng=rng)
    except Exception:
        return False
    return True


def _header_walk_ok(proof, pubkeys, max_authorities: int) -> bool:
    """The epoch-end byte walk on the public header (rotate.rs:169-276)."""
    try:
        verify_epoch_end_header(
            proof.header_bytes, proof.header_size, proof.num_authorities,
            proof.start_position, list(pubkeys), max_authorities)
    except Exception:
        return False
    return True


def verify_rotate_zk(proof: ZkRotateProof, max_authorities: int = 300,
                     config: StarkConfig = StarkConfig(), *,
                     device, rng=None) -> bool:
    """The reference's four checks, cheapest first (the result is the
    same conjunction): the output and the byte walk on public data, the
    justification, then the Blake2b header proof and the SHA-256 chain."""
    inp = RotateInput.decode(proof.input_bytes)
    out = RotateOutput.decode(proof.output_bytes)

    # the output is the new-set commitment the chain ends in
    if proof.commitment.commitment != out.new_authority_set_hash:
        return False

    # epoch-end byte walk on the public header
    if len(proof.commitment.pubkeys) != proof.num_authorities:
        return False
    if not _header_walk_ok(proof, proof.commitment.pubkeys, max_authorities):
        return False

    # justification of the current set over the claimed header hash
    if not _justified(proof, inp, device, rng):
        return False

    # epoch-end header hash in ZK
    try:
        air = Blake2bAir.statement([proof.header_bytes],
                                   [proof.header_hash])
    except Exception:
        return False
    if not _safe_verify(air, proof.header_proof, config, device):
        return False

    # new-set commitment chain in ZK
    return verify_authority_commitment(proof.commitment, config,
                                       device=device)


# ---------------------------------------------------------------------------
# Aggregated variant: ONE machine proof for all component STARKs
# ---------------------------------------------------------------------------

@dataclass
class ZkRotateAggProof:
    input_bytes: bytes
    output_bytes: bytes
    epoch_end_block: int
    header_bytes: bytes
    header_size: int
    num_authorities: int
    start_position: int
    header_hash: bytes
    commitment_statement: AuthorityCommitmentProof  # proofs stripped
    aggregated_proof: object
    justification: object


def _commitment_airs(c: AuthorityCommitmentProof):
    messages = []
    acc = b""
    for pk, digest in zip(c.pubkeys, c.step_digests):
        messages.append(acc + pk)
        acc = digest
    airs, pos = [], 0
    for sz in c.chunk_sizes:
        airs.append(Sha256Air.statement(messages[pos:pos + sz],
                                        c.step_digests[pos:pos + sz]))
        pos += sz
    return airs


def aggregate_children(header_bytes: bytes, header_hash: bytes,
                       commitment: AuthorityCommitmentProof) -> list:
    """The aggregated statement's child AIRs: the header's Blake2b
    statement, then the commitment chain's SHA-256 statements."""
    return [Blake2bAir.statement([header_bytes], [header_hash])] + \
        _commitment_airs(commitment)


def aggregate_rotate_proof(proof: ZkRotateProof,
                           config: StarkConfig = StarkConfig(),
                           outer_config: StarkConfig | None = None, *,
                           device) -> ZkRotateAggProof:
    airs = aggregate_children(proof.header_bytes, proof.header_hash,
                              proof.commitment)
    children = [proof.header_proof] + list(proof.commitment.step_proofs)
    agg = aggregate_prove(airs, children, config, outer_config=outer_config,
                          device=device)
    stmt = AuthorityCommitmentProof(
        pubkeys=proof.commitment.pubkeys,
        step_digests=proof.commitment.step_digests,
        chunk_sizes=proof.commitment.chunk_sizes,
        step_proofs=[], commitment=proof.commitment.commitment)
    return ZkRotateAggProof(
        input_bytes=proof.input_bytes, output_bytes=proof.output_bytes,
        epoch_end_block=proof.epoch_end_block,
        header_bytes=proof.header_bytes, header_size=proof.header_size,
        num_authorities=proof.num_authorities,
        start_position=proof.start_position,
        header_hash=proof.header_hash,
        commitment_statement=stmt,
        aggregated_proof=agg.proof, justification=proof.justification)


def verify_rotate_zk_aggregated(proof: ZkRotateAggProof,
                                max_authorities: int = 300,
                                config: StarkConfig = StarkConfig(),
                                outer_config: StarkConfig | None = None, *,
                                device, rng=None) -> bool:
    inp = RotateInput.decode(proof.input_bytes)
    out = RotateOutput.decode(proof.output_bytes)
    c = proof.commitment_statement
    n = proof.num_authorities
    if len(c.pubkeys) != n or len(c.step_digests) != n or n < 1:
        return False
    if c.step_digests[-1] != c.commitment or \
            c.commitment != out.new_authority_set_hash:
        return False
    if any(len(d) != 32 for d in c.step_digests):
        return False
    if [s for s in c.chunk_sizes if s < 1] or sum(c.chunk_sizes) != n:
        return False

    # structural byte checks on the public epoch-end header
    if not _header_walk_ok(proof, c.pubkeys, max_authorities):
        return False

    # justification of the current set over the claimed header hash
    if not _justified(proof, inp, device, rng):
        return False

    # ONE STARK covers the header hash + the whole commitment chain
    try:
        airs = aggregate_children(proof.header_bytes, proof.header_hash, c)
    except Exception:
        return False
    return aggregate_verify(airs, proof.aggregated_proof, config,
                            outer_config=outer_config, device=device)

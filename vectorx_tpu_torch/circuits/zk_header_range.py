"""header_range in zero knowledge — batched component proofs + public wiring.

The full reference header_range statement (C8: "blocks (trusted, target]
are hash-linked, their state/data roots commit to the published Merkle
roots, and the target is justified by the known authority set") carried
into ZK on this stack:

* ONE batched `Blake2bAir` proof (chunked by a trace-row budget) covering
  ALL headers: digest_i = Blake2b256(encoded header_i) — C4's gadget;
* a handful of batched `Sha256Air` proofs covering ALL interior nodes of
  the state-root AND data-root commitment trees — C6's commitments;
* the authority-set commitment chain via `zk_commitment` — C5's hash;
* GRANDPA signatures checked with the device-batched ed25519 verifier
  (`curves/ed25519_batch.py`) — sound verification, pending its own AIR.

The glue is PUBLIC wiring: header bytes, their claimed hashes, the
extracted state/data roots, and intermediate tree digests are all public,
so the verifier checks hash-linking, SCALE field extraction, and tree
structure directly on public data and checks a handful of STARK proofs.
For tree=256 this is ~4-6 proofs total, down from ~766 single-message
proofs.  The aggregated variant (`aggregate_header_range_proof`) folds
every component proof into ONE verifier-VM machine proof.

Port of `vectorx_tpu.circuits.zk_header_range`, both variants: every
proof runs on the `device` the caller names, and the verifiers derive the
verification keys and run the batched signature check there.
"""

from __future__ import annotations

from dataclasses import dataclass

from vectorx_tpu_torch.circuits.justification import verify_simple_justification
from vectorx_tpu_torch.circuits.subchain import decode_header_fields
from vectorx_tpu_torch.circuits.zk_commitment import _sha_rows, chunk_by_rows
from vectorx_tpu_torch.io.abi import HeaderRangeInput, HeaderRangeOutput
from vectorx_tpu_torch.stark.blake2b_air import SECTION as B2_SECTION
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir, blake2b_pad
from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.sha256_air import Sha256Air
from vectorx_tpu_torch.stark.verifier import verify


def _blake_rows(msg: bytes) -> int:
    return B2_SECTION * len(blake2b_pad(msg)) + 1


def _safe_verify(air, proof, config, device) -> bool:
    """Adversarial proof objects must reject, not raise."""
    try:
        return verify(air, proof, config, device=device)
    except Exception:
        return False


@dataclass
class ZkHeaderRangeProof:
    input_bytes: bytes
    output_bytes: bytes
    headers: list            # encoded header bytes (public witness data)
    header_hashes: list      # claimed Blake2b digests
    header_chunk_sizes: list  # headers covered per batched Blake2b proof
    header_proofs: list      # batched Blake2bAir proofs
    state_levels: list       # per level: claimed digests (state tree)
    data_levels: list
    sha_chunk_sizes: list    # interior nodes per batched SHA proof
    sha_proofs: list         # batched Sha256Air proofs (state ++ data nodes)
    justification: object    # JustificationData for the target block


def _tree_digests(leaves):
    import hashlib

    level = list(leaves)
    levels = []
    while len(level) > 1:
        level = [hashlib.sha256(level[2 * i] + level[2 * i + 1]).digest()
                 for i in range(len(level) // 2)]
        levels.append(level)
    return levels, level[0]


def _tree_messages(leaves, levels):
    """Level-major 64-byte interior-node messages from public wiring, or
    None on a structural mismatch."""
    messages, digests = [], []
    level = list(leaves)
    for lvl in levels:
        if len(lvl) != len(level) // 2:
            return None
        for i, claimed in enumerate(lvl):
            messages.append(level[2 * i] + level[2 * i + 1])
            digests.append(claimed)
        level = list(lvl)
    if len(level) != 1:
        return None
    return messages, digests, level[0]


def prove_header_range_zk(fetcher, input_bytes: bytes, tree_size: int,
                          max_authorities: int = 300,
                          config: StarkConfig = StarkConfig(), *,
                          device) -> ZkHeaderRangeProof:
    import hashlib

    inp = HeaderRangeInput.decode(input_bytes)
    assert tree_size & (tree_size - 1) == 0
    assert inp.target_block - inp.trusted_block <= tree_size

    headers, hashes = [], []
    state_leaves, data_leaves = [], []
    for b in range(inp.trusted_block + 1, inp.target_block + 1):
        enc = fetcher.get_encoded_header(b)
        headers.append(enc)
        hashes.append(hashlib.blake2b(enc, digest_size=32).digest())
        d = decode_header_fields(enc, len(enc))
        state_leaves.append(d.state_root)
        data_leaves.append(d.data_root)
    pad = tree_size - len(state_leaves)
    state_leaves += [b"\x00" * 32] * pad
    data_leaves += [b"\x00" * 32] * pad

    # batched Blake2b proofs over all headers
    h_sizes = chunk_by_rows(headers, _blake_rows)
    header_proofs, pos = [], 0
    for sz in h_sizes:
        air = Blake2bAir(headers[pos:pos + sz])
        assert air.digest_bytes_list() == hashes[pos:pos + sz]
        header_proofs.append(prove(air, air.build_trace(), config,
                                   device=device))
        pos += sz

    # batched SHA proofs over all interior nodes of both trees
    state_levels, state_root = _tree_digests(state_leaves)
    data_levels, data_root = _tree_digests(data_leaves)
    s_msgs, s_digs, _ = _tree_messages(state_leaves, state_levels)
    d_msgs, d_digs, _ = _tree_messages(data_leaves, data_levels)
    messages = s_msgs + d_msgs
    digests = s_digs + d_digs
    sha_sizes = chunk_by_rows(messages, _sha_rows)
    sha_proofs, pos = [], 0
    for sz in sha_sizes:
        air = Sha256Air(messages[pos:pos + sz])
        assert air.digest_bytes_list() == digests[pos:pos + sz]
        sha_proofs.append(prove(air, air.build_trace(), config,
                                device=device))
        pos += sz

    justification = fetcher.get_justification(
        inp.target_block, max_authorities=max_authorities)

    out = HeaderRangeOutput(
        target_header_hash=hashes[-1],
        state_root_commitment=state_root,
        data_root_commitment=data_root).encode()
    return ZkHeaderRangeProof(
        input_bytes=input_bytes, output_bytes=out,
        headers=headers, header_hashes=hashes,
        header_chunk_sizes=h_sizes, header_proofs=header_proofs,
        state_levels=state_levels, data_levels=data_levels,
        sha_chunk_sizes=sha_sizes, sha_proofs=sha_proofs,
        justification=justification)


def verify_header_range_zk(proof: ZkHeaderRangeProof, tree_size: int,
                           config: StarkConfig = StarkConfig(), *,
                           device, rng=None) -> bool:
    """Accept or reject `proof`.  The verification keys and the batched
    signature check run on `device`; `rng` draws the signature check's
    randomizers (see `verify_simple_justification`).

    The checks are the reference's, run cheapest first: the public wiring
    (hash links, block numbers, tree structure and roots), then the SHA-256
    chunk proofs, then the Blake2b chunk proofs, then the signatures.  The
    result is their conjunction, as in the reference; a tampered proof
    object is turned away before the expensive checks."""
    inp = HeaderRangeInput.decode(proof.input_bytes)
    out = HeaderRangeOutput.decode(proof.output_bytes)
    n = inp.target_block - inp.trusted_block
    if len(proof.headers) != n or len(proof.header_hashes) != n:
        return False
    if [s for s in proof.header_chunk_sizes if s < 1] or \
            sum(proof.header_chunk_sizes) != n or \
            len(proof.header_proofs) != len(proof.header_chunk_sizes):
        return False

    # 1. public hash-link / decode checks on the claimed header hashes
    state_leaves, data_leaves = [], []
    prev_hash = inp.trusted_header_hash
    for i, (enc, claimed) in enumerate(zip(proof.headers,
                                           proof.header_hashes)):
        try:
            d = decode_header_fields(enc, len(enc))
        except Exception:
            return False  # malformed attacker-controlled header bytes
        if d.parent_hash != prev_hash:
            return False
        if d.block_number != inp.trusted_block + 1 + i:
            return False
        prev_hash = claimed
        state_leaves.append(d.state_root)
        data_leaves.append(d.data_root)
    if proof.header_hashes[-1] != out.target_header_hash:
        return False
    pad = tree_size - len(state_leaves)
    state_leaves += [b"\x00" * 32] * pad
    data_leaves += [b"\x00" * 32] * pad

    # 2. commitment trees: batched SHA proofs against rebuilt wiring
    s_wired = _tree_messages(state_leaves, proof.state_levels)
    d_wired = _tree_messages(data_leaves, proof.data_levels)
    if s_wired is None or d_wired is None:
        return False
    if s_wired[2] != out.state_root_commitment or \
            d_wired[2] != out.data_root_commitment:
        return False
    messages = s_wired[0] + d_wired[0]
    digests = s_wired[1] + d_wired[1]
    if [s for s in proof.sha_chunk_sizes if s < 1] or \
            sum(proof.sha_chunk_sizes) != len(messages) or \
            len(proof.sha_proofs) != len(proof.sha_chunk_sizes):
        return False
    pos = 0
    for sz, stark in zip(proof.sha_chunk_sizes, proof.sha_proofs):
        air = Sha256Air.statement(messages[pos:pos + sz],
                                  digests[pos:pos + sz])
        if not _safe_verify(air, stark, config, device):
            return False
        pos += sz

    # 3. batched header-hash proofs
    pos = 0
    for sz, stark in zip(proof.header_chunk_sizes, proof.header_proofs):
        air = Blake2bAir.statement(proof.headers[pos:pos + sz],
                                   proof.header_hashes[pos:pos + sz])
        if not _safe_verify(air, stark, config, device):
            return False
        pos += sz

    # 4. justification on the target header (device-batched ed25519)
    try:
        verify_simple_justification(
            proof.justification, inp.target_block, out.target_header_hash,
            inp.authority_set_id, inp.authority_set_hash,
            signature_backend="device", device=device, rng=rng)
    except Exception:
        return False
    return True


# ---------------------------------------------------------------------------
# Aggregated variant: ALL component STARKs folded into ONE machine proof
# ---------------------------------------------------------------------------

@dataclass
class ZkHeaderRangeAggProof:
    """Like ZkHeaderRangeProof, but the component STARKs are replaced by
    ONE verifier-VM proof (recursion/) — the single-succinct-artifact
    shape of the reference's wrapped map-reduce proof (upstream
    circuits/header_range.rs:71-88)."""

    input_bytes: bytes
    output_bytes: bytes
    headers: list
    header_hashes: list
    header_chunk_sizes: list
    state_levels: list
    data_levels: list
    sha_chunk_sizes: list
    aggregated_proof: object     # one StarkProof over the machine trace
    justification: object


def _component_airs(proof, messages, digests) -> list:
    """The child statements, in the fixed aggregation order: header-hash
    chunks then commitment-tree chunks."""
    airs = []
    pos = 0
    for sz in proof.header_chunk_sizes:
        airs.append(Blake2bAir.statement(
            proof.headers[pos:pos + sz],
            proof.header_hashes[pos:pos + sz]))
        pos += sz
    pos = 0
    for sz in proof.sha_chunk_sizes:
        airs.append(Sha256Air.statement(messages[pos:pos + sz],
                                        digests[pos:pos + sz]))
        pos += sz
    return airs


def aggregate_children(proof) -> list:
    """The aggregated statement's child AIRs, from the public fields of a
    `ZkHeaderRangeProof` or `ZkHeaderRangeAggProof` the prover made: the
    Blake2b header chunks, then the SHA-256 chunks over the state tree's
    and the data tree's interior nodes."""
    state_leaves, data_leaves = [], []
    for enc in proof.headers:
        d = decode_header_fields(enc, len(enc))
        state_leaves.append(d.state_root)
        data_leaves.append(d.data_root)
    tree_size = len(proof.state_levels[0]) * 2 if proof.state_levels else \
        len(state_leaves)
    pad = tree_size - len(state_leaves)
    state_leaves += [b"\x00" * 32] * pad
    data_leaves += [b"\x00" * 32] * pad
    s_msgs, s_digs, _ = _tree_messages(state_leaves, proof.state_levels)
    d_msgs, d_digs, _ = _tree_messages(data_leaves, proof.data_levels)
    return _component_airs(proof, s_msgs + d_msgs, s_digs + d_digs)


def aggregate_header_range_proof(proof: ZkHeaderRangeProof,
                                 config: StarkConfig = StarkConfig(),
                                 outer_config: StarkConfig | None = None, *,
                                 device) -> ZkHeaderRangeAggProof:
    """Fold a component-proof header_range into ONE machine proof, made on
    `device`."""
    from vectorx_tpu_torch.recursion.aggregate import aggregate_prove

    airs = aggregate_children(proof)
    children_proofs = list(proof.header_proofs) + list(proof.sha_proofs)
    agg = aggregate_prove(airs, children_proofs, config,
                          outer_config=outer_config, device=device)
    return ZkHeaderRangeAggProof(
        input_bytes=proof.input_bytes, output_bytes=proof.output_bytes,
        headers=proof.headers, header_hashes=proof.header_hashes,
        header_chunk_sizes=proof.header_chunk_sizes,
        state_levels=proof.state_levels, data_levels=proof.data_levels,
        sha_chunk_sizes=proof.sha_chunk_sizes,
        aggregated_proof=agg.proof, justification=proof.justification)


def verify_header_range_zk_aggregated(
        proof: ZkHeaderRangeAggProof, tree_size: int,
        config: StarkConfig = StarkConfig(),
        outer_config: StarkConfig | None = None, *,
        device, rng=None) -> bool:
    """Verify the aggregated header_range: the public wiring checks of
    `verify_header_range_zk`, the justification, then exactly ONE STARK
    verification (on `device`).

    The reference checks the machine proof before the justification; here
    the cheap public checks (wiring, then the batched signatures) come
    first, as in `verify_header_range_zk`.  The result is the same
    conjunction."""
    from vectorx_tpu_torch.recursion.aggregate import aggregate_verify

    inp = HeaderRangeInput.decode(proof.input_bytes)
    out = HeaderRangeOutput.decode(proof.output_bytes)
    n = inp.target_block - inp.trusted_block
    if len(proof.headers) != n or len(proof.header_hashes) != n:
        return False
    if [s for s in proof.header_chunk_sizes if s < 1] or \
            sum(proof.header_chunk_sizes) != n:
        return False

    # public wiring: hash-linking, decode, commitment-tree structure
    state_leaves, data_leaves = [], []
    prev_hash = inp.trusted_header_hash
    for i, (enc, claimed) in enumerate(zip(proof.headers,
                                           proof.header_hashes)):
        try:
            d = decode_header_fields(enc, len(enc))
        except Exception:
            return False
        if d.parent_hash != prev_hash:
            return False
        if d.block_number != inp.trusted_block + 1 + i:
            return False
        prev_hash = claimed
        state_leaves.append(d.state_root)
        data_leaves.append(d.data_root)
    if proof.header_hashes[-1] != out.target_header_hash:
        return False
    pad = tree_size - len(state_leaves)
    state_leaves += [b"\x00" * 32] * pad
    data_leaves += [b"\x00" * 32] * pad
    s_wired = _tree_messages(state_leaves, proof.state_levels)
    d_wired = _tree_messages(data_leaves, proof.data_levels)
    if s_wired is None or d_wired is None:
        return False
    if s_wired[2] != out.state_root_commitment or \
            d_wired[2] != out.data_root_commitment:
        return False
    messages = s_wired[0] + d_wired[0]
    digests = s_wired[1] + d_wired[1]
    if [s for s in proof.sha_chunk_sizes if s < 1] or \
            sum(proof.sha_chunk_sizes) != len(messages):
        return False

    # justification on the target header (device-batched ed25519)
    try:
        verify_simple_justification(
            proof.justification, inp.target_block, out.target_header_hash,
            inp.authority_set_id, inp.authority_set_hash,
            signature_backend="device", device=device, rng=rng)
    except Exception:
        return False

    # ONE proof covers every component statement
    try:
        airs = _component_airs(proof, messages, digests)
    except Exception:
        return False
    return aggregate_verify(airs, proof.aggregated_proof, config,
                            outer_config=outer_config, device=device)

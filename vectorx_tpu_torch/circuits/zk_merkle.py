"""ZK proof of the SHA-256 simple Merkle root — the data/state-root
commitment of the subchain map-reduce in zero knowledge.

The commitment tree is the reference's byte-level simple Merkle
(upstream circuits/input/mod.rs:464-489 and the in-circuit
get_root_from_hashed_leaves + reduce-stage SHA256 parents,
subchain_verification.rs:212-274): leaves are NOT pre-hashed, interior
nodes are SHA256(left ‖ right).

ALL interior nodes of the tree are proven in a handful of BATCHED
`Sha256Air` proofs (many 64-byte messages per trace); nodes are glued by
PUBLIC wiring — a node's message is the concatenation of its children's
public digests — which the verifier checks directly when rebuilding the
statement, never hashing anything itself.  A 256-leaf tree is 2-3 proofs
instead of 255.

Port of `vectorx_tpu.circuits.zk_merkle`: the proofs are made and checked
on the `device` the caller names.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from vectorx_tpu_torch.circuits.zk_commitment import _sha_rows, chunk_by_rows
from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.sha256_air import Sha256Air
from vectorx_tpu_torch.stark.verifier import verify


@dataclass
class MerkleRootProof:
    leaves: list            # public 32-byte leaves (power-of-two count)
    level_digests: list     # per level above the leaves: list of digests
    chunk_sizes: list       # interior nodes covered by each batched proof
    node_proofs: list       # one StarkProof per chunk (batched Sha256Air)
    root: bytes


def _interior_messages(leaves, level_digests):
    """Level-major list of 64-byte node messages, from public wiring."""
    messages, digests = [], []
    level = list(leaves)
    for lvl in level_digests:
        if len(lvl) != len(level) // 2:
            return None
        for i, claimed in enumerate(lvl):
            messages.append(level[2 * i] + level[2 * i + 1])
            digests.append(claimed)
        level = list(lvl)
    if len(level) != 1:
        return None
    return messages, digests, level[0]


def prove_merkle_root(leaves: list[bytes],
                      config: StarkConfig = StarkConfig(), *,
                      device) -> MerkleRootProof:
    n = len(leaves)
    assert n and n & (n - 1) == 0 and all(len(x) == 32 for x in leaves)
    level = list(leaves)
    level_digests = []
    while len(level) > 1:
        level = [hashlib.sha256(level[2 * i] + level[2 * i + 1]).digest()
                 for i in range(len(level) // 2)]
        level_digests.append(level)
    wired = _interior_messages(leaves, level_digests)
    messages, digests, root = wired if wired else ([], [], leaves[0])
    sizes = chunk_by_rows(messages, _sha_rows)
    proofs, pos = [], 0
    for sz in sizes:
        air = Sha256Air(messages[pos:pos + sz])
        assert air.digest_bytes_list() == digests[pos:pos + sz]
        proofs.append(prove(air, air.build_trace(), config, device=device))
        pos += sz
    return MerkleRootProof(leaves=list(leaves), level_digests=level_digests,
                           chunk_sizes=sizes, node_proofs=proofs, root=root)


def verify_merkle_root(proof: MerkleRootProof,
                       config: StarkConfig = StarkConfig(), *,
                       device) -> bool:
    """Accept or reject `proof`; the verification keys are derived on
    `device`.  A malformed proof object is rejected, never raised on."""
    n = len(proof.leaves)
    if n == 0 or n & (n - 1):
        return False
    if n == 1:
        return not proof.node_proofs and proof.root == proof.leaves[0]
    wired = _interior_messages(proof.leaves, proof.level_digests)
    if wired is None:
        return False
    messages, digests, root = wired
    if root != proof.root:
        return False
    if [s for s in proof.chunk_sizes if s < 1] or \
            sum(proof.chunk_sizes) != len(messages) or \
            len(proof.node_proofs) != len(proof.chunk_sizes):
        return False
    pos = 0
    for sz, stark in zip(proof.chunk_sizes, proof.node_proofs):
        air = Sha256Air.statement(messages[pos:pos + sz],
                                  digests[pos:pos + sz])
        try:
            if not verify(air, stark, config, device=device):
                return False
        except Exception:
            return False
        pos += sz
    return True

"""Subchain verification — the header_range map-reduce workhorse (C6).

Port of `vectorx_tpu.circuits.subchain`: the batched Blake2b and the SHA-256
Merkle levels run on the device the caller names.  Equivalent of `SubChainVerifier::verify_subchain`
(upstream circuits/builder/subchain_verification.rs:55-304), keeping
its exact fixed-shape semantics:

* `num_map_jobs = next_pow2(MAX_NUM_HEADERS / HEADERS_PER_MAP)` leaves of 8
  headers each (subchain_verification.rs:71-75);
* headers past `global_end_block` are empty (size 0) and masked "noop"
  (:136-200), so any range ≤ tree size verifies in one fixed shape;
* per-leaf: hash-link + sequential-number checks with noop masking, batch
  endpoint checks (:202-210), 8-leaf SHA-256 state/data Merkle roots with
  disabled leaves zeroed (:212-220);
* reduce: adjacency unless the right subchain is inactive, rightmost
  endpoint select, parent = SHA256(left || right) (:233-289);
* top: start_parent == trusted_header_hash, end_block == target (:292-296).

Device mapping: ALL header hashes for the whole range run as ONE batched
Blake2b call; every Merkle level is one batched SHA-256 call.  The scalar
link bookkeeping (≤ tree-size entries) stays on host.
"""

from __future__ import annotations

import hashlib
import operator
from dataclasses import dataclass

import numpy as np

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.hash.blake2b import blake2b_batch
from vectorx_tpu_torch.merkle import sha256_merkle_root_device

HEADERS_PER_MAP = 8  # consts.rs:6


class SubchainError(ValueError):
    pass


@dataclass
class SubchainOutput:
    """Mirror of `SubchainVerificationVariable` (vars.rs:58-64)."""

    target_header_hash: bytes
    state_root_merkle_root: bytes
    data_root_merkle_root: bytes


@dataclass
class DecodedHeader:
    block_number: int
    parent_hash: bytes
    state_root: bytes
    data_root: bytes


def _next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


def decode_header_fields(enc: bytes, size: int) -> DecodedHeader:
    """The circuit's decode rules (decoder.rs:104-157): parent hash bytes
    0..32, compact block number at 32, state root at the mode-dependent
    offset, data root = last 32 bytes of the `size`-byte prefix."""
    if size == 0:
        return DecodedHeader(0, b"\x00" * 32, b"\x00" * 32, b"\x00" * 32)
    parent = enc[0:32]
    number, mode, consumed = scale.compact_decode(enc[32:37])
    state_off = 32 + consumed
    state_root = enc[state_off:state_off + 32]
    data_root = enc[size - 32:size]
    return DecodedHeader(number, parent, state_root, data_root)


@dataclass
class LeafOut:
    """A subchain node: a map leaf's 8 headers or a reduced range of them.
    `state`/`data` are the node's commitments, in whatever form the caller
    keeps them (its leaves' roots as a list, or their Merkle root)."""

    num_blocks: int
    start_block: int
    start_header_hash: bytes
    start_parent: bytes
    end_block: int
    end_header_hash: bytes
    state: object
    data: object


def fetch_headers(fetcher, first_block: int, count: int, target_block: int,
                  max_header_size: int, device):
    """(Blake2b hashes (count, 32), decoded fields) of the `count` headers
    from `first_block` on, those past `target_block` empty (size 0) —
    HeaderRangeFetcherHint semantics (:306-378); one batched Blake2b call
    on `device`."""
    encs: list[bytes] = []
    sizes = np.zeros(count, dtype=np.uint32)
    buf = np.zeros((count, max_header_size), dtype=np.uint8)
    for i in range(count):
        block = first_block + i
        if block <= target_block:
            enc = fetcher.get_encoded_header(block)
            if len(enc) > max_header_size:
                raise SubchainError(
                    f"header {block} exceeds max size {max_header_size}")
            buf[i, :len(enc)] = np.frombuffer(enc, dtype=np.uint8)
            sizes[i] = len(enc)
            encs.append(enc)
        else:
            encs.append(b"")
    hashes = blake2b_batch(buf, sizes, device)
    decoded = [decode_header_fields(encs[i], int(sizes[i]))
               for i in range(count)]
    return hashes, decoded


def map_leaf(j: int, hashes, decoded, batch_start: int,
             target_block: int) -> LeafOut:
    """Leaf `j`'s masked link checks over its 8 headers (`hashes`,
    `decoded`, from block `batch_start` on) and batch endpoint checks
    (:136-210); `state`/`data` are the 8 leaves, zeroed where masked."""
    batch_end = batch_start + HEADERS_PER_MAP - 1
    disabled = target_block < batch_start
    noop = disabled
    end_block = 0
    end_hash = b"\x00" * 32
    num_headers = 0
    state_leaves, data_leaves = [], []
    for i in range(HEADERS_PER_MAP):
        d = decoded[i]
        if i > 0 and not noop:
            prev = decoded[i - 1]
            if d.parent_hash != hashes[i - 1].tobytes() or \
                    d.block_number != prev.block_number + 1:
                raise SubchainError(f"broken link at block {batch_start + i}")
        if not noop:
            end_block = d.block_number
            end_hash = hashes[i].tobytes()
            num_headers += 1
            state_leaves.append(d.state_root)
            data_leaves.append(d.data_root)
        else:
            state_leaves.append(b"\x00" * 32)
            data_leaves.append(b"\x00" * 32)
        if d.block_number == target_block and not disabled:
            noop = True
    if not disabled and decoded[0].block_number != batch_start:
        raise SubchainError(f"leaf {j}: first block number mismatch")
    if not noop and end_block != batch_end:
        raise SubchainError(f"leaf {j}: last block number mismatch")
    return LeafOut(
        num_blocks=num_headers,
        start_block=decoded[0].block_number,
        start_header_hash=hashes[0].tobytes(),
        start_parent=decoded[0].parent_hash,
        end_block=end_block,
        end_header_hash=end_hash,
        state=state_leaves,
        data=data_leaves,
    )


def reduce_pair(left: LeafOut, right: LeafOut, join) -> LeafOut:
    """One reduce step (:233-289): adjacency unless the right subchain is
    inactive, the rightmost endpoint; `join(l, r)` combines the two
    sides' state and data commitments."""
    right_inactive = right.num_blocks == 0
    if not right_inactive:
        if left.end_header_hash != right.start_parent or \
                left.end_block != right.start_block - 1:
            raise SubchainError("subchains not linked in reduce")
    pick = left if right_inactive else right
    return LeafOut(
        num_blocks=left.num_blocks + right.num_blocks,
        start_block=left.start_block,
        start_header_hash=left.start_header_hash,
        start_parent=left.start_parent,
        end_block=pick.end_block,
        end_header_hash=pick.end_header_hash,
        state=join(left.state, right.state),
        data=join(left.data, right.data),
    )


def verify_subchain(fetcher, trusted_block: int, trusted_header_hash: bytes,
                    target_block: int, max_num_headers: int,
                    max_header_size: int = 35840, *,
                    device) -> SubchainOutput:
    num_map_jobs = _next_pow2(max_num_headers // HEADERS_PER_MAP)
    total = num_map_jobs * HEADERS_PER_MAP

    # ---- fetch + pad, and ALL header hashes in one batched Blake2b --------
    hashes, decoded = fetch_headers(fetcher, trusted_block + 1, total,
                                    target_block, max_header_size, device)

    # ---- map stage: per-leaf masked link checks ---------------------------
    leaves = []
    for j in range(num_map_jobs):
        base = j * HEADERS_PER_MAP
        sl = slice(base, base + HEADERS_PER_MAP)
        leaves.append(map_leaf(j, hashes[sl], decoded[sl],
                               trusted_block + 1 + base, target_block))

    # ---- reduce stage: the leaves' lists concatenate ----------------------
    nodes = leaves
    while len(nodes) > 1:
        nodes = [reduce_pair(nodes[k], nodes[k + 1], operator.add)
                 for k in range(0, len(nodes), 2)]
    root = nodes[0]

    if root.start_parent != trusted_header_hash:
        raise SubchainError("start parent != trusted header hash")
    if root.end_block != target_block:
        raise SubchainError("end block != target block")

    # ---- commitments: batched SHA-256 Merkle over the tree -------------
    # The per-leaf 8-ary roots + SHA256(left||right) reduce tree is exactly
    # the full binary tree over the zero-padded leaves, so one batched
    # build per commitment (bit-exact with input/mod.rs:464-489).  The
    # tree has `max_num_headers` leaves, as the fetcher's commitments, the
    # dummy and the ZK statement have: at trees 2 and 4 `total` is 8, and
    # the reference's root over all 8 leaves is another value
    # (`vectorx_tpu/circuits/subchain.py:82-83`, a fault kept there).
    n = max_num_headers
    state_arr = np.frombuffer(b"".join(root.state[:n]),
                              dtype=np.uint8).reshape(n, 32)
    data_arr = np.frombuffer(b"".join(root.data[:n]),
                             dtype=np.uint8).reshape(n, 32)
    return SubchainOutput(
        target_header_hash=root.end_header_hash,
        state_root_merkle_root=sha256_merkle_root_device(state_arr, device),
        data_root_merkle_root=sha256_merkle_root_device(data_arr, device),
    )

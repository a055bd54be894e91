"""Poseidon Merkle trees over field-element digests (plonky2 `MerkleCap`
layout: stop `cap_height` levels below the root and publish all 2^cap_height
nodes).  Port of the Poseidon half of `vectorx_tpu.merkle`.

The prover's trees (`build_layers`, `DeviceTree`) stay on the device of the
leaves they are given; `build_tree` hashes there too and keeps the layers
in host memory (`PoseidonMerkleTree`), for trees that are read at only a
few positions.  The verifier's path checks are host code: the
scalar `verify_path` walks with `poseidon_py`, and the batched walks run the
port's own torch permutation on CPU tensors, one batched permutation per
tree level across all queries.

The SHA-256 byte trees of the header_range commitments sit at the end: the
host root (hashlib) and the batched root, one `hash.sha256` compression
pair per tree level, on an explicit device.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hash import poseidon, poseidon_py
from vectorx_tpu_torch.hash import sha256 as sha

# The verifier's batched walks are host computations by design.
HOST = torch.device("cpu")


class DeviceTree:
    """Merkle tree whose digest layers (leaf digests first, cap last) stay
    on the device as (n, 4) int64 tensors.  Only the cap is transferred
    (lazily, for the transcript); openings are gathered in bulk by
    `stark.stages.open_positions`."""

    __slots__ = ("layers", "cap_height", "_cap")

    def __init__(self, layers, cap_height: int):
        self.layers = layers
        self.cap_height = cap_height
        self._cap = None

    def cap_ints(self) -> list[list[int]]:
        if self._cap is None:
            self._cap = [[int(x) for x in row]
                         for row in gl.to_u64(self.layers[-1])]
        return self._cap


# Poseidon batches are hashed in row blocks: the width-12 permutation's MDS
# stage materializes (B, 12, 12) temporaries, so an unchunked 2^24-leaf
# level would allocate tens of GB.  2^19 rows = 0.6 GB per temporary.
POSEIDON_CHUNK_ROWS = 1 << 19


def _rows_blocked(fn, *xs):
    """Apply fn over row blocks of the leading axis; concatenate results.
    Row-independent hashing makes this equal to one call."""
    n = xs[0].shape[0]
    if n <= POSEIDON_CHUNK_ROWS:
        return fn(*xs)
    return torch.cat([fn(*[x[s:s + POSEIDON_CHUNK_ROWS] for x in xs])
                      for s in range(0, n, POSEIDON_CHUNK_ROWS)], dim=0)


def hash_leaves(leaves: torch.Tensor) -> torch.Tensor:
    """(n, leaf_len) -> (n, 4) digests with plonky2's hash_or_noop rule:
    leaves of <= 4 elements are zero-padded and used as digests directly."""
    leaf_len = leaves.shape[1]
    if leaf_len <= poseidon.DIGEST:
        return torch.nn.functional.pad(leaves, (0, poseidon.DIGEST - leaf_len))
    return _rows_blocked(poseidon.hash_no_pad, leaves)


def build_layers(leaves: torch.Tensor, cap_height: int = 0) -> list:
    """Digest layers (leaf digests first, cap last) on the leaves' device."""
    return layers_from_digests(hash_leaves(leaves), cap_height)


def layers_from_digests(d: torch.Tensor, cap_height: int = 0) -> list:
    n = d.shape[0]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    assert (1 << cap_height) <= n
    layers = [d]
    while d.shape[0] > (1 << cap_height):
        d = _rows_blocked(poseidon.two_to_one, d[0::2], d[1::2])
        layers.append(d)
    return layers


class PoseidonMerkleTree:
    """Merkle digest layers (leaf digests first, cap last) in host memory
    as canonical (n, 4) uint64 numpy arrays: the same duck type as
    DeviceTree for `cap_ints()`, with openings gathered on the host.

    Trees written once and read at only Q positions (the streamed
    prover's commitments, FRI fold layers) do not earn device residency:
    keeping them on the host bounds the prover's device memory."""

    __slots__ = ("layers", "cap_height", "_cap")

    def __init__(self, layers, cap_height: int):
        self.layers = layers          # list[np.ndarray (n, 4) uint64]
        self.cap_height = cap_height
        self._cap = None

    @classmethod
    def from_device(cls, tree: DeviceTree) -> "PoseidonMerkleTree":
        """Copy a DeviceTree's layers to the host, each once."""
        return cls([gl.to_u64(layer) for layer in tree.layers],
                   tree.cap_height)

    def nbytes(self) -> int:
        return sum(layer.nbytes for layer in self.layers)

    def cap_ints(self) -> list[list[int]]:
        if self._cap is None:
            self._cap = [[int(x) for x in row] for row in self.layers[-1]]
        return self._cap

    def open(self, index: int) -> list[list[int]]:
        """Sibling digests from leaf level up to (but excluding) the cap."""
        return [[int(x) for x in lvl[0]] for lvl in self.open_paths([index])]

    def open_paths(self, indices) -> list:
        """Sibling digests per level (leaf-first, cap excluded) for every
        query index, as (Q, 4) uint64 arrays."""
        cur = np.asarray(indices, dtype=np.int64)
        sibs = []
        for layer in self.layers[:-1]:
            sibs.append(layer[cur ^ 1])
            cur = cur >> 1
        return sibs


def build_tree(leaves: torch.Tensor, cap_height: int = 0) -> PoseidonMerkleTree:
    """Host tree over (n, leaf_len) leaves, hashed on the leaves' device."""
    return build_tree_from_digests(hash_leaves(leaves), cap_height)


def build_tree_from_digests(d: torch.Tensor,
                            cap_height: int = 0) -> PoseidonMerkleTree:
    """Host tree over already-hashed (n, 4) leaf digests, its internal
    layers hashed on the digests' device."""
    return PoseidonMerkleTree.from_device(
        DeviceTree(layers_from_digests(d, cap_height), cap_height))


def _two_to_one_host(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Batched digest compression on the host: (B, 4) x (B, 4) -> (B, 4)."""
    return gl.to_u64(poseidon.two_to_one(gl.from_u64(left, HOST),
                                         gl.from_u64(right, HOST)))


def _hash_host(rows: np.ndarray) -> np.ndarray:
    """Batched sponge over equal-length rows on the host: (B, L) -> (B, 4)."""
    return gl.to_u64(poseidon.hash_no_pad(gl.from_u64(rows, HOST)))


def verify_path(leaf_ints: list[int], index: int, path: list[list[int]],
                cap_ints: list[list[int]], num_leaves: int) -> bool:
    """Host-side verification of a Merkle opening against a cap.

    `num_leaves` pins the tree height: a prover-chosen path length would
    otherwise shift which cap slot gets compared (or index out of range),
    weakening Merkle binding.  Malformed proofs return False, never raise."""
    if num_leaves <= 0 or num_leaves & (num_leaves - 1):
        return False
    height = num_leaves.bit_length() - 1
    cap_height = len(cap_ints).bit_length() - 1
    if len(cap_ints) != 1 << cap_height or cap_height > height:
        return False
    if len(path) != height - cap_height:
        return False
    if not 0 <= index < num_leaves:
        return False
    if any(len(sib) != poseidon.DIGEST for sib in path):
        return False
    if len(leaf_ints) <= poseidon.DIGEST:
        digest = list(leaf_ints) + [0] * (poseidon.DIGEST - len(leaf_ints))
    else:
        digest = poseidon_py.hash_no_pad(leaf_ints)
    idx = index
    for sib in path:
        if idx & 1:
            digest = poseidon_py.two_to_one(sib, digest)
        else:
            digest = poseidon_py.two_to_one(digest, sib)
        idx >>= 1
    return digest == list(cap_ints[idx])


def verify_paths(leaves: list, indices: list, paths: list,
                 cap_ints: list[list[int]], num_leaves: int) -> bool:
    """Batched `verify_path` over one tree's query openings: ONE
    vectorized permutation per level across all queries instead of a
    scalar Python permutation per (query, level).

    A production-FRI verification walks thousands of path permutations,
    so they are batched per level.  Same acceptance set as the scalar loop: every structural check is applied per query, and ragged
    shapes (differing leaf/path lengths — never produced by this prover)
    fall back to the scalar path.  Malformed input returns False."""
    q = len(indices)
    if not (len(leaves) == len(paths) == q):
        return False
    if q == 0:
        return True
    if num_leaves <= 0 or num_leaves & (num_leaves - 1):
        return False
    height = num_leaves.bit_length() - 1
    cap_height = len(cap_ints).bit_length() - 1
    if len(cap_ints) != 1 << cap_height or cap_height > height:
        return False
    levels = height - cap_height
    leaf_len = len(leaves[0])
    if any(len(lf) != leaf_len for lf in leaves) \
            or any(len(p) != levels for p in paths):
        # ragged: scalar fallback keeps acceptance semantics exact
        return all(verify_path(lf, ix, p, cap_ints, num_leaves)
                   for lf, ix, p in zip(leaves, indices, paths))
    for ix in indices:
        if not 0 <= ix < num_leaves:
            return False
    for p in paths:
        if any(len(sib) != poseidon.DIGEST for sib in p):
            return False
    try:
        leaf_arr = np.array(leaves, dtype=np.uint64)
        path_arr = [np.array([p[lvl] for p in paths], dtype=np.uint64)
                    for lvl in range(levels)]
        idx = np.array(indices, dtype=np.int64)
    except (ValueError, OverflowError, TypeError):
        return False
    if leaf_len <= poseidon.DIGEST:
        digest = np.zeros((q, poseidon.DIGEST), dtype=np.uint64)
        digest[:, :leaf_len] = leaf_arr
    else:
        digest = _hash_host(leaf_arr)
    digest = _walk_levels(digest, idx.copy(), path_arr)
    try:
        cap = np.array(cap_ints, dtype=np.uint64)
    except (ValueError, OverflowError, TypeError):
        return False
    return bool(np.all(digest == cap[idx >> levels]))


def _walk_levels(digest: np.ndarray, idx: np.ndarray, path_arr: list):
    """Vectorized bottom-up walk: one batched permutation per level."""
    for sib in path_arr:
        odd = (idx & 1).astype(bool)[:, None]
        left = np.where(odd, sib, digest)
        right = np.where(odd, digest, sib)
        digest = _two_to_one_host(left, right)
        idx >>= 1
    return digest


def verify_paths_jagged(groups: list) -> bool:
    """Batched path verification over trees of DIFFERENT heights (the FRI
    fold layers): all trees' walks run diagonally in ONE fused level loop
    — each level step is a single batched permutation over every still-
    active lane, with finished lanes frozen.  groups: list of
    (leaves, indices, paths, cap_ints, num_leaves) per tree.

    Equivalent acceptance to per-tree `verify_paths` (which remains the
    fallback for ragged/malformed shapes within a tree)."""
    metas = []                    # (q, levels, cap_height)
    for leaves, indices, paths, cap_ints, num_leaves in groups:
        q = len(indices)
        if not (len(leaves) == len(paths) == q):
            return False
        if num_leaves <= 0 or num_leaves & (num_leaves - 1):
            return False
        height = num_leaves.bit_length() - 1
        cap_height = len(cap_ints).bit_length() - 1
        if len(cap_ints) != 1 << cap_height or cap_height > height:
            return False
        levels = height - cap_height
        leaf_len = len(leaves[0]) if leaves else 0
        if any(len(lf) != leaf_len for lf in leaves) \
                or any(len(p) != levels for p in paths) \
                or any(len(sib) != poseidon.DIGEST
                       for p in paths for sib in p) \
                or leaf_len > poseidon.DIGEST:
            return all(verify_paths(lv, list(ix), pt, ci, nl)
                       for (lv, ix, pt, ci, nl) in groups)
        for ix in indices:
            if not 0 <= ix < num_leaves:
                return False
        metas.append((q, levels, cap_height))
    total = sum(m[0] for m in metas)
    if total == 0:
        return True
    max_levels = max(m[1] for m in metas)
    try:
        digest = np.zeros((total, poseidon.DIGEST), dtype=np.uint64)
        idx = np.zeros(total, dtype=np.int64)
        n_lvl = np.zeros(total, dtype=np.int64)
        sibs = np.zeros((max_levels, total, poseidon.DIGEST),
                        dtype=np.uint64)
        pos = 0
        for (leaves, indices, paths, _, _), (q, levels, _) in \
                zip(groups, metas):
            if q:
                la = np.array(leaves, dtype=np.uint64)
                digest[pos:pos + q, :la.shape[1]] = la
                idx[pos:pos + q] = np.array(indices, dtype=np.int64)
                n_lvl[pos:pos + q] = levels
                for lvl in range(levels):
                    sibs[lvl, pos:pos + q] = np.array(
                        [p[lvl] for p in paths], dtype=np.uint64)
            pos += q
    except (ValueError, OverflowError, TypeError):
        return False
    for lvl in range(max_levels):
        active = (lvl < n_lvl)[:, None]
        odd = (idx & 1).astype(bool)[:, None]
        left = np.where(odd, sibs[lvl], digest)
        right = np.where(odd, digest, sibs[lvl])
        new = _two_to_one_host(left, right)
        digest = np.where(active, new, digest)
        idx = np.where(active[:, 0], idx >> 1, idx)
    pos = 0
    for (_, _, _, cap_ints, _), (q, _levels, _ch) in zip(groups, metas):
        try:
            cap = np.array(cap_ints, dtype=np.uint64)
        except (ValueError, OverflowError, TypeError):
            return False
        if not np.all(digest[pos:pos + q] == cap[idx[pos:pos + q]]):
            return False
        pos += q
    return True


def verify_paths_multi(groups: list, indices: list, num_leaves: int) -> bool:
    """`verify_paths` over SEVERAL same-height trees at once (the STARK
    verifier opens trace/quotient/constants/aux trees at the same query
    positions): the level walks are fused so each tree level costs ONE
    batched permutation over len(groups)·Q lanes instead of one call per
    (tree, level).  groups: list of (leaves, paths, cap_ints)."""
    q = len(indices)
    if num_leaves <= 0 or num_leaves & (num_leaves - 1):
        return False
    height = num_leaves.bit_length() - 1
    digests, caps = [], []
    for leaves, paths, cap_ints in groups:
        if not (len(leaves) == len(paths) == q):
            return False
        cap_height = len(cap_ints).bit_length() - 1
        if len(cap_ints) != 1 << cap_height or cap_height > height:
            return False
        levels = height - cap_height
        leaf_len = len(leaves[0]) if leaves else 0
        if any(len(lf) != leaf_len for lf in leaves) \
                or any(len(p) != levels for p in paths) \
                or any(len(sib) != poseidon.DIGEST
                       for p in paths for sib in p):
            # ragged (or unequal cap heights below): per-tree fallback
            return all(verify_paths(lv, list(indices), pt, ci, num_leaves)
                       for (lv, pt, ci) in groups)
        caps.append((cap_height, cap_ints))
    if len({ch for ch, _ in caps}) > 1:
        return all(verify_paths(lv, list(indices), pt, ci, num_leaves)
                   for (lv, pt, ci) in groups)
    for ix in indices:
        if not 0 <= ix < num_leaves:
            return False
    levels = height - caps[0][0]
    try:
        for leaves, paths, _ in groups:
            leaf_arr = np.array(leaves, dtype=np.uint64)
            leaf_len = leaf_arr.shape[1]
            if leaf_len <= poseidon.DIGEST:
                d = np.zeros((q, poseidon.DIGEST), dtype=np.uint64)
                d[:, :leaf_len] = leaf_arr
            else:
                d = _hash_host(leaf_arr)
            digests.append(d)
        idx = np.array(list(indices) * len(groups), dtype=np.int64)
        path_arr = [np.concatenate(
            [np.array([p[lvl] for p in paths], dtype=np.uint64)
             for _, paths, _ in groups], axis=0) for lvl in range(levels)]
    except (ValueError, OverflowError, TypeError):
        return False
    digest = _walk_levels(np.concatenate(digests, axis=0), idx.copy(),
                          path_arr)
    slot = np.array(list(indices), dtype=np.int64) >> levels
    for gi, (_, cap_ints) in enumerate(caps):
        try:
            cap = np.array(cap_ints, dtype=np.uint64)
        except (ValueError, OverflowError, TypeError):
            return False
        if not np.all(digest[gi * q:(gi + 1) * q] == cap[slot]):
            return False
    return True


# ---------------------------------------------------------------------------
# SHA-256 simple Merkle (byte-level, reference-compatible)
# ---------------------------------------------------------------------------

def sha256_merkle_root_device(leaves: np.ndarray, device) -> bytes:
    """Batched `sha256_merkle_root` for power-of-two leaf counts: each tree
    level is one batched SHA-256 over all sibling pairs, and the digests
    stay on `device` between levels.  leaves: (n, 32) uint8."""
    n = leaves.shape[0]
    assert n & (n - 1) == 0 and n > 0
    words = np.ascontiguousarray(leaves, dtype=np.uint8).view(">u4")
    level = torch.from_numpy(words.astype(np.int64)).to(device)   # (n, 8)
    while level.shape[0] > 1:
        level = sha.hash_pairs_words(level)
    return sha.digest_words_to_bytes(level)[0].tobytes()


def sha256_merkle_root(leaves: list[bytes]) -> bytes:
    """Simple Merkle root over 32-byte leaves, bit-exact with the reference
    `RpcDataFetcher::get_merkle_root` (input/mod.rs:464-489): leaves are not
    hashed, zero-extended to the next power of two, interior nodes are
    SHA256(left || right).  Returns b"" for no leaves."""
    if not leaves:
        return b""
    nodes = list(leaves)
    while len(nodes) & (len(nodes) - 1):
        nodes.append(b"\x00" * 32)
    while len(nodes) > 1:
        nodes = [
            hashlib.sha256(nodes[2 * i] + nodes[2 * i + 1]).digest()
            for i in range(len(nodes) // 2)
        ]
    return nodes[0]

"""Poseidon Merkle trees over field-element digests (plonky2 `MerkleCap`
layout: stop `cap_height` levels below the root and publish all
2^cap_height nodes), hashed on the device of the leaves."""

from __future__ import annotations

import numpy as np
import torch

from . import goldilocks as gl
from . import poseidon

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

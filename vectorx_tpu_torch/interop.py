"""Carry state between the JAX package's representation and the port's.

The reference carries a field array, and a Blake2b 64-bit word, as a
(lo, hi) pair of uint32 numpy arrays; the port as one int64 tensor of u64
bit patterns.  A GF(2^255-19) element is 16 limbs of 16 bits in both, held
in uint32 by the reference and in int64 by the port.  Poseidon parameter
tables cross as numpy arrays of ints.  Proofs cross as JSON through the two
`stark.serialize` modules.  Nothing here imports JAX: the caller hands over
numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hash import poseidon


def limbs_to_tensor(lo, hi, device) -> torch.Tensor:
    """(lo, hi) uint32 arrays -> int64 tensor of lo + hi·2^32 on `device`
    (field elements, and Blake2b's 64-bit words)."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return gl.from_u64(lo | (hi << np.uint64(32)), device)


def tensor_to_limbs(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 tensor -> (lo, hi) uint32 numpy arrays of its raw u64 bit
    patterns (no canonicalization, like the reference's limbs)."""
    u = t.cpu().numpy().view(np.uint64)
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def ed25519_limbs_to_tensor(limbs, device) -> torch.Tensor:
    """The reference's GF(2^255-19) elements, (..., 16) uint32 arrays of
    16-bit limbs -> the port's (..., 16) int64 limbs on `device`."""
    return torch.from_numpy(
        np.asarray(limbs, dtype=np.uint32).astype(np.int64)).to(device)


def tensor_to_ed25519_limbs(t: torch.Tensor) -> np.ndarray:
    """The port's (..., 16) int64 limbs -> the reference's uint32 limbs."""
    return t.cpu().numpy().astype(np.uint32)


def poseidon_params_from_reference(rc, mds) -> None:
    """Install the reference's Poseidon table (360 round constants and the
    12x12 MDS, as numpy arrays or int lists) in the port."""
    poseidon.set_params(rc, mds)

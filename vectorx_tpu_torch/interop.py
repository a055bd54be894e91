"""Carry state between the JAX package's representation and the port's.

The reference carries a field array as a (lo, hi) pair of uint32 numpy
arrays; the port as one int64 tensor of u64 bit patterns.  Poseidon
parameter tables cross as numpy arrays of ints.  Proofs cross as JSON
through the two `stark.serialize` modules.  Nothing here imports JAX: the
caller hands over numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hash import poseidon


def limbs_to_tensor(lo, hi, device) -> torch.Tensor:
    """(lo, hi) uint32 arrays -> int64 tensor of lo + hi·2^32 on `device`."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    return gl.from_u64(lo | (hi << np.uint64(32)), device)


def tensor_to_limbs(t: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """int64 tensor -> (lo, hi) uint32 numpy arrays of its raw u64 bit
    patterns (no canonicalization, like the reference's limbs)."""
    u = t.cpu().numpy().view(np.uint64)
    return ((u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (u >> np.uint64(32)).astype(np.uint32))


def poseidon_params_from_reference(rc, mds) -> None:
    """Install the reference's Poseidon table (360 round constants and the
    12x12 MDS, as numpy arrays or int lists) in the port."""
    poseidon.set_params(rc, mds)

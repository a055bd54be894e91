"""Twin of `__graft_entry__.entry()`: one forward step of the flagship
compute — trace iNTT -> coset LDE -> batched Poseidon leaf hash -> Merkle
root — on the same shapes (W=8, log_n=8, rate_bits=3) and the same seeded
trace, so its root equals the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hash import poseidon
from vectorx_tpu_torch.ntt import coset_ntt, intt

W, LOG_N, RATE_BITS = 8, 8, 3


def forward(trace: torch.Tensor) -> torch.Tensor:
    """(W, n) trace on any device -> its (4,) Merkle root (non-canonical)."""
    n = trace.shape[-1]
    c = intt(trace)
    c = torch.nn.functional.pad(c, (0, n * ((1 << RATE_BITS) - 1)))
    leaves = coset_ntt(c).T                    # (8n, W) leaf rows
    d = poseidon.hash_no_pad(leaves)
    while d.shape[0] > 1:
        d = poseidon.two_to_one(d[0::2], d[1::2])
    return d[0]


def entry(device):
    """(forward, (trace,)) with the trace made from seed 0 on `device`."""
    rng = np.random.default_rng(0)
    trace = rng.integers(0, gl.P, size=(W, 1 << LOG_N), dtype=np.uint64)
    return forward, (gl.from_u64(trace, device),)


def root(device) -> list[int]:
    """The canonical Merkle root of `entry()` computed on `device`."""
    fn, args = entry(device)
    return [int(x) for x in gl.to_u64(fn(*args))]

"""Sharded prover step — the multi-rank "training step" of this framework.
Port of `vectorx_tpu.parallel.prover_step`.

Traces are data-parallel over the ranks: each rank LDEs and Merkle-hashes
its slab of traces, then the per-trace roots are all-gathered and a
checksum is summed over the ranks.
"""

from __future__ import annotations

import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hash import poseidon
from vectorx_tpu_torch.merkle import _rows_blocked
from vectorx_tpu_torch.ntt import coset_lde, intt
from vectorx_tpu_torch.parallel.mesh import Mesh


def local_roots(traces: torch.Tensor, rate_bits: int = 3) -> torch.Tensor:
    """(b, W, n) traces -> (b, 4) canonical Merkle roots: iNTT, coset LDE
    of the coefficients, a Poseidon hash of each LDE row's W values, then
    pairwise `two_to_one` down to one digest per trace."""
    b, w, n = traces.shape
    blow = 1 << rate_bits
    lde = coset_lde(intt(traces), rate_bits)
    rows = lde.transpose(1, 2).reshape(b * n * blow, w)
    d = _rows_blocked(poseidon.hash_no_pad, rows).reshape(b, n * blow, 4)
    while d.shape[1] > 1:
        d = poseidon.two_to_one(d[:, 0::2].reshape(-1, 4),
                                d[:, 1::2].reshape(-1, 4)).reshape(
                                    b, -1, 4)
    return gl.canonicalize(d[:, 0])


def make_sharded_prover_step(mesh: Mesh, rate_bits: int = 3):
    """Returns fn(traces) -> (roots, check): `traces` is this rank's
    (B/p, W, n) slab on `mesh.device`; `roots` the (B, 4) canonical roots of
    every rank's traces in rank order (one all_gather) and `check` the sum
    over all B·4 roots' low 32 bits mod 2^32 (one all_reduce), as the
    reference's uint32 psum of the lo limbs."""

    def step(traces: torch.Tensor):
        roots = local_roots(traces, rate_bits)
        everyone = mesh.all_gather(roots, dim=0)
        part = (roots & 0xFFFFFFFF).sum().reshape(1)
        check = int(mesh.all_reduce_sum(part)[0]) & 0xFFFFFFFF
        return everyone, check

    return step

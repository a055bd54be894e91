"""Analytical communication model for the distributed four-step NTT.
Port of `vectorx_tpu.parallel.comm_model`.

Model (`four_step_ntt`, N = R·C over p ranks):

- Each element is one Goldilocks value in an int64 tensor (ELEM_BYTES = 8;
  the reference holds the same 8 bytes as two uint32 limb planes).
- Stages 1/2/4 (column NTTs, twiddle scale, row NTTs) are rank-local.
- Stage 3 is ONE tiled all-to-all of the int64 tensor.  A rank holds N/p
  elements; a (p-1)/p fraction of them change ranks, so

    egress per rank = (N/p) · (p-1)/p · ELEM_BYTES
    total traffic   =  N    · (p-1)/p · ELEM_BYTES

- With a per-rank link bandwidth BW the transfer-time floor is
  egress_per_rank / BW.  BW is the caller's: the link is whatever the
  ranks exchange over (NVLink, or host memory under gloo), and the model
  takes no default.

Where the reference counts collectives in compiled HLO, the port counts
the calls its `Mesh` makes (`collective_counts`).
"""

from __future__ import annotations

from dataclasses import dataclass

ELEM_BYTES = 8  # one int64 per Goldilocks element


@dataclass(frozen=True)
class NttCommModel:
    n: int                    # transform size N = R * C
    p: int                    # ranks on the sharded axis
    egress_bytes_per_device: int
    total_bytes: int
    transfer_floor_s: float   # egress / BW — lower bound, perfect overlap
    local_elems_per_device: int

    @property
    def comm_fraction_vs_naive(self) -> float:
        """Fraction of a rank's slab that changes ranks: (p-1)/p."""
        return (self.p - 1) / self.p


def four_step_comm(n: int, p: int, link_gbps: float) -> NttCommModel:
    """Communication bound for one `four_step_ntt` of size `n` over `p`
    ranks whose links carry `link_gbps` GB/s each: exactly one all-to-all
    moves each off-diagonal element once."""
    assert n % p == 0
    local = n // p
    # p² | N for every four_step_ntt shape (N and p powers of two), so the
    # integer divisions are exact and total == egress · p
    assert local % p == 0, "four-step layout needs p² | N"
    egress = local * (p - 1) // p * ELEM_BYTES
    total = n * (p - 1) // p * ELEM_BYTES
    assert total == egress * p
    return NttCommModel(
        n=n, p=p,
        egress_bytes_per_device=egress,
        total_bytes=total,
        transfer_floor_s=egress / (link_gbps * 1e9),
        local_elems_per_device=local,
    )


def collective_counts(mesh) -> dict:
    """The collectives `mesh` has run since it was made (or since
    `mesh.reset_counts()`), by kind."""
    return dict(mesh.counts)

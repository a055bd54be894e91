"""Distributed four-step NTT: the polynomial's columns sharded over the ranks,
butterfly stages local, one all-to-all transpose.  Port of
`vectorx_tpu.parallel.ntt_sharded`.

For N = R·C with the C axis sharded over `p` ranks:

  1. column NTTs (size R) — local to each rank's column slab,
  2. twiddle scaling by w_N^{c·k1}, c global — local (N = 2^m, so the
     exponent c·k1 is taken mod N by a mask),
  3. transpose reshard — ONE `Mesh.all_to_all`, the only exchange,
  4. row NTTs (size C) — local to each rank's row slab.

Output: evaluations in "transposed digit order": X[k1 + R·k2] lives at
logical position [k1, k2] of the (R, C) result, k1-sharded.  The inverse
runs the same pipeline with inverse roots.  The local transforms are the
port's `ntt`/`intt`, i.e. the K1/K4 kernels on CUDA tensors; leading
batch dimensions ride along.

`coset_intt_blocks` is the sharded prover's quotient interpolation: its
input is a codeword as the prover holds it, rank r owning the points
[r·N/p, (r+1)·N/p) of the domain (the high digit of the point index
sharded, where the four-step wants the low one), so one all_to_all
first turns the row blocks of the (R, C) layout into its column slabs;
then `four_step_ntt` (a second all_to_all) and the coset's shift^-i,
applied on each rank's coefficients at their own indices.  Its output
stays in transposed digit order: rank r holds the coefficients
k1 + R·k2 for its k1, a stride-R comb of every chunk.  The prover's
quotient chunks are contiguous runs of coefficients, committed as whole
polynomials (`sharded_prove.ShardedDomain.quotient`), so a third
all_to_all deals the combs out to the ranks that commit each chunk.
"""

from __future__ import annotations

import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.ntt import cuda_ntt, intt, ntt
from vectorx_tpu_torch.ntt.ntt import (_root_of_unity, device_powers,
                                       power_table)
from vectorx_tpu_torch.parallel.mesh import Mesh

P_GL = gl.P


def _twiddle_table(log_n: int, inverse: bool):
    """Full (N,) table of w_N^i as canonical uint64 numpy."""
    w = _root_of_unity(log_n, inverse)
    return power_table(w, 1 << log_n)


def _twiddle(x: torch.Tensor, c0: int, log_n: int,
             inverse: bool) -> torch.Tensor:
    """x (..., cp, R) times w_N^{(c0 + c)·k1} at [c, k1], from the two-level
    power tables (w^e = lo[e mod 2^L]·hi[e >> L])."""
    cp, R = x.shape[-2:]
    dev = x.device
    tabs = cuda_ntt.pow_tables(_root_of_unity(log_n, inverse), log_n, dev)
    c = c0 + torch.arange(cp, dtype=torch.int64, device=dev)[:, None]
    k1 = torch.arange(R, dtype=torch.int64, device=dev)[None, :]
    return gl.mul(x, cuda_ntt._pow_at(tabs, (c * k1) & ((1 << log_n) - 1)))


def four_step_ntt(x: torch.Tensor, mesh: Mesh,
                  inverse: bool = False) -> torch.Tensor:
    """NTT of a size-N polynomial laid out as (R, C) row-major
    (a[r, c] = coeff r·C + c): `x` is this rank's (..., R, C/p) column
    slab (columns [rank·C/p, (rank+1)·C/p)), on `mesh.device`.

    Returns this rank's (..., R/p, C) row slab of the result in transposed
    digit order (rows [rank·R/p, (rank+1)·R/p))."""
    R, cp = x.shape[-2:]
    p = mesh.world
    C = cp * p
    log_n = cuda_ntt._log2(R * C)
    if R % p:
        raise ValueError(f"R={R} does not split over {p} ranks")
    tf = intt if inverse else ntt
    # 1. column NTTs: size R along the last axis of the transposed slab
    y = tf(x.transpose(-1, -2).contiguous())            # (C/p, R)
    # 2. twiddle by w_N^{c·k1}, c global
    y = _twiddle(y, mesh.rank * cp, log_n, inverse)
    # 3. transpose reshard: (C/p, R) -> (C, R/p), one all-to-all
    y = mesh.all_to_all(y, split_dim=-1, concat_dim=-2)
    # 4. row NTTs: size C
    return tf(y.transpose(-1, -2).contiguous())         # (R/p, C)


def coset_intt_blocks(x: torch.Tensor, mesh: Mesh, shift: int,
                      R: int) -> torch.Tensor:
    """Coset iNTT of evaluation vectors on shift·<w_N>, each held in row
    blocks: `x` is this rank's (..., N/p) block, the points
    [rank·N/p, (rank+1)·N/p), on `mesh.device`.  N = R·C.

    Returns this rank's (..., R/p, C) slab of the coefficients in
    transposed digit order: coefficient k1 + R·k2 (already times
    shift^-(k1 + R·k2)) at [k1 - rank·R/p, k2].  Two all_to_alls."""
    *lead, m = x.shape
    p = mesh.world
    N = m * p
    C = N // R
    if R * C != N or R % p or C % p:
        raise ValueError(f"a {R} x {C} layout of {N} points does not split "
                         f"over {p} ranks")
    # row blocks -> column slabs: point a·C + b, rows a split, then columns b
    y = mesh.all_to_all(x.reshape(*lead, R // p, C), split_dim=-1,
                        concat_dim=-2)
    y = four_step_ntt(y, mesh, inverse=True)            # (..., R/p, C)
    # shift^-(k1 + R·k2) = s^k1 · (s^R)^k2, this rank's k1 from rank·R/p
    s = pow(shift, P_GL - 2, P_GL)
    k0 = mesh.rank * (R // p)
    lo = gl.mul(device_powers(s, R // p, x.device), pow(s, k0, P_GL))
    hi = device_powers(pow(s, R, P_GL), C, x.device)
    return gl.mul(y, gl.mul(lo[:, None], hi[None, :]))


def four_step_ntt_reference(x: torch.Tensor, R: int, C: int,
                            inverse: bool = False) -> torch.Tensor:
    """Single-device version of the same digit-order transform, on the
    device of `x` (N = R·C coefficients, any shape)."""
    N = R * C
    log_n = cuda_ntt._log2(N)
    tf = intt if inverse else ntt
    y = tf(x.reshape(R, C).T.contiguous())               # (C, R)
    tw = gl.from_u64(_twiddle_table(log_n, inverse), x.device)
    c = torch.arange(C, dtype=torch.int64, device=x.device)[:, None]
    k1 = torch.arange(R, dtype=torch.int64, device=x.device)[None, :]
    y = gl.mul(y, tw[(c * k1) % N])
    return tf(y.T.contiguous())                          # (R, C)

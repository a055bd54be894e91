"""The yardstick of the benchmark's roofline shares: the card's published
peaks and the least work of each kernel family, counted from shapes alone.

Peaks (NVIDIA H100 SXM5 80GB HBM3, at its full 700 W power limit; the
card's limit is printed beside every result):

* device memory: 3.35 TB/s (NVIDIA H100 Tensor Core GPU data sheet);
* 32-bit integer multiply-add: 64 results per clock per multiprocessor
  (CUDA C++ Programming Guide, arithmetic instruction throughput, compute
  capability 9.0) x 132 multiprocessors x 1980 MHz (the SXM5 part's
  boost clock) = 1.6727e13 per second.

A Goldilocks product (64 x 64 -> 128 bits, then reduced) needs at least
its four 32 x 32 -> 64 partial products; each is counted as one 32-bit
multiply-add, the least an instruction can do (the reduction's adds and
shifts are not counted).  Every count is the least the algorithm needs,
whatever plan or implementation runs, so a share reads below 100 % unless
the counts are wrong.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_MADS_PER_S = 64 * 132 * 1980e6
MADS_PER_PRODUCT = 4

# Poseidon, width 12, x^7 S-box, 8 full and 22 partial rounds.  x^7 takes
# 4 products (x^2, x^3, x^6, x^7); a full round's dense MDS 144; a partial
# round one S-box and the sparse matrix of the partial-round decomposition
# (12 + 11 products); the decomposition leaves one dense matrix (144).
POSEIDON_WIDTH = 12
POSEIDON_PRODUCTS = (8 * (POSEIDON_WIDTH * 4 + POSEIDON_WIDTH ** 2)
                     + 22 * (4 + 2 * POSEIDON_WIDTH - 1)
                     + POSEIDON_WIDTH ** 2)
POSEIDON_BYTES = 2 * POSEIDON_WIDTH * 8     # each state read and written once


def least_seconds(products: int, nbytes: int) -> tuple[float, str]:
    """(the least time for `products` field products and `nbytes` bytes of
    device memory traffic, the bound that binds: "ops" or "bytes")."""
    ops = products * MADS_PER_PRODUCT / PEAK_INT32_MADS_PER_S
    mem = nbytes / PEAK_BYTES_PER_S
    return (ops, "ops") if ops >= mem else (mem, "bytes")


def poseidon_work(states: int) -> tuple[int, int]:
    """(products, bytes) of `states` Poseidon permutations."""
    return states * POSEIDON_PRODUCTS, states * POSEIDON_BYTES


def transform_work(rows: int, log_n: int) -> tuple[int, int]:
    """(products, bytes) of `rows` NTTs of length 2^log_n: (n/2)·log2(n)
    butterflies of one product each; each row read and written once."""
    n = 1 << log_n
    return rows * (n // 2) * log_n, rows * n * 16


def lde_work(rows: int, log_n: int, rate_bits: int) -> tuple[int, int]:
    """(products, bytes) of `rows` coset LDEs from 2^log_n coefficients to
    2^(log_n + rate_bits) points: 2^rate_bits transforms of length 2^log_n
    a row, the coefficients read once and the points written once."""
    n = 1 << log_n
    N = n << rate_bits
    return rows * (N // 2) * log_n, rows * (n + N) * 8

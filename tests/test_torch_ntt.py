"""The port's NTT (`vectorx_tpu_torch.ntt`) against the JAX package's, on CPU.

* The plain torch transforms (the CPU path) against the stage-by-stage
  `_transform_xla` at log_n 1..12 with leading dims, and against the Pallas
  kernel in interpret mode where it runs (as `tests/test_pallas_ntt.py`
  calls it).
* The CUDA kernels cannot run here, so their algorithm is held instead: a
  torch emulation with the kernels' split, stage order and tables
  (`cuda_ntt.emulate`), with the split shrunk to tiny S so the four-step
  path runs at small sizes, against the plain transform.
* The kernels themselves run only on the card: `chip_smoke.py` holds them
  against their plain versions there.

Tolerance: exact equality of canonical field values.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.ntt import pallas_ntt
from vectorx_tpu_torch.field import goldilocks as tgl
from vectorx_tpu_torch.ntt import (coset_intt, coset_ntt, cuda_ntt, intt, lde,
                                   ntt)

torch.set_num_threads(1)   # small tensors: more threads only contend with
                           # the other test workers

jntt = importlib.import_module("vectorx_tpu.ntt.ntt")
tntt = importlib.import_module("vectorx_tpu_torch.ntt.ntt")
P = jgl.P


def _vals(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    x.reshape(-1)[:3] = [P, 2**64 - 1, P - 1]     # non-canonical included
    return x


@pytest.mark.parametrize("log_n", range(1, 13))
def test_plain_transform_matches_xla(log_n):
    """ntt at every size; intt at every third (each XLA size compiles)."""
    x = _vals(log_n, (2, 3, 1 << log_n))
    t = tgl.from_u64(x, "cpu")
    jl, jh = jgl.from_u64(x)
    cases = [(False, ntt)] + ([(True, intt)] if log_n % 3 == 0 else [])
    for inverse, fn in cases:
        want = jgl.to_u64(*jntt._transform_xla(jl, jh, log_n, inverse))
        assert np.array_equal(tgl.to_u64(fn(t)), want)
    assert np.array_equal(tgl.to_u64(intt(ntt(t))), x % np.uint64(P))


def test_plain_transform_matches_pallas_interpret():
    log_n = 10
    x = _vals(20, (3, 1 << log_n))
    want = jgl.to_u64(*pallas_ntt.transform(*jgl.from_u64(x), log_n,
                                            True, True))
    got = cuda_ntt.transform_plain(tgl.from_u64(x, "cpu"), log_n, True)
    assert np.array_equal(tgl.to_u64(got), want)


def test_coset_and_lde_match_jax():
    log_n = 4
    x = _vals(30 + log_n, (2, 1 << log_n))
    t = tgl.from_u64(x, "cpu")
    jl, jh = jgl.from_u64(x)
    # one jit per reference function: eager JAX would compile every op
    want = jax.jit(lambda a, b: (jntt.coset_ntt(a, b),
                                 jntt.coset_intt(a, b, 49),
                                 jntt.lde(a, b, 3)))(jl, jh)
    assert np.array_equal(tgl.to_u64(coset_ntt(t)), jgl.to_u64(*want[0]))
    assert np.array_equal(tgl.to_u64(coset_intt(t, 49)), jgl.to_u64(*want[1]))
    assert np.array_equal(tgl.to_u64(lde(t, 3)), jgl.to_u64(*want[2]))


def test_power_table_matches_reference():
    for base, count in ((7, 1), (7, 37), (tntt._root_of_unity(9, True), 256)):
        want = np.array([pow(base, i, P) for i in range(count)],
                        dtype=np.uint64)
        assert np.array_equal(tntt.power_table(base, count), want)
        lo, hi = jntt.power_table(base, count)
        assert np.array_equal(want, lo.astype(np.uint64)
                              | (hi.astype(np.uint64) << np.uint64(32)))


@pytest.mark.parametrize("s_bits", [2, 3])
@pytest.mark.parametrize("log_n", [1, 3, 4, 5, 6])
def test_kernel_algorithm_emulation_matches_plain(log_n, s_bits):
    """K1 alone (log_n <= S) and the K1/K2 four-step (S < log_n <= 2S),
    forward, inverse and both coset variants, with leading dims."""
    x = tgl.from_u64(_vals(40 + log_n, (2, 3, 1 << log_n)), "cpu")
    for inverse in (False, True):
        for shift in (None, tgl.GENERATOR):
            got = cuda_ntt.emulate(x, log_n, inverse, shift, s_bits)
            want = cuda_ntt.transform_plain(x, log_n, inverse, shift)
            assert np.array_equal(tgl.to_u64(got), tgl.to_u64(want))


def test_kernel_algorithm_emulation_at_real_split():
    """The real S = 13 split shape (K1 only) and a four-step at S = 6
    for log_n = 12, the largest size here."""
    x = tgl.from_u64(_vals(50, (2, 1 << 12)), "cpu")
    want = tgl.to_u64(cuda_ntt.transform_plain(x, 12, False, 7))
    for s_bits in (cuda_ntt.S_BITS, 6):
        assert np.array_equal(
            tgl.to_u64(cuda_ntt.emulate(x, 12, False, 7, s_bits)), want)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = tgl.from_u64(_vals(60, (1, 8)), "cpu")
    with pytest.raises(ValueError):
        cuda_ntt.transform(x, 3, False)

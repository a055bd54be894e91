"""The port's NTT (`vectorx_tpu_torch.ntt`) against the JAX package's, on CPU.

* The plain torch transforms (the CPU path) against the stage-by-stage
  `_transform_xla` at log_n 1..12 with leading dims, and against the Pallas
  kernel in interpret mode where it runs (as `tests/test_pallas_ntt.py`
  calls it).
* The CUDA kernels cannot run here, so their algorithm is held instead: a
  torch emulation with the kernels' split, steps, stage order and tables
  (`cuda_ntt.emulate`: K1 alone, or the two-pass four-step K1 + K4), with
  the split shrunk to tiny S so the four-step path runs at small sizes,
  against the plain transform and the Pallas four-step in interpret mode;
  the zero-aware coset LDE (`cuda_ntt.emulate_lde`: K3 alone, or K3 + K4)
  against the reference's `lde`; and each K1/K4 step's plain version
  (strided and contiguous columns, coset powers on load, the four-step
  twiddle or a coset power and n^-1 on store, K4's transposed store)
  against the JAX transform of its columns.
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
from vectorx_tpu_torch.ntt import (coset_intt, coset_lde, coset_ntt, cuda_ntt,
                                   intt, lde, ntt)
from vectorx_tpu_torch.stark import stages

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


@pytest.mark.parametrize("inverse", [False, True])
def test_kernel_algorithm_emulation_matches_pallas_interpret(inverse):
    """The four-step at S = 5 (halves of 5 + 5 bits) against the Pallas
    four-step `transform_big`, interpret mode, at its smallest size."""
    log_n = 10
    x = _vals(70 + inverse, (2, 1 << log_n))
    want = jgl.to_u64(*pallas_ntt.transform_big(*jgl.from_u64(x), log_n,
                                                inverse, True))
    got = cuda_ntt.emulate(tgl.from_u64(x, "cpu"), log_n, inverse, None, 5)
    assert np.array_equal(tgl.to_u64(got), want)


def test_four_step_plan_is_three_passes():
    """The four-step is two passes since K4 stores in natural order (the
    name is the three-pass plan's, K1 + K1 + K2): K1 down the columns with
    the twiddle on its store, then K4 along the rows with the coset^-1
    power and n^-1 on its transposed store; no K2."""
    x = tgl.from_u64(_vals(80, (3, 1 << 6)), "cpu")
    steps = cuda_ntt.plan(x, 6, True, tgl.GENERATOR, 3)
    assert [st[0] for st in steps] == ["k1", "k4"]
    (_, b0, c0, a0, col0, _, pre0, post0, tw0, sc0), \
        (_, b1, c1, a1, _, post1, sc1) = steps
    assert (b0, c0, a0, col0, pre0, tw0, sc0) == (3, 8, 3, True, None, True, 1)
    assert (b1, c1, a1) == (3, 8, 3)
    assert post0 is not None and post1 is not None
    assert sc1 == pow(1 << 6, P - 2, P)


def test_lde_plan_reads_coefficients_only():
    """The coset LDE: one K3 step on whole rows up to 2^S points, past it
    K3 as the column step (coset on load, twiddle on store) and K4."""
    x = tgl.from_u64(_vals(81, (3, 1 << 3)), "cpu")
    (single,) = cuda_ntt.plan_lde(x, 2, tgl.GENERATOR, 5)
    assert single[:5] == ("k3", 3, 1, 5, False) and single[-1] == 2
    assert single[6] is not None and single[7] is None
    k3, k4 = cuda_ntt.plan_lde(x, 3, tgl.GENERATOR, 5)
    assert k3[:5] == ("k3", 3, 8, 3, True) and k3[8:] == (True, 3)
    assert k4[:4] == ("k4", 3, 8, 3) and k4[5:] == (None, 1)


def _powers(base, e):
    return np.vectorize(lambda k: pow(base, int(k), P), otypes=[object])(e)


# (batch, C, log_n, col, inverse, pre, post, twiddle, scale): the four-step's
# first step (strided columns, coset on load, twiddle on store, C below a
# tile's 8 columns), its second step (rows, coset^-1 and n^-1 on store), a
# single K1 on rows with the coset, and plain strided inverse columns
K1_STEPS = [
    (2, 4, 3, True, False, 7, "twiddle", True, 1),
    (2, 4, 3, False, True, None, "coset", False, "n^-1"),
    (3, 1, 4, False, False, 7, None, False, 1),
    (1, 2, 4, True, True, None, None, False, 1),
    # K4: the two-pass four-step's row step, stored transposed
    (2, 4, 3, "transposed", True, None, "coset", False, "n^-1"),
]


@pytest.mark.parametrize("batch,C,log_n,col,inverse,pre,post,twiddle,scale",
                         K1_STEPS)
def test_k1_step_plain_matches_jax(batch, C, log_n, col, inverse, pre, post,
                                   twiddle, scale):
    """`ntt_tile_plain` (the K1 step the kernel is held against on the
    card) against the JAX transform of its columns with the powers on
    load and store computed in Python integers."""
    n = 1 << log_n
    lg = (C * n).bit_length() - 1             # exponents stay below C·n
    x = _vals(90 + log_n + C, (batch, C * n))
    tw = tntt.twiddles(log_n, inverse, "cpu")
    base = {"twiddle": tntt._root_of_unity(lg, inverse),
            "coset": pow(tgl.GENERATOR, P - 2, P), None: None}[post]
    scale = pow(n, P - 2, P) if scale == "n^-1" else scale
    tables = [None if b is None else cuda_ntt.pow_tables(b, lg, "cpu")
              for b in (pre, base)]
    src = tgl.from_u64(x, "cpu")
    if col == "transposed":
        got = cuda_ntt.ntt_tile_t_plain(src, batch, C, log_n, tw, tables[1],
                                        scale)
        got = tgl.to_u64(got).reshape(batch, n, C).transpose(0, 2, 1)
        col = False
    else:
        got = tgl.to_u64(cuda_ntt.ntt_tile_plain(
            src, batch, C, log_n, col, tw, tables[0], tables[1], twiddle,
            scale))
    got = got.reshape(batch, -1)

    cols = (x.reshape(batch, n, C).transpose(0, 2, 1) if col
            else x.reshape(batch, C, n)).astype(object) % P
    c = np.arange(C)[:, None]
    i = np.arange(n)[None, :]
    if pre is not None:
        cols = cols * _powers(pre, c + C * i) % P
    jl, jh = jgl.from_u64(cols.astype(np.uint64))
    cols = jgl.to_u64(*jntt._transform_xla(jl, jh, log_n, inverse)).astype(
        object)
    if inverse:   # the step's stages leave n^-1 out: its `scale` applies it
        cols = cols * n % P
    if base is not None:
        cols = cols * _powers(base, c * i if twiddle else c + C * i) % P
    cols = cols * scale % P
    want = (cols.transpose(0, 2, 1) if col else cols).reshape(batch, -1)
    assert np.array_equal(got, want.astype(np.uint64))


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
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_ntt.transform(x, 3, False)
    tw = tntt.twiddles(3, False, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_ntt.ntt_tile(x, 1, 1, 3, False, tw, None, None, False, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_ntt.transpose(x, 1, 2, 4)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_ntt.ntt_tile_t(x, 1, 2, 2, tw, None, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_ntt.ntt_tile_lde(x, 1, 1, 4, False, tw, None, None, False, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cuda_ntt.coset_lde(x, 3)


def _refused(case):
    x = torch.zeros(32, dtype=torch.int64)
    if case == "dtype":
        cuda_ntt.transform(x.to(torch.int32), 5, False)
    elif case == "last dim":
        cuda_ntt.transform(x, 4, False)
    elif case == "log_n":
        cuda_ntt.transform(x, 27, False)
    elif case == "strided":
        cuda_ntt.transform(x.reshape(2, 16).t(), 1, False)
    elif case == "K1 length":
        cuda_ntt.ntt_tile(x, 1, 2, 14, False, x, None, None, False, 1)
    elif case == "K1 size":
        cuda_ntt.ntt_tile(x, 3, 2, 3, True, x, None, None, False, 1)
    elif case == "K2 size":
        cuda_ntt.transpose(x, 1, 4, 4)
    elif case == "K2 length":
        cuda_ntt.transpose(x, 1, 1 << 14, 1)
    elif case == "K4 length":
        cuda_ntt.ntt_tile_t(x, 1, 1, 14, x, None, 1)
    elif case == "K4 size":
        cuda_ntt.ntt_tile_t(x, 2, 4, 3, x, None, 1)
    elif case == "K3 length":
        cuda_ntt.ntt_tile_lde(x, 1, 1, 14, False, x, None, None, False, 9)
    elif case == "K3 size":
        cuda_ntt.ntt_tile_lde(x, 1, 1, 8, False, x, None, None, False, 2)
    elif case == "K3 rows":
        cuda_ntt.ntt_tile_lde(x, 1, 2, 7, False, x, None, None, False, 2)
    elif case == "K3 rate":
        cuda_ntt.ntt_tile_lde(x, 1, 1, 5, False, x, None, None, False, 6)
    else:
        cuda_ntt.coset_lde(x, 22)


@pytest.mark.parametrize("case", ["dtype", "last dim", "log_n", "strided",
                                  "K1 length", "K1 size", "K2 size",
                                  "K2 length", "K4 length", "K4 size",
                                  "K3 length", "K3 size", "K3 rows",
                                  "K3 rate", "lde rate"])
def test_kernel_wrappers_refuse_shapes(case):
    """Every shape the kernels do not take raises before a launch (and
    before the device check); there is no fallback to the plain path."""
    with pytest.raises((ValueError, TypeError)) as info:
        _refused(case)
    assert "CUDA tensors only" not in str(info.value)


# (log_n, rate_bits): with s_bits 2 the four-step's columns hold whole
# coefficient rows (n >= C: log_n 5) or fewer than one (n < C: log_n 0,
# and 2 at rate 3), and every s_bits takes the single-pass K3 somewhere
@pytest.mark.parametrize("rate_bits", [1, 2, 3])
@pytest.mark.parametrize("log_n", [0, 2, 5])
def test_lde_emulation_matches_jax(log_n, rate_bits):
    """`emulate_lde` (K3 alone, or K3 + K4, on the unpadded coefficients)
    at s_bits 2, 3 and 5 against the reference's `lde` of the same
    non-canonical evaluations."""
    x = _vals(100 + 4 * log_n + rate_bits, (3, 1 << log_n))
    want = jgl.to_u64(*jax.jit(lambda a, b: jntt.lde(a, b, rate_bits))(
        *jgl.from_u64(x)))
    c = intt(tgl.from_u64(x, "cpu"))
    for s_bits in (2, 3, 5):
        got = cuda_ntt.emulate_lde(c, rate_bits, tgl.GENERATOR, s_bits)
        assert np.array_equal(tgl.to_u64(got), want), s_bits


def test_two_pass_emulation_matches_pallas_interpret():
    """The two-pass four-step at an uneven split (2^5 x 2^6 at S = 6) with
    leading dims against the Pallas `transform_big`, interpret mode."""
    log_n = 11
    x = _vals(75, (2, 2, 1 << log_n))
    want = jgl.to_u64(*pallas_ntt.transform_big(*jgl.from_u64(x), log_n,
                                                False, True))
    got = cuda_ntt.emulate(tgl.from_u64(x, "cpu"), log_n, False, None, 6)
    assert np.array_equal(tgl.to_u64(got), want)


def test_coset_lde_rows_and_lde_are_the_padded_transform(monkeypatch):
    """On the CPU `coset_lde`, `ntt.lde` and `stages.coset_lde_rows` (in
    row blocks) give `coset_ntt` of the zero-padded coefficients."""
    x = tgl.from_u64(_vals(110, (5, 1 << 6)), "cpu")
    c = intt(x)
    monkeypatch.setattr(stages, "LDE_CHUNK_ELEMS", 2 << 9)   # 2-row blocks
    for rate_bits in (1, 2, 3):
        N = 1 << (6 + rate_bits)
        want = tgl.to_u64(coset_ntt(torch.nn.functional.pad(c, (0, N - 64))))
        assert np.array_equal(tgl.to_u64(coset_lde(c, rate_bits)), want)
        assert np.array_equal(tgl.to_u64(lde(x, rate_bits)), want)
        assert np.array_equal(
            tgl.to_u64(stages.coset_lde_rows(c, N)), want)

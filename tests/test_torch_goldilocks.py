"""The port's Goldilocks field (`vectorx_tpu_torch.field`) against the JAX
package's, on CPU torch.

Inputs come from a seeded numpy generator plus the edge values; both sides
get the same u64 values and must agree exactly on canonical outputs (the
arithmetic is integer, so the tolerance is equality).
"""

import numpy as np
import pytest
import torch

from vectorx_tpu.field import extension as jext
from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu_torch import interop
from vectorx_tpu_torch.field import extension as text
from vectorx_tpu_torch.field import goldilocks as tgl
from vectorx_tpu_torch.field import reference

torch.set_num_threads(1)   # small tensors: more threads only contend with
                           # the other test workers

P = jgl.P
EDGE = [0, 1, P - 1, P, 2**32 - 1, 2**32, 2**64 - 2**32, 2**64 - 1]


def _operands(seed: int):
    """Every pair of edge values, then random (mostly non-canonical) ones."""
    rng = np.random.default_rng(seed)
    ea, eb = np.meshgrid(np.array(EDGE, dtype=np.uint64),
                         np.array(EDGE, dtype=np.uint64))
    ra = rng.integers(0, 2**64, size=256, dtype=np.uint64)
    rb = rng.integers(0, 2**64, size=256, dtype=np.uint64)
    return (np.concatenate([ea.ravel(), ra]), np.concatenate([eb.ravel(), rb]))


def _t(x):
    return tgl.from_u64(x, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_jax(op):
    a, b = _operands(1)
    got = tgl.to_u64(getattr(tgl, op)(_t(a), _t(b)))
    want = jgl.to_u64(*getattr(jgl, op)(*jgl.from_u64(a), *jgl.from_u64(b)))
    assert np.array_equal(got, want)
    oracle = getattr(reference, op)
    assert [int(x) for x in got[:16]] == [oracle(int(x), int(y))
                                          for x, y in zip(a[:16], b[:16])]


@pytest.mark.parametrize("op", ["sqr", "neg", "canonicalize", "inv"])
def test_unary_ops_match_jax(op):
    a, _ = _operands(2)
    got = tgl.to_u64(getattr(tgl, op)(_t(a)))
    want = jgl.to_u64(*getattr(jgl, op)(*jgl.from_u64(a)))
    assert np.array_equal(got, want)


def test_eq_mul_small_pow_const_match_jax():
    a, b = _operands(3)
    a[:8] = b[:8] + np.uint64(P) * (b[:8] < np.uint64(2**32 - 1))
    assert np.array_equal(tgl.eq(_t(a), _t(b)).numpy(),
                          np.asarray(jgl.eq(*jgl.from_u64(a),
                                            *jgl.from_u64(b))))
    for k in (0, 1, 7, 2**32 - 1):
        assert np.array_equal(
            tgl.to_u64(tgl.mul_small(_t(a), k)),
            jgl.to_u64(*jgl.mul_small(*jgl.from_u64(a), k)))
    for e in (0, 1, 7, 2**64 - 2**32):
        assert np.array_equal(
            tgl.to_u64(tgl.pow_const(_t(a), e)),
            jgl.to_u64(*jgl.pow_const(*jgl.from_u64(a), e)))


def test_field_sum_and_cumsum_equal_chained_adds():
    a, _ = _operands(4)
    rows = a[:64 * 4].reshape(4, 64)
    want = [sum(int(x) for x in r) % P for r in rows]
    assert [int(x) for x in tgl.to_u64(tgl.field_sum(_t(rows), 1))] == want
    cum = tgl.to_u64(tgl.field_cumsum(_t(rows), 1))
    assert [int(x) for x in cum[:, -1]] == want
    assert int(cum[2, 9]) == sum(int(x) for x in rows[2, :10]) % P


def test_extension_ops_match_jax():
    a, b = _operands(5)
    c, d = _operands(6)
    ta, tb = (_t(a), _t(c)), (_t(b), _t(d))
    ja = jext.from_pair_u64(a, c)
    jb = jext.from_pair_u64(b, d)
    for op in ("add", "sub", "mul"):
        got = text.to_pair_u64(getattr(text, op)(ta, tb))
        want = jext.to_pair_u64(getattr(jext, op)(ja, jb))
        assert all(np.array_equal(g, w) for g, w in zip(got, want)), op
    got = text.to_pair_u64(text.inv(ta))
    want = jext.to_pair_u64(jext.inv(ja))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    got = text.to_pair_u64(text.mul_base(ta, tb[0]))
    want = jext.to_pair_u64(jext.mul_base(ja, *jgl.from_u64(b)))
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_from_u64_to_u64_and_interop_round_trip():
    a, _ = _operands(7)
    x = a.reshape(8, -1)
    t = tgl.from_u64(x, "cpu")
    assert np.array_equal(t.numpy().view(np.uint64), x)        # raw bits
    assert np.array_equal(tgl.to_u64(t), x % np.uint64(P))     # canonical
    lo, hi = jgl.from_u64(x)
    t2 = interop.limbs_to_tensor(np.asarray(lo), np.asarray(hi), "cpu")
    assert np.array_equal(t2.numpy(), t.numpy())
    lo2, hi2 = interop.tensor_to_limbs(t2)
    assert np.array_equal(lo2, np.asarray(lo))
    assert np.array_equal(hi2, np.asarray(hi))

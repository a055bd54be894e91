"""The port's batched ed25519 on CPU torch.

* GF(2^255-19) mul/add/sub/canonical, `point_add` and a short
  `scalar_mult_batched` ladder equal the JAX package's functions limb for
  limb (16-bit limbs carried across by `interop`; exact integer equality).
* `batch_verify` agrees with the host RFC 8032 verifier on valid, forged,
  masked and malformed signatures.  The reference's `batch_verify` is not
  called: its ladder compile on XLA:CPU is paid by
  `tests/test_ed25519_batch.py`.
"""

import random

import numpy as np
import pytest
import torch

from vectorx_tpu.curves import ed25519_batch as jed
from vectorx_tpu_torch import interop
from vectorx_tpu_torch.curves import ed25519 as host
from vectorx_tpu_torch.curves import ed25519_batch as ted

torch.set_num_threads(1)

Q = host.Q
RNG = random.Random(8)
EDGES = [0, 1, 2, 19, 38, Q - 2, Q - 1, Q, Q + 1, 2 * Q - 1, 2 * Q,
         (1 << 255) - 1, 1 << 255, (1 << 256) - 39, (1 << 256) - 38,
         (1 << 256) - 1]


def _pair():
    xs = EDGES + [RNG.getrandbits(256) for _ in range(24)]
    ys = list(reversed(EDGES)) + [RNG.getrandbits(256) for _ in range(24)]
    return xs, ys


def _same(jx, tx):
    assert np.array_equal(np.asarray(jx), interop.tensor_to_ed25519_limbs(tx))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_ops_match_reference_limbs(op):
    xs, ys = _pair()
    ja, jb = jed.from_ints(xs), jed.from_ints(ys)
    ta = interop.ed25519_limbs_to_tensor(np.asarray(ja), "cpu")
    tb = interop.ed25519_limbs_to_tensor(np.asarray(jb), "cpu")
    jr = getattr(jed, op)(ja, jb)
    tr = getattr(ted, op)(ta, tb)
    _same(jr, tr)
    _same(jed.canonical(jr), ted.canonical(tr))
    want = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
            "sub": lambda x, y: x - y}[op]
    assert ted.to_ints(ted.canonical(tr)) == [want(x, y) % Q
                                              for x, y in zip(xs, ys)]


def _points(scalars):
    return [host.scalar_mult(k, host.B_POINT) for k in scalars]


def _limbs(points, c):
    return [p[c] % Q for p in points]


def test_point_add_matches_reference_limbs():
    p = _points([12345, 7, 2**200 + 3])
    q = _points([99999, 7, 5])
    jp = tuple(jed.from_ints(_limbs(p, c)) for c in range(4))
    jq = tuple(jed.from_ints(_limbs(q, c)) for c in range(4))
    tp = tuple(ted.from_ints(_limbs(p, c), device="cpu") for c in range(4))
    tq = tuple(ted.from_ints(_limbs(q, c), device="cpu") for c in range(4))
    for jc, tc in zip(jed.point_add(jp, jq), ted.point_add(tp, tq)):
        _same(jc, tc)


def test_scalar_mult_ladder_matches_host():
    """The ladder is `point_add` (held limb for limb above) and
    `point_select`; its result is held against the host's scalar
    multiplication.  The reference's own ladder is in its slow tier (a
    ~30 s scan compile on XLA:CPU), so it is not run here."""
    scalars = [1, 5, 0xABC, 0xFFF, host.L - 1]
    pts = _points([3, 11, 17, 23, 29])
    bits = np.array([ted._bits_msb(s) for s in scalars], dtype=np.int64)
    tp = tuple(ted.from_ints(_limbs(pts, c), device="cpu") for c in range(4))
    tr = ted.scalar_mult_batched(torch.from_numpy(bits), tp)
    for j, (s, p) in enumerate(zip(scalars, pts)):
        ex, ey, ez, _ = host.scalar_mult(s, p)
        ox, oy, oz = (ted.to_ints(ted.canonical(tr[c][j]))[0]
                      for c in range(3))
        assert (ox * ez - ex * oz) % Q == 0
        assert (oy * ez - ey * oz) % Q == 0


def _signatures(n, msg=b"vectorx batch"):
    sks = [bytes([i + 1]) * 32 for i in range(n)]
    pks = [host.public_key(sk) for sk in sks]
    return sks, pks, [msg] * n, [host.sign(sk, msg) for sk in sks]


def _verify(pks, msgs, sigs, mask=None):
    got = ted.batch_verify(pks, msgs, sigs, mask, rng=random.Random(3),
                           device="cpu")
    want = all(host.verify(pk, m, s) for pk, m, s, on in
               zip(pks, msgs, sigs, mask or [True] * len(pks)) if on)
    assert got == want
    return got


def test_batch_verify_valid_and_forged():
    sks, pks, msgs, sigs = _signatures(4)
    assert _verify(pks, msgs, sigs)
    forged = list(sigs)
    forged[2] = host.sign(sks[1], msgs[2])    # right message, wrong key
    assert not _verify(pks, msgs, forged)


def test_batch_verify_mask_and_malformed():
    _, pks, msgs, sigs = _signatures(4)
    garbage = list(sigs)
    garbage[1] = b"\x00" * 64
    mask = [True, False, True, True]
    assert _verify(pks, msgs, garbage, mask)          # masked out: accepted
    assert ted.batch_verify(pks, msgs, garbage, [False] * 4,
                            rng=random.Random(0), device="cpu")
    # s >= L is rejected before any curve arithmetic
    big_s = sigs[0][:32] + (host.L).to_bytes(32, "little")
    assert not ted.batch_verify(pks, msgs, [big_s] + sigs[1:],
                                rng=random.Random(0), device="cpu")


def _ripple(cols):
    """A sequential ripple carry of non-negative columns into 16-bit
    digits plus the final carry limb."""
    out, carry = [], 0
    for c in cols:
        carry += c
        out.append(carry & 0xFFFF)
        carry >>= 16
    return out + [carry]


@pytest.mark.parametrize("bits", [17, 18, 36, 48])
def test_carry16_equals_a_sequential_ripple(bits):
    """Random columns below 2^bits, and runs of 0xFFFF that a carry
    crosses whole (the running max's case)."""
    rng = np.random.default_rng(bits)
    cols = rng.integers(0, 1 << bits, size=(64, 31), dtype=np.int64)
    cols[:16, 1:30] = 0xFFFF
    cols[:8, 0] = (1 << bits) - 1
    cols[16:24] = (1 << bits) - 1
    t = torch.from_numpy(cols.copy())
    got = ted._carry16(t, bits)
    assert np.array_equal(t.numpy(), cols)        # the input is not changed
    assert got.tolist() == [_ripple(row) for row in cols.tolist()]

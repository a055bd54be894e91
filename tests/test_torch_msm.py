"""The port's Pippenger `msm` and `batch_verify(method="msm")` on CPU
torch.

* The window digits equal the reference's `_digits_host`, and the bucket
  keys equal the keys the reference's `msm` hands its bucket kernel.
* The segmented bucket sums equal direct per-bucket sums.
* `msm` equals a host Σ[s_i]P_i at windows 4 and 8, with the zero scalar
  of `tests/test_ed25519_batch.py::test_msm_matches_host_oracle`.
* `batch_verify(method="msm")` accepts and rejects as the ladder does, on
  `tests/test_ed25519_batch.py`'s signatures at `MSM_WINDOW` = 4.

The reference's MSM itself is not run: its XLA:CPU compile is slow-gated
in `tests/test_ed25519_batch.py`.
"""

import random

import numpy as np
import pytest
import torch

from test_ed25519_batch import _make_sigs
from vectorx_tpu.curves import ed25519_batch as jed
from vectorx_tpu_torch.curves import ed25519 as host
from vectorx_tpu_torch.curves import ed25519_batch as ted

torch.set_num_threads(1)

Q = host.Q


def _oracle_case():
    """`test_msm_matches_host_oracle`'s scalars and points."""
    rng = np.random.default_rng(5)
    n = 5
    scalars = [int.from_bytes(rng.bytes(32), "little") % host.L
               for _ in range(n)]
    scalars[0] = 0                      # weight-0 digits everywhere
    pts = [host.scalar_mult(int(rng.integers(1, 1 << 30)), host.B_POINT)
           for _ in range(n)]
    return scalars, pts


def _dev(pts):
    return tuple(ted.from_ints([p[c] for p in pts], device="cpu")
                 for c in range(4))


def _affine(p):
    """One device point (4×(16,) or 4×(1, 16) limbs) as compressed bytes."""
    x, y, z, _ = [ted.to_ints(a.reshape(1, -1))[0] for a in p]
    zi = pow(z, Q - 2, Q)
    gx, gy = x * zi % Q, y * zi % Q
    return host.point_compress((gx, gy, 1, gx * gy % Q))


@pytest.mark.parametrize("w", [4, 8])
def test_digits_and_keys_match_reference(w, monkeypatch):
    scalars, pts = _oracle_case()
    scalars = scalars + [host.L - 1, 1, (1 << 253) - 1]
    pts = pts + pts[:3]
    k = (253 + w - 1) // w
    digits = ted._digits_host(scalars, w, k)
    assert np.array_equal(digits, jed._digits_host(scalars, w, k))
    seen = {}

    def capture(keys, flat, w_, k_, nb_):
        seen.update(keys=np.asarray(keys), shape=(w_, k_, nb_))
        return None

    monkeypatch.setattr(jed, "_msm_kernel", capture)
    jed.msm(scalars, tuple(jed.from_ints([p[c] for p in pts])
                           for c in range(4)), w=w)
    assert seen["shape"] == (w, k, 1 << w)
    assert np.array_equal(ted._bucket_keys(digits, k, 1 << w),
                          seen["keys"].astype(np.int64))


def test_segmented_bucket_sums_match_direct_sums():
    rng = random.Random(3)
    n_buckets = 6
    keys = [rng.randrange(n_buckets + 1) for _ in range(23)]  # 6 = trash
    pts = [host.scalar_mult(rng.randrange(1, 1 << 20), host.B_POINT)
           for _ in keys]
    got = ted._segmented_bucket_sums(torch.tensor(keys), _dev(pts),
                                     n_buckets)
    for b in range(n_buckets):
        want = host.IDENTITY
        for key, p in zip(keys, pts):
            if key == b:
                want = host.point_add(want, p)
        assert _affine(tuple(a[b] for a in got)) == host.point_compress(want)


@pytest.mark.parametrize("w", [4, 8])
def test_msm_matches_host_oracle(w):
    scalars, pts = _oracle_case()
    acc = host.IDENTITY
    for s, p in zip(scalars, pts):
        acc = host.point_add(acc, host.scalar_mult(s, p))
    assert _affine(ted.msm(scalars, _dev(pts), w=w)) == \
        host.point_compress(acc)


@pytest.mark.parametrize("case", ["honest", "s_out_of_range", "forged",
                                  "forged_unsigned"])
def test_batch_verify_msm_agrees_with_ladder(case, monkeypatch):
    monkeypatch.setattr(ted, "MSM_WINDOW", 4)
    pks, msgs, sigs = _make_sigs(4)
    mask, want = None, case in ("honest", "forged_unsigned")
    if case == "s_out_of_range":        # the host check rejects
        sigs[1] = sigs[1][:32] + bytes(31) + b"\x01"
    elif case != "honest":              # the curve sum rejects
        sigs[2] = host.sign(bytes([3]) * 32, b"another message")
        if case == "forged_unsigned":
            mask = [True, True, False, True]
    got = [ted.batch_verify(pks, msgs, sigs, mask, rng=random.Random(7),
                            device="cpu", method=method)
           for method in ("msm", "ladder")]
    assert got == [want, want]

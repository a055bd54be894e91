"""Scalar Python-int Poseidon — same parameters as `poseidon.py`.

Used for the host-side Fiat-Shamir transcript (tiny sequential state, where
Python bigints beat tensor dispatches) and as the oracle for the batched
torch permutation.  Port of `vectorx_tpu.hash.poseidon_py`.
"""

from __future__ import annotations

from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.hash import poseidon as pv


def permute(state: list[int]) -> list[int]:
    assert len(state) == pv.WIDTH
    rc, mds = pv.int_params()
    s = [x % P for x in state]
    r = 0

    def mds_layer(s):
        return [sum(mds[i][j] * s[j] for j in range(pv.WIDTH)) % P
                for i in range(pv.WIDTH)]

    for _ in range(pv.FULL_ROUNDS // 2):
        s = [(x + rc[r * pv.WIDTH + i]) % P for i, x in enumerate(s)]
        s = [pow(x, pv.ALPHA, P) for x in s]
        s = mds_layer(s)
        r += 1
    for _ in range(pv.PARTIAL_ROUNDS):
        s = [(x + rc[r * pv.WIDTH + i]) % P for i, x in enumerate(s)]
        s[0] = pow(s[0], pv.ALPHA, P)
        s = mds_layer(s)
        r += 1
    for _ in range(pv.FULL_ROUNDS // 2):
        s = [(x + rc[r * pv.WIDTH + i]) % P for i, x in enumerate(s)]
        s = [pow(x, pv.ALPHA, P) for x in s]
        s = mds_layer(s)
        r += 1
    return s


def hash_no_pad(inputs: list[int]) -> list[int]:
    state = [0] * pv.WIDTH
    for start in range(0, len(inputs), pv.RATE):
        chunk = inputs[start:start + pv.RATE]
        state[: len(chunk)] = [x % P for x in chunk]
        state = permute(state)
    return state[: pv.DIGEST]


def two_to_one(left: list[int], right: list[int]) -> list[int]:
    state = list(left) + list(right) + [0] * (pv.WIDTH - 2 * pv.DIGEST)
    return permute(state)[: pv.DIGEST]

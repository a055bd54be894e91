"""The port's Poseidon and Merkle trees against the JAX package, on CPU.

Vectorized parity is checked against the JAX permutation; wider coverage
(sponge remainders, tree caps, swapped parameter tables) against the JAX
package's scalar `poseidon_py`, which needs no compile.  The `entry()` twin
must give the JAX `entry()` root.  Tolerance: exact equality of canonical
field values.
"""

import numpy as np
import pytest
import torch

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.hash import poseidon as jpv
from vectorx_tpu.hash import poseidon_py as jpy
from vectorx_tpu_torch import entry, interop, merkle
from vectorx_tpu_torch.field import goldilocks as tgl
from vectorx_tpu_torch.hash import poseidon as tpv

torch.set_num_threads(1)   # small tensors: more threads only contend with
                           # the other test workers

P = jgl.P


def _states(seed, rows, width=12):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**64, size=(rows, width), dtype=np.uint64)
    edge = np.array([P, 2**64 - 1, 0, P - 1], dtype=np.uint64)
    x[0, :min(4, width)] = edge[:width]         # non-canonical lanes
    return x


def _ints(rows):
    return [[int(v) for v in r] for r in rows]


def test_generated_parameters_match_jax():
    assert tpv._generated_round_constants() == jpv._generated_round_constants()
    assert tpv._generated_mds() == jpv._generated_mds()
    assert tpv._fast_partial_params()[3] == [
        [int(v) for v in lo | (hi.astype(np.uint64) << np.uint64(32))]
        for lo, hi in zip(*[a.astype(np.uint64)
                            for a in jpv._fast_partial_params()[3]])]


def test_permute_matches_jax():
    x = _states(1, 16)
    got = tgl.to_u64(tpv.permute(tgl.from_u64(x, "cpu")))
    want = jgl.to_u64(*jpv.permute(*jgl.from_u64(x)))
    assert np.array_equal(got, want)
    assert _ints(got[:3]) == [jpy.permute([int(v) for v in r]) for r in x[:3]]


@pytest.mark.parametrize("k", [3, 8, 13, 27])
def test_hash_no_pad_matches_scalar(k):
    x = _states(2 + k, 6, width=k)
    got = tgl.to_u64(tpv.hash_no_pad(tgl.from_u64(x, "cpu")))
    assert _ints(got) == [jpy.hash_no_pad([int(v) for v in r]) for r in x]


def test_two_to_one_matches_jax():
    left, right = _states(3, 8, 4), _states(4, 8, 4)
    got = tgl.to_u64(tpv.two_to_one(tgl.from_u64(left, "cpu"),
                                    tgl.from_u64(right, "cpu")))
    want = jgl.to_u64(*jpv.two_to_one(jgl.from_u64(left),
                                      jgl.from_u64(right)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("leaf_len,cap_height", [(2, 0), (6, 1), (12, 2)])
def test_build_layers_cap_matches_scalar_tree(leaf_len, cap_height,
                                              monkeypatch):
    monkeypatch.setattr(merkle, "POSEIDON_CHUNK_ROWS", 4)   # chunked path
    leaves = _states(5 + leaf_len, 16, leaf_len) % np.uint64(P)
    layers = merkle.build_layers(tgl.from_u64(leaves, "cpu"), cap_height)
    tree = merkle.DeviceTree(layers, cap_height)
    level = [list(map(int, r)) + [0] * (4 - leaf_len) if leaf_len <= 4
             else jpy.hash_no_pad(list(map(int, r))) for r in leaves]
    while len(level) > 1 << cap_height:
        level = [jpy.two_to_one(level[i], level[i + 1])
                 for i in range(0, len(level), 2)]
    assert tree.cap_ints() == level
    # openings verify with the port's scalar and batched walks
    idx = [0, 5, 11, 15]
    paths = [[_ints(tgl.to_u64(layer[(i >> lvl) ^ 1][None]))[0]
              for lvl, layer in enumerate(layers[:-1])] for i in idx]
    lv = [list(map(int, leaves[i])) for i in idx]
    assert all(merkle.verify_path(lv[q], idx[q], paths[q], level, 16)
               for q in range(len(idx)))
    assert merkle.verify_paths(lv, idx, paths, level, 16)
    lv[1][0] = (lv[1][0] + 1) % P
    assert not merkle.verify_paths(lv, idx, paths, level, 16)


def test_params_from_reference_with_perturbed_table(monkeypatch):
    rc = np.array(jpv._generated_round_constants(), dtype=object)
    mds = np.array(jpv._generated_mds(), dtype=object)
    rc[17] = (rc[17] + 1) % P
    mds[3, 4] = (mds[3, 4] + 5) % P
    monkeypatch.setitem(jpv._OVERRIDE, "rc", tuple(int(v) for v in rc))
    monkeypatch.setitem(jpv._OVERRIDE, "mds",
                        tuple(tuple(int(v) for v in r) for r in mds))
    x = _states(6, 4)
    default = tgl.to_u64(tpv.permute(tgl.from_u64(x, "cpu")))
    interop.poseidon_params_from_reference(rc, mds)
    try:
        got = tgl.to_u64(tpv.permute(tgl.from_u64(x, "cpu")))
    finally:
        tpv.reset_params()
    want = [jpy.permute([int(v) for v in r]) for r in x]
    assert _ints(got) == want
    assert not np.array_equal(got, default)
    assert np.array_equal(tgl.to_u64(tpv.permute(tgl.from_u64(x, "cpu"))),
                          default)


def test_entry_twin_root_matches_jax_entry():
    import jax

    from __graft_entry__ import entry as jax_entry

    fn, args = jax_entry()
    want = [int(v) for v in jgl.to_u64(*jax.jit(fn)(*args))]
    assert entry.root("cpu") == want

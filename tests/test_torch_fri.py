"""The port's transcript and FRI pieces against the JAX package, on CPU:
the Challenger (scalar and bulk absorption), query-index derivation, one
FRI fold and commit layer, and the proof-of-work grind.  Tolerance: exact
equality of canonical field values and of transcript outputs."""

import numpy as np
import torch

from vectorx_tpu.field import extension as jext
from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.fri.fri import derive_query_indices as j_indices
from vectorx_tpu.fri.transcript import Challenger as JChallenger
from vectorx_tpu.stark import stages as jstages
from vectorx_tpu_torch.field import goldilocks as tgl
from vectorx_tpu_torch.fri.fri import derive_query_indices as t_indices
from vectorx_tpu_torch.fri.transcript import Challenger as TChallenger
from vectorx_tpu_torch.stark import stages as tstages

torch.set_num_threads(1)   # small tensors: more threads only contend with
                           # the other test workers

P = jgl.P


def _feed(ch, obs):
    ch.observe(3)                 # start from a partial input buffer
    ch.observe_many(obs[:20])
    ch.observe_cap([obs[20:24], obs[24:28]])
    ch.observe_bytes32(bytes(range(32)))
    ch.observe_many(obs[28:])
    return ch


def test_challenger_transcript_matches_jax():
    rng = np.random.default_rng(1)
    obs = [int(x) for x in rng.integers(0, 2**64, size=60, dtype=np.uint64)]
    j, t = _feed(JChallenger(), obs), _feed(TChallenger(), obs)
    assert t.get_n_challenges(5) == j.get_n_challenges(5)
    assert t.get_extension_challenge() == j.get_extension_challenge()
    assert t_indices(t, 12, 9) == j_indices(j, 12, 9)
    assert t.state == j.state and t.output_buf == j.output_buf


def test_challenger_bulk_absorption_matches_jax_and_elementwise():
    rng = np.random.default_rng(2)
    n = TChallenger.BULK_MIN + 64 + 5
    obs = [int(x) % P for x in rng.integers(0, 2**63, size=n,
                                            dtype=np.uint64)]
    t_bulk, t_elem, j_bulk = TChallenger(), TChallenger(), JChallenger()
    for ch in (t_bulk, t_elem, j_bulk):
        ch.observe(3)
    t_bulk.observe_many(obs)
    j_bulk.observe_many(obs)
    for e in obs:
        t_elem.observe(e)
    assert t_bulk.state == t_elem.state == j_bulk.state
    assert t_bulk.input_buf == t_elem.input_buf == j_bulk.input_buf
    assert t_bulk.get_n_challenges(6) == j_bulk.get_n_challenges(6) \
        == t_elem.get_n_challenges(6)


def test_fri_fold_and_commit_layer_match_jax():
    log_n, shift = 6, 7 ** 4 % P
    rng = np.random.default_rng(3)
    c0 = rng.integers(0, 2**64, size=1 << log_n, dtype=np.uint64)
    c1 = rng.integers(0, 2**64, size=1 << log_n, dtype=np.uint64)
    beta = tuple(int(v) % P for v in rng.integers(0, 2**64, size=2,
                                                  dtype=np.uint64))
    t = (tgl.from_u64(c0, "cpu"), tgl.from_u64(c1, "cpu"))
    got = tstages.fri_fold(t, beta, log_n, shift)
    want = jstages.fri_fold(jext.from_pair_u64(c0, c1), beta, log_n, shift)
    assert np.array_equal(tgl.to_u64(got[0]), jgl.to_u64(want[0], want[1]))
    assert np.array_equal(tgl.to_u64(got[1]), jgl.to_u64(want[2], want[3]))
    tree = tstages.fri_commit_layer(t, log_n, 1)
    jtree = jstages.fri_commit_layer(jext.from_pair_u64(c0, c1), log_n, 1)
    assert tree.cap_ints() == jtree.cap_ints()


def test_grind_matches_jax():
    rng = np.random.default_rng(4)
    obs = [int(x) for x in rng.integers(0, 2**64, size=11, dtype=np.uint64)]
    t, j = TChallenger(), JChallenger()
    t.observe_many(obs)
    j.observe_many(obs)
    nonce = tstages.grind(t, 8, "cpu")
    assert nonce == jstages.grind(j, 8)
    assert t.get_challenge() == j.get_challenge()

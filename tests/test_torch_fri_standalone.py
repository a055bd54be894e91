"""The port's standalone FRI low-degree prover and verifier, its host
Poseidon Merkle tree and the names it had left to port, against the JAX
package on CPU at small sizes: proofs field for field, each package's
verifier on the other's proof, `tests/test_fri.py`'s cases on the port,
tree layers, caps and openings, and the helpers at u64 edge values.
Tolerance: exact equality of canonical field values, digests and proof
fields."""

import numpy as np
import pytest
import torch

from vectorx_tpu import merkle as jmerkle
from vectorx_tpu.field import extension as jext
from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.fri import fri as jfri
from vectorx_tpu.fri.transcript import Challenger as JChallenger
from vectorx_tpu.hash import poseidon_np as jpnp
from vectorx_tpu.ntt import lde as jlde
from vectorx_tpu.stark import stages as jstages
from vectorx_tpu.stark.sha256_air import Sha256CompressAir as JCompressAir
from vectorx_tpu_torch import interop
from vectorx_tpu_torch import merkle as tmerkle
from vectorx_tpu_torch.field import extension as text
from vectorx_tpu_torch.field import goldilocks as tgl
from vectorx_tpu_torch.fri import fri as tfri
from vectorx_tpu_torch.fri.transcript import Challenger as TChallenger
from vectorx_tpu_torch.hash import poseidon as tpv
from vectorx_tpu_torch.ntt import coset_intt as t_coset_intt
from vectorx_tpu_torch.ntt import lde as t_lde
from vectorx_tpu_torch.stark import stages as tstages
from vectorx_tpu_torch.stark.sha256_air import Sha256CompressAir

torch.set_num_threads(1)   # small tensors: more threads only contend with
                           # the other test workers

P = jgl.P
GEN = jgl.GENERATOR
KNOBS = dict(rate_bits=3, cap_height=1, num_queries=16, final_poly_len=4,
             pow_bits=0)           # tests/test_fri.py's config
GRIND = dict(rate_bits=3, cap_height=0, num_queries=4, final_poly_len=4,
             pow_bits=4)           # and its grinding case's
EDGE = [0, 1, 2**32 - 1, 2**32, P - 2, P - 1, P, 2**64 - 1]


def _edge_u64(seed, shape):
    """Random u64 values (canonical or not) with the edge values first."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**64, size=shape, dtype=np.uint64).reshape(-1)
    k = min(len(EDGE), x.size)
    x[:k] = EDGE[:k]
    return x.reshape(shape)


def _codeword(log_n, seed):
    """The reference's coset codeword of a random degree < 2^log_n
    extension polynomial (`tests/test_fri.py::make_codeword`), as its
    4-tuple of limbs and as the port's (c0, c1) tensors."""
    rng = np.random.default_rng(seed)
    v0, v1 = (jlde(*jgl.from_u64(rng.integers(0, P, size=1 << log_n,
                                               dtype=np.uint64)), rate_bits=3)
              for _ in range(2))
    return (*v0, *v1), (interop.limbs_to_tensor(*v0, "cpu"),
                        interop.limbs_to_tensor(*v1, "cpu"))


def _plain(proof) -> dict:
    """A FriProof of either package as plain ints and lists."""
    return {
        "caps": [[[int(x) for x in d] for d in cap] for cap in proof.caps],
        "final_coeffs": [(int(a), int(b)) for a, b in proof.final_coeffs],
        "pow_witness": int(proof.pow_witness),
        "query_rounds": [[([int(x) for x in s.pair],
                           [[int(x) for x in d] for d in s.path])
                          for s in r.steps] for r in proof.query_rounds]}


def _as(mod, proof):
    """`proof` rebuilt as package `mod`'s FriProof."""
    p = _plain(proof)
    return mod.FriProof(
        caps=p["caps"], final_coeffs=p["final_coeffs"],
        pow_witness=p["pow_witness"],
        query_rounds=[mod.FriQueryRound(steps=[
            mod.FriQueryStep(pair=pair, path=path) for pair, path in r])
            for r in p["query_rounds"]])


@pytest.fixture(scope="module")
def proofs():
    """(log_len, knobs, reference proof, port proof) per config: log_n 5
    at tests/test_fri.py's config and log_n 4 with 4 grinding bits."""
    out = []
    for log_n, knobs, seed in ((5, KNOBS, 7), (4, GRIND, 9)):
        jcode, tcode = _codeword(log_n, seed)
        log_len = log_n + 3
        jp = jfri.prove_low_degree(jcode, log_len, GEN,
                                   jfri.FriConfig(**knobs), JChallenger())
        tp = tfri.prove_low_degree(tcode, log_len, GEN,
                                   tfri.FriConfig(**knobs), TChallenger())
        out.append((log_len, knobs, jp, tp))
    return out


def test_prove_low_degree_matches_reference(proofs):
    for _, knobs, jp, tp in proofs:
        assert _plain(tp) == _plain(jp), knobs
    assert proofs[1][3].pow_witness != 0    # the grind searched


def test_each_verifier_accepts_the_others_proof(proofs):
    for log_len, knobs, jp, tp in proofs:
        assert tfri.fri_verify(_as(tfri, jp), log_len, GEN,
                               tfri.FriConfig(**knobs), TChallenger())
        assert jfri.fri_verify(_as(jfri, tp), log_len, GEN,
                               jfri.FriConfig(**knobs), JChallenger())


def test_open_query_matches_reference():
    jcode, tcode = _codeword(5, 7)
    _, jlayers, jcodes = jfri.fri_prove(jcode, 8, GEN, jfri.FriConfig(**KNOBS),
                                        JChallenger())
    tproof, tlayers, tcodes = tfri.fri_prove(
        tcode, 8, GEN, tfri.FriConfig(**KNOBS), TChallenger())
    assert tproof.query_rounds == []
    assert all(isinstance(t, tmerkle.PoseidonMerkleTree) for t in tlayers)
    for (a0, a1), (b0, b1) in zip(tcodes, jcodes):
        assert np.array_equal(a0, b0) and np.array_equal(a1, b1)
    for index in (0, 1, 77, 128, 255):
        want = jfri.open_query(jlayers, jcodes, index)
        got = tfri.open_query(tlayers, tcodes, index)
        assert _plain(tfri.FriProof([], [], 0, [got])) == \
            _plain(jfri.FriProof([], [], 0, [want]))


# ---- tests/test_fri.py's five cases, on the port ---------------------------

def _port_codeword(log_n, seed):
    rng = np.random.default_rng(seed)
    return tuple(tgl.from_u64(rng.integers(0, P, size=1 << log_n,
                                           dtype=np.uint64), "cpu")
                 for _ in range(2))


def _port_lde(log_n, seed):
    return tuple(t_lde(v, rate_bits=3) for v in _port_codeword(log_n, seed))


def test_fri_roundtrip():
    cfg = tfri.FriConfig(**KNOBS)
    proof = tfri.prove_low_degree(_port_lde(6, 3), 9, GEN, cfg, TChallenger())
    assert tfri.fri_verify(proof, 9, GEN, cfg, TChallenger())


def test_fri_rejects_tampering():
    cfg = tfri.FriConfig(**KNOBS)
    code = _port_lde(5, 7)
    bad = tfri.prove_low_degree(code, 8, GEN, cfg, TChallenger())
    a, b = bad.final_coeffs[0]
    bad.final_coeffs[0] = ((a + 1) % P, b)
    assert not tfri.fri_verify(bad, 8, GEN, cfg, TChallenger())
    bad2 = tfri.prove_low_degree(code, 8, GEN, cfg, TChallenger())
    pair = bad2.query_rounds[0].steps[0].pair
    bad2.query_rounds[0].steps[0].pair = [(pair[0] + 1) % P, *pair[1:]]
    assert not tfri.fri_verify(bad2, 8, GEN, cfg, TChallenger())


def test_fri_rejects_high_degree():
    # a random codeword (not low-degree) fails the prover's degree check
    with pytest.raises(AssertionError):
        tfri.prove_low_degree(_port_codeword(8, 5), 8, GEN,
                              tfri.FriConfig(**KNOBS), TChallenger())


def test_fri_rejects_wrong_proof_shape():
    """caps=[] with the full interpolation of a random codeword as
    final_coeffs, and an honest proof with a fold layer stripped, both
    fail the replay's shape checks."""
    cfg = tfri.FriConfig(**KNOBS)
    f0, f1 = (tgl.to_u64(t_coset_intt(c, shift=GEN))
              for c in _port_codeword(8, 11))
    forged = tfri.FriProof(
        caps=[], final_coeffs=[(int(a), int(b)) for a, b in zip(f0, f1)],
        pow_witness=0, query_rounds=[])
    assert tfri.fri_replay(forged, 8, cfg, TChallenger()) is None
    assert not tfri.fri_verify(forged, 8, GEN, cfg, TChallenger())
    proof = tfri.prove_low_degree(_port_lde(5, 13), 8, GEN, cfg,
                                  TChallenger())
    proof.caps = proof.caps[:-1]
    assert tfri.fri_replay(proof, 8, cfg, TChallenger()) is None
    assert not tfri.fri_verify(proof, 8, GEN, cfg, TChallenger())


def test_fri_pow_grinding():
    cfg = tfri.FriConfig(**GRIND)
    proof = tfri.prove_low_degree(_port_lde(4, 9), 7, GEN, cfg, TChallenger())
    assert tfri.fri_verify(proof, 7, GEN, cfg, TChallenger())


# ---- the host tree ----------------------------------------------------------

def _tree_plain(tree, n):
    return ([layer.tolist() for layer in tree.layers], tree.cap_ints(),
            [tree.open(i) for i in range(n)])


@pytest.mark.parametrize("leaf_len", [1, 4, 5, 8])
def test_build_tree_matches_reference(leaf_len):
    n = 16
    leaves = _edge_u64(leaf_len, (n, leaf_len))
    lo, hi = jgl.from_u64(leaves)
    for cap_height in range(4):
        want = jmerkle.build_tree(lo, hi, cap_height)
        got = tmerkle.build_tree(interop.limbs_to_tensor(lo, hi, "cpu"),
                                 cap_height)
        assert got.cap_height == cap_height
        assert _tree_plain(got, n) == _tree_plain(want, n), cap_height
    assert tstages.HostTree is tmerkle.PoseidonMerkleTree


def test_build_tree_from_digests_matches_reference():
    n = 32
    d = _edge_u64(21, (n, 4)) % np.uint64(P)
    for cap_height in (0, 2):
        want = jmerkle.build_tree_from_digests(*jgl.from_u64(d), cap_height)
        got = tmerkle.build_tree_from_digests(tgl.from_u64(d, "cpu"),
                                              cap_height)
        assert _tree_plain(got, n) == _tree_plain(want, n)
    paths = got.open_paths([3, 17])
    assert [[[int(x) for x in lvl[q]] for lvl in paths] for q in (0, 1)] \
        == [got.open(3), got.open(17)]


# ---- the leftover names ------------------------------------------------------

@pytest.mark.parametrize("rows", [3, 9])
def test_hash_rows_leaves_matches_reference(rows):
    e = _edge_u64(rows, (rows, 16))
    want = jstages.hash_rows_leaves(*jgl.from_u64(e))
    got = tstages.hash_rows_leaves(tgl.from_u64(e, "cpu"))
    assert np.array_equal(tgl.to_u64(got), jgl.to_u64(*want))


def test_extension_helpers_match_reference():
    a0, a1, b0, b1 = (_edge_u64(s, (64,)) for s in (1, 2, 3, 4))
    b0[:8], b1[:8] = a0[:8], a1[:8]          # equal pairs for eq, and one
    a0[8], b0[8], b1[8] = 3, P + 3, a1[8]    # equal only mod p
    ja, jb = jext.from_pair_u64(a0, a1), jext.from_pair_u64(b0, b1)
    ta = text.from_pair_u64(a0, a1, "cpu")
    tb = text.from_pair_u64(b0, b1, "cpu")

    def same(t, j):
        assert np.array_equal(tgl.to_u64(t[0]), jgl.to_u64(j[0], j[1]))
        assert np.array_equal(tgl.to_u64(t[1]), jgl.to_u64(j[2], j[3]))

    same(text.sqr(ta), jext.sqr(ja))
    same(text.neg(ta), jext.neg(ja))
    for e in (0, 1, 5, P - 2):
        same(text.pow_const(ta, e), jext.pow_const(ja, e))
    same(text.from_base(ta[0]), jext.from_base(ja[0], ja[1]))
    assert np.array_equal(text.eq(ta, tb).numpy(), np.asarray(jext.eq(ja, jb)))
    assert bool(text.eq(ta, tb)[:9].all())
    same(text.zeros((3, 2), "cpu"), jext.zeros((3, 2)))
    same(text.from_pair_u64(5, P + 3, "cpu"),
         jext.from_pair_u64(np.uint64(5), np.uint64(P + 3)))


def test_goldilocks_constructors_match_reference():
    shape = (2, 3)
    assert np.array_equal(tgl.to_u64(tgl.zeros(shape, "cpu")),
                          jgl.to_u64(*jgl.zeros(shape)))
    assert np.array_equal(tgl.to_u64(tgl.ones(shape, "cpu")),
                          jgl.to_u64(*jgl.ones(shape)))
    for v in EDGE + [2**70 + 9, -1]:
        got = tgl.full(shape, v, "cpu")
        assert got.dtype == torch.int64 and got.shape == shape
        assert np.array_equal(tgl.to_u64(got),
                              jgl.to_u64(*jgl.full(shape, v))), v


def _pad_single(msg: bytes) -> bytes:
    return (msg + b"\x80" + b"\x00" * (55 - len(msg))
            + (len(msg) * 8).to_bytes(8, "big"))


@pytest.mark.parametrize("block", [_pad_single(b"abc"), bytes(range(64))],
                         ids=["abc", "range64"])
def test_sha256_compress_air_matches_reference(block):
    tair, jair = Sha256CompressAir(block), JCompressAir(block)
    assert (tair.log_n, tair.width, tair.bind) == \
        (jair.log_n, jair.width, jair.bind) == (7, jair.width, "consts")
    assert tair.digest == jair.digest
    assert tair.public_inputs() == jair.public_inputs()
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())


def test_poseidon_np_maps_to_the_ports_cpu_poseidon():
    """`hash/poseidon_np.py` is mapped to `hash.poseidon` on CPU tensors:
    its three functions (and their `_fast` twins) equal the port's on the
    same canonical inputs, u64 edge values among them."""
    def port(fn, *xs):
        return tgl.to_u64(fn(*(tgl.from_u64(x, "cpu") for x in xs)))

    canon = [v for v in EDGE if v < P]
    states = _edge_u64(31, (16, 12)) % np.uint64(P)
    states[0, :len(canon)] = canon
    want = port(tpv.permute, states)
    assert np.array_equal(jpnp.permute(states), want)
    assert np.array_equal(jpnp.permute_fast(states), want)
    left, right = states[:, :4].copy(), states[:, 4:8].copy()
    want = port(tpv.two_to_one, left, right)
    assert np.array_equal(jpnp.two_to_one(left, right), want)
    assert np.array_equal(jpnp.two_to_one_fast(left, right), want)
    for width in (1, 8, 9, 20):
        rows = _edge_u64(width, (6, width)) % np.uint64(P)
        want = port(tpv.hash_no_pad, rows)
        assert np.array_equal(jpnp.hash_no_pad(rows), want), width
        assert np.array_equal(jpnp.hash_no_pad_fast(rows), want), width

"""The recursion stack in the port against the JAX package, on CPU torch:
`PoseidonAir`, the shadow verifier's tape (`verifier_tape`), the
verifier-VM machine AIR and aggregation.

* `PoseidonAir`'s proof JSON, constant columns and trace are equal.
* The witness-mode `verifier_tape` of a FibonacciAir(4) proof (at
  `tests/test_recursion_tape.py`'s config) lowers to a `Program` equal to
  the reference's: items, reads, publics, rows and values.  Tampered
  proofs raise `TapeCheckFailed` in both packages.
* The aggregation of `tests/test_recursion_aggregate.py` (FibonacciAir(3)
  and one PoseidonAir permutation, a 3761-row machine at log_n 12): equal
  constant columns, trace and machine proof JSON; each package's
  `aggregate_verify` accepts the other's proof; that test's rejections
  hold in the port.  The reference's machine proof of this aggregation
  comes from the golden fixtures; its machine proof of FibonacciAir(3)
  alone has none (about five minutes on XLA:CPU), so the port's
  FibonacciAir(3) machine proof is held against its CUDA twin in
  `chip_smoke.py` phase 4 instead.

The module proves its aggregation once, with both packages' caches in a
temporary directory, and every test checks one property of it.
"""

import copy
import json

import numpy as np
import pytest
import torch

from vectorx_tpu import stark as jstark
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.recursion import aggregate as jagg
from vectorx_tpu.recursion import progcache as jprogcache
from vectorx_tpu.recursion.machine import compile_tape as jcompile
from vectorx_tpu.recursion.shadow import verifier_tape as jtape
from vectorx_tpu.recursion.ssa import Builder as JBuilder
from vectorx_tpu.recursion.ssa import TapeCheckFailed as JTapeCheckFailed
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark import vk as jvk
from vectorx_tpu.stark.poseidon_air import PoseidonAir as JPoseidonAir
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.recursion import aggregate, progcache
from vectorx_tpu_torch.recursion.machine import compile_tape
from vectorx_tpu_torch.recursion.shadow import verifier_tape
from vectorx_tpu_torch.recursion.ssa import Builder, TapeCheckFailed
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark import vk
from vectorx_tpu_torch.stark.poseidon_air import PoseidonAir

torch.set_num_threads(1)

# tests/test_recursion_aggregate.py's config
AGG_KNOBS = dict(rate_bits=3, cap_height=1, num_queries=2, final_poly_len=2,
                 pow_bits=1)
CFG = tstark.StarkConfig(fri=FriConfig(**AGG_KNOBS))
JCFG = jstark.StarkConfig(fri=JFriConfig(**AGG_KNOBS))
# tests/test_recursion_tape.py's config
TAPE_KNOBS = dict(rate_bits=3, cap_height=1, num_queries=4, final_poly_len=4,
                  pow_bits=4)
TCFG = tstark.StarkConfig(fri=FriConfig(**TAPE_KNOBS))
JTCFG = jstark.StarkConfig(fri=JFriConfig(**TAPE_KNOBS))


def _children():
    return [tstark.FibonacciAir(log_n=3), PoseidonAir(list(range(12)))]


def _jchildren():
    return [jstark.FibonacciAir(log_n=3), JPoseidonAir(list(range(12)))]


def _clear_caches():
    for mod in (vk, progcache, jvk, jprogcache):
        mod.clear_memory_cache()


@pytest.fixture(scope="module", autouse=True)
def isolated_caches(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VECTORX_VK_CACHE", str(tmp_path_factory.mktemp("vk")))
        _clear_caches()
        yield
        _clear_caches()


@pytest.fixture(scope="module")
def agg():
    """Both packages' children, child proofs and aggregations."""
    children, jchildren = _children(), _jchildren()
    proofs = [tstark.prove(a, a.build_trace(), CFG, device="cpu")
              for a in children]
    jproofs = [jstark.prove(a, a.build_trace(), JCFG) for a in jchildren]
    result = aggregate.aggregate_prove(children, proofs, CFG, device="cpu")
    # the PoseidonAir child's key: its proof, which absorbs the key, equals
    # the reference's (test_poseidon_air_matches_reference)
    share_vk_caps(children, jchildren, CFG, JCFG)
    jresult = jagg.aggregate_prove(jchildren, jproofs, JCFG)
    return dict(children=children, proofs=proofs, jproofs=jproofs,
                agg=result, jagg=jresult,
                json=json.dumps(tser.proof_to_json(result.proof)),
                jjson=json.dumps(jser.proof_to_json(jresult.proof)))


def _by_value(obj):
    """A dataclass as (class name, fields), nested ones too, so the two
    packages' dataclasses compare by value (without `asdict`'s deep copy)."""
    return (type(obj).__name__,
            {k: _by_value(v) if hasattr(v, "__dataclass_fields__") else v
             for k, v in vars(obj).items()})


def _program_fields(prog):
    """A Program's fields with the items compared by value."""
    return dict(items=[_by_value(i) for i in prog.items],
                reads=prog.reads, publics=prog.publics, n_rows=prog.n_rows,
                values=prog.values, witness=prog.witness)


def share_vk_caps(airs, jairs, cfg, jcfg):
    """Store the port's verification keys of `airs` in the reference's key
    cache under its content keys for `jairs` (the same statements), so the
    reference does not derive them again on XLA:CPU.  The port's keys are
    held to the reference's elsewhere: its provers commit the same
    constant columns and absorb the cap into the transcript, and their
    proofs equal the reference's."""
    for air, jair in zip(airs, jairs):
        cap = vk.constants_cap(air, cfg, device="cpu")
        if cap is not None:
            jvk._store(jvk.cache_key(jair.constant_columns(), jcfg), cap)


# ---------------------------------------------------------------------------
# PoseidonAir
# ---------------------------------------------------------------------------

def test_poseidon_air_matches_reference(agg):
    tair, jair = agg["children"][1], _jchildren()[1]
    assert tair.public_inputs() == jair.public_inputs()
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())
    assert json.dumps(tser.proof_to_json(agg["proofs"][1])) == \
        json.dumps(jser.proof_to_json(agg["jproofs"][1]))


def test_poseidon_batch_air_matches_reference():
    """Two permutations in one trace (`tests/test_poseidon_air.py`'s batch
    shape): equal columns and trace; the port's proof verifies."""
    inputs = [list(range(12)), [7] * 12]
    tair, jair = PoseidonAir(inputs), JPoseidonAir(inputs)
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())
    proof = tstark.prove(tair, tair.build_trace(), CFG, device="cpu")
    assert tstark.verify(tair, proof, CFG, device="cpu")
    wrong = PoseidonAir([list(range(12)), [8] * 12])
    assert not tstark.verify(wrong, proof, CFG, device="cpu")


# ---------------------------------------------------------------------------
# The shadow verifier's tape
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tape_proof():
    """tests/test_recursion_tape.py's FibonacciAir(4) proof (golden), and
    the same proof as a port StarkProof."""
    jair = jstark.FibonacciAir(log_n=4)
    jproof = jstark.prove(jair, jair.build_trace(), JTCFG)
    return jproof, tser.proof_from_json(jser.proof_to_json(jproof))


@pytest.mark.parametrize("witness", [True, False],
                         ids=["witness_mode", "statement_mode"])
def test_verifier_tape_program_matches_reference(tape_proof, witness):
    jproof, tproof = tape_proof
    b = Builder(witness=witness)
    n_pub = verifier_tape(b, tstark.FibonacciAir(log_n=4), TCFG,
                          proof=tproof if witness else None, device="cpu")
    jb = JBuilder(witness=witness)
    jn_pub = jtape(jb, jstark.FibonacciAir(log_n=4), JTCFG,
                   proof=jproof if witness else None)
    assert n_pub == jn_pub == 3
    assert _program_fields(compile_tape(b)) == \
        _program_fields(jcompile(jb))


MUTATIONS = {
    "trace_at_zeta": lambda p: p.trace_at_zeta.__setitem__(
        0, ((p.trace_at_zeta[0][0] + 1) % P, p.trace_at_zeta[0][1])),
    "trace_cap": lambda p: p.trace_cap[0].__setitem__(
        0, p.trace_cap[0][0] + 1),
    "final_coeff": lambda p: p.fri_proof.final_coeffs.__setitem__(
        0, (p.fri_proof.final_coeffs[0][0] + 1, 0)),
    "trace_leaf": lambda p: p.trace_openings[0].leaf.__setitem__(
        0, p.trace_openings[0].leaf[0] + 1),
    "fri_pair": lambda p: p.fri_proof.query_rounds[0].steps[0].pair
    .__setitem__(0, p.fri_proof.query_rounds[0].steps[0].pair[0] + 1),
    "pow_witness": lambda p: setattr(p.fri_proof, "pow_witness",
                                     p.fri_proof.pow_witness + 1),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_tampered_proofs_fail_both_tapes(tape_proof, name):
    jproof, tproof = tape_proof
    tbad, jbad = copy.deepcopy(tproof), copy.deepcopy(jproof)
    MUTATIONS[name](tbad)
    MUTATIONS[name](jbad)
    with pytest.raises(TapeCheckFailed):
        verifier_tape(Builder(witness=True), tstark.FibonacciAir(log_n=4),
                      TCFG, proof=tbad, device="cpu")
    with pytest.raises(JTapeCheckFailed):
        jtape(JBuilder(witness=True), jstark.FibonacciAir(log_n=4), JTCFG,
              proof=jbad)


# ---------------------------------------------------------------------------
# The machine AIR and aggregation
# ---------------------------------------------------------------------------

def test_machine_program_columns_and_trace_match_reference(agg):
    tair, jair = agg["agg"].machine_air, agg["jagg"].machine_air
    assert (tair.program.n_rows, tair.log_n) == (3761, 12)
    assert _program_fields(tair.program) == _program_fields(jair.program)
    assert np.array_equal(tair.constant_columns(), jair.constant_columns())
    assert np.array_equal(tair.build_trace(), jair.build_trace())
    assert tair.boundaries(tair.public_inputs()) == \
        jair.boundaries(jair.public_inputs())


def test_machine_proof_matches_reference(agg):
    assert agg["json"] == agg["jjson"]


def test_each_aggregate_verify_accepts_the_others_proof(agg):
    """The reference's verifier gets the verification key the port derives
    (its own derivation on XLA:CPU is slow); the proof's constant
    openings are Merkle-checked against it, so a wrong key rejects."""
    jchildren = _jchildren()
    assert aggregate.aggregate_verify(
        _children(), tser.proof_from_json(json.loads(agg["jjson"])), CFG,
        device="cpu")
    share_vk_caps([agg["agg"].machine_air], [agg["jagg"].machine_air], CFG,
                  JCFG)
    assert jagg.aggregate_verify(
        jchildren, jser.proof_from_json(json.loads(agg["json"])), JCFG)


def test_aggregate_roundtrip_and_public_offsets(agg):
    result = agg["agg"]
    assert aggregate.aggregate_verify(_children(), result.proof, CFG,
                                      device="cpu")
    pubs = result.machine_air.public_inputs()
    for air, off in zip(_children(), result.public_offsets):
        cp = [int(v) % P for v in air.public_inputs()]
        assert pubs[off:off + len(cp)] == cp
    assert result.public_offsets == agg["jagg"].public_offsets


def test_aggregate_rejects_bad_child_proof(agg):
    bad = [copy.deepcopy(p) for p in agg["proofs"]]
    bad[0].trace_at_zeta[0] = ((bad[0].trace_at_zeta[0][0] + 1) % P,
                               bad[0].trace_at_zeta[0][1])
    children = _children()
    assert not tstark.verify(children[0], bad[0], CFG, device="cpu")
    with pytest.raises(TapeCheckFailed):
        aggregate.aggregate_prove(children, bad, CFG, device="cpu")


def test_aggregate_rejects_wrong_statement(agg):
    # accepted first, so that the rejections below are not an exception
    assert aggregate.aggregate_verify(_children(), agg["agg"].proof, CFG,
                                      device="cpu")
    wrong = _children()
    wrong[0] = tstark.FibonacciAir(log_n=3, a0=9, b0=9)
    assert not aggregate.aggregate_verify(wrong, agg["agg"].proof, CFG,
                                          device="cpu")
    assert not aggregate.aggregate_verify(_children()[:1], agg["agg"].proof,
                                          CFG, device="cpu")


def test_aggregate_rejects_tampered_outer_proof(agg):
    bad = copy.deepcopy(agg["agg"].proof)
    bad.fri_proof.final_coeffs[0] = (
        (bad.fri_proof.final_coeffs[0][0] + 1) % P,
        bad.fri_proof.final_coeffs[0][1])
    assert not aggregate.aggregate_verify(_children(), bad, CFG,
                                          device="cpu")


def test_stripped_witness_program_matches_statement_rebuild(agg):
    stripped = progcache.strip_witness(agg["agg"].machine_air.program)
    b, _ = aggregate._build_tape(_children(), CFG, proofs=None,
                                 device="cpu")
    rebuilt = compile_tape(b)
    assert _program_fields(stripped) == _program_fields(rebuilt)
    assert stripped.values is None and not stripped.witness


def test_aggregate_verify_uses_the_program_cache(agg, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("tape re-derivation ran despite cache hit")

    monkeypatch.setattr(aggregate, "_build_tape", boom)
    assert aggregate.aggregate_verify(_children(), agg["agg"].proof, CFG,
                                      device="cpu")

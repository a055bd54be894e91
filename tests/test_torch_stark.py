"""The slice end to end on CPU torch: the port's STARK prover and verifier
against the JAX package's.

* `proof_to_json` of the port's proof equals the reference's, for
  FibonacciAir(log_n=5) under `tests/test_stark.py`'s config and for the
  RangeCheck statement of `tests/test_lookup.py` (both reference proofs load
  from the golden fixtures through the proof cache).
* Each package's verifier accepts the other's proof (carried as JSON).
* The port's coset-streamed prover gives the same JSON as its unstreamed
  prover and as the reference's `prove_streamed`, for FibonacciAir(4), the
  RangeCheck statement and the bus AIR; `prove` hands a statement past
  the streaming bound to it.
* Tampering and an invalid trace are refused.
* Importing the port loads neither JAX nor the JAX package.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vectorx_tpu import stark as jstark
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu.stark.range_air import RangeCheckAir as JRangeCheckAir
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.air import Air, BusPort

torch.set_num_threads(1)   # small tensors: more threads only contend with
                           # the other test workers

P = (1 << 64) - (1 << 32) + 1
KNOBS = dict(rate_bits=3, cap_height=1, num_queries=12, final_poly_len=4,
             pow_bits=0)
CFG = tstark.StarkConfig(fri=FriConfig(**KNOBS))
JCFG = jstark.StarkConfig(fri=JFriConfig(**KNOBS))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _range_values():
    # the first statement `tests/test_lookup.py::_air()` draws
    return np.random.default_rng(11).integers(0, 1 << 6, size=(4, 255),
                                              dtype=np.uint64)


def _statements():
    vals = _range_values()
    return {
        "fib": (tstark.FibonacciAir(log_n=5), jstark.FibonacciAir(log_n=5)),
        "range": (tstark.RangeCheckAir(8, 6, vals),
                  JRangeCheckAir(8, 6, vals)),
    }


@pytest.fixture(scope="module")
def proofs():
    """name -> (port air, reference air, port proof JSON, reference JSON)."""
    out = {}
    for name, (tair, jair) in _statements().items():
        trace = tair.build_trace()
        assert np.array_equal(trace, jair.build_trace())
        tp = tstark.prove(tair, trace, CFG, device="cpu")
        jp = jstark.prove(jair, trace, JCFG)
        out[name] = (tair, jair, tser.proof_to_json(tp),
                     jser.proof_to_json(jp))
    return out


@pytest.mark.parametrize("name", ["fib", "range"])
def test_proof_json_matches_reference(proofs, name):
    _, _, tjson, jjson = proofs[name]
    assert json.dumps(tjson) == json.dumps(jjson)


@pytest.mark.parametrize("name", ["fib", "range"])
def test_port_verifier_accepts_reference_proof(proofs, name):
    tair, _, _, jjson = proofs[name]
    proof = tser.proof_from_json(jjson)
    assert tstark.verify(tair, proof, CFG, device="cpu")


class _Cap:
    def __init__(self, cap):
        self._cap = cap

    def cap_ints(self):
        return self._cap


@pytest.mark.parametrize("name", ["fib", "range"])
def test_reference_verifier_accepts_port_proof(proofs, name):
    """The range statement's verification key (its constants cap) is
    derived by the port: the reference derivation costs a ~30 s XLA
    compile on CPU, and the proof's constant openings are Merkle-checked
    against this cap, so a wrong cap would be rejected."""
    tair, jair, tjson, _ = proofs[name]
    pre = None
    if tair.num_constants():
        from vectorx_tpu_torch.stark.vk import constants_cap

        pre = (_Cap(constants_cap(tair, CFG, device="cpu")),)
    assert jstark.verify(jair, jser.proof_from_json(tjson), JCFG,
                         preprocessed=pre)


@pytest.mark.parametrize("field_name", ["trace_at_zeta", "quotient_at_zeta",
                                        "final_coeffs", "query_leaf",
                                        "aux_at_zeta"])
def test_tampered_proof_rejected(proofs, field_name):
    tair, _, tjson, _ = proofs["range"]
    proof = tser.proof_from_json(tjson)
    if field_name == "final_coeffs":
        target = proof.fri_proof.final_coeffs
    elif field_name == "query_leaf":
        leaf = proof.trace_openings[3].leaf
        leaf[0] = (leaf[0] + 1) % P
        target = None
    else:
        target = getattr(proof, field_name)
    if target is not None:
        c0, c1 = target[0]
        target[0] = ((c0 + 1) % P, c1)
    assert not tstark.verify(tair, proof, CFG, device="cpu")


def test_invalid_traces_fail_the_prover():
    air = tstark.FibonacciAir(log_n=4)
    trace = air.build_trace()
    trace[1, 7] = (trace[1, 7] + 1) % P      # break the recurrence
    with pytest.raises(AssertionError):
        tstark.prove(air, trace, CFG, device="cpu")
    rair = tstark.RangeCheckAir(8, 6, _range_values())
    trace = rair.build_trace()
    trace[rair.V, 2] += 1                    # overcount one table entry
    with pytest.raises(AssertionError):
        tstark.prove(rair, trace, CFG, device="cpu")


def _streamed_statements():
    from test_bus import BusAir as JBusAir
    from test_torch_bus import BusAir

    vals = _range_values()
    bus_cfg = dict(KNOBS, cap_height=0)       # tests/test_bus.py's config
    return {
        "fib": (tstark.FibonacciAir(log_n=4), jstark.FibonacciAir(log_n=4),
                KNOBS),
        "range": (tstark.RangeCheckAir(8, 6, vals),
                  JRangeCheckAir(8, 6, vals), KNOBS),
        "bus": (BusAir(), JBusAir(), bus_cfg),
    }


@pytest.fixture(scope="module")
def streamed(proofs):
    """name -> (port prove_streamed JSON, port prove JSON, reference JSON).

    The reference is its `prove` (golden fixtures through the proof
    cache): `tests/test_stark.py::test_streamed_prover_bit_exact` holds its
    streamed proofs equal to those.  Its `prove_streamed` itself runs on
    FibonacciAir(4) in `test_fib_streamed_matches_reference_streamed`; on
    a statement with constant columns under its streaming bound it cannot
    run (its preprocessed tree is then not a host tree).  The range
    statement's unstreamed proofs are the `proofs` fixture's."""
    from vectorx_tpu_torch.stark.prover import prove_streamed

    out = {}
    for name, (tair, jair, knobs) in _streamed_statements().items():
        cfg = tstark.StarkConfig(fri=FriConfig(**knobs))
        trace = tair.build_trace()
        if name == "range":
            full, ref = proofs[name][2:]
        else:
            full = tser.proof_to_json(tstark.prove(tair, trace, cfg,
                                                   device="cpu"))
            ref = jser.proof_to_json(jstark.prove(
                jair, trace, jstark.StarkConfig(fri=JFriConfig(**knobs))))
        out[name] = tuple(json.dumps(x) for x in (
            tser.proof_to_json(prove_streamed(tair, trace, cfg,
                                              device="cpu")), full, ref))
    return out


@pytest.mark.parametrize("name", ["fib", "range", "bus"])
def test_streamed_proof_matches_unstreamed_and_reference(streamed, name):
    port_streamed, port_full, ref = streamed[name]
    assert port_streamed == port_full
    assert port_streamed == ref


def test_fib_streamed_matches_reference_streamed(streamed):
    from vectorx_tpu.stark.prover import prove_streamed as jprove_streamed

    air = jstark.FibonacciAir(log_n=4)
    ref = jprove_streamed(air, air.build_trace(), JCFG)
    assert json.dumps(jser.proof_to_json(ref)) == streamed["fib"][0]


def test_bus_ports_not_ported_yet():
    """Bus ports (once refused here): the bus AIR of `tests/test_bus.py`
    proves and verifies on the port, and a proof checked against another
    program's preprocessed columns is rejected."""
    from test_torch_bus import BusAir

    air = BusAir()
    proof = tstark.prove(air, air.build_trace(), CFG, device="cpu")
    assert tstark.verify(air, proof, CFG, device="cpu")
    assert not tstark.verify(BusAir(corrupt_addr=30), proof, CFG,
                             device="cpu")


class _WideAir(Air):
    """A statement past the reference's streaming threshold and the port's
    own (higher) H100 bound: 1024 + 2 columns x 2^25 points."""

    def __init__(self):
        super().__init__(width=1024, log_n=22)


def test_statement_the_reference_would_stream_is_refused(monkeypatch):
    """Past the port's bound `prove` hands the statement to
    `prove_streamed` (recorded here, not proven); under a lowered bound
    a small statement takes the streamed path and still gives the
    unstreamed proof."""
    from vectorx_tpu_torch.stark import prover as tprover

    assert tprover._commit_cols(_WideAir()) << 25 > \
        tprover.STREAM_THRESHOLD_ELEMS
    calls = []
    orig = tprover.prove_streamed

    def record(air, trace, config, *, device):
        calls.append(air)
        return "streamed"

    monkeypatch.setattr(tprover, "prove_streamed", record)
    wide = _WideAir()
    assert tstark.prove(wide, np.zeros((0, 0), dtype=np.uint64),
                        tstark.StarkConfig(), device="cpu") == "streamed"
    assert calls == [wide]

    air = tstark.FibonacciAir(log_n=5)
    full = tser.proof_to_json(tstark.prove(air, air.build_trace(), CFG,
                                           device="cpu"))
    monkeypatch.setattr(tprover, "prove_streamed",
                        lambda *a, **k: calls.append(a[0]) or orig(*a, **k))
    monkeypatch.setattr(tprover, "STREAM_THRESHOLD_ELEMS", 1 << 8)
    proof = tstark.prove(air, air.build_trace(), CFG, device="cpu")
    assert calls == [wide, air]
    assert json.dumps(tser.proof_to_json(proof)) == json.dumps(full)


def test_port_imports_without_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import vectorx_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'vectorx_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'vectorx_tpu' or m.startswith('vectorx_tpu.')]\n"
        "new = {'circuits.header_range', 'circuits.zk_header_range',\n"
        "       'circuits.zk_commitment', 'circuits.subchain',\n"
        "       'circuits.justification', 'circuits.rotate', 'circuits.dummy',\n"
        "       'curves.ed25519', 'curves.ed25519_batch', 'hash.blake2b',\n"
        "       'hash.sha256', 'io.abi', 'io.fixtures', 'scale',\n"
        "       'stark.blake2b_air', 'stark.sha256_air',\n"
        "       'stark.poseidon_air', 'circuits.zk_rotate', 'recursion',\n"
        "       'recursion.ssa', 'recursion.shadow', 'recursion.machine',\n"
        "       'recursion.progcache', 'recursion.aggregate',\n"
        "       'config', 'io.keccak', 'io.store', 'io.avail_rpc',\n"
        "       'services', 'services.contract', 'services.prover_service',\n"
        "       'services.genesis', 'services.fill_block_range',\n"
        "       'services.operator', 'services.indexer', 'services.events',\n"
        "       'bin', 'bin._entrypoint', 'bin.header_range_256',\n"
        "       'bin.header_range_512', 'bin.rotate',\n"
        "       'bin.dummy_header_range_256', 'bin.dummy_header_range_512',\n"
        "       'bin.dummy_rotate', 'bin.operator', 'bin.indexer',\n"
        "       'bin.events', 'bin.genesis', 'bin.fill_block_range',\n"
        "       'stark.ed25519_air', 'recursion.succinct'}\n"
        "missing = {'vectorx_tpu_torch.' + m for m in new} - set(names)\n"
        "assert not missing, missing\n"
        "assert len(names) >= 79, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr

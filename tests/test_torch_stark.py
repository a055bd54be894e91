"""The slice end to end on CPU torch: the port's STARK prover and verifier
against the JAX package's.

* `proof_to_json` of the port's proof equals the reference's, for
  FibonacciAir(log_n=5) under `tests/test_stark.py`'s config and for the
  RangeCheck statement of `tests/test_lookup.py` (both reference proofs load
  from the golden fixtures through the proof cache).
* Each package's verifier accepts the other's proof (carried as JSON).
* Tampering, an invalid trace, bus ports and statements the reference would
  stream are refused.
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


class _BusAir(Air):
    def __init__(self):
        super().__init__(width=2, log_n=4)

    def bus_ports(self):
        return [BusPort(value_cols=(0, 1), addr_col=0, mult_col=1)]


def test_bus_ports_not_ported_yet():
    air = _BusAir()
    with pytest.raises(NotImplementedError):
        tstark.prove(air, np.zeros((2, 16), dtype=np.uint64), CFG,
                     device="cpu")
    with pytest.raises(NotImplementedError):
        tstark.verify(air, None, CFG, device="cpu")


class _WideAir(Air):
    """A statement past the reference's streaming threshold."""

    def __init__(self):
        super().__init__(width=64, log_n=22)


def test_statement_the_reference_would_stream_is_refused():
    with pytest.raises(NotImplementedError, match="prove_streamed"):
        tstark.prove(_WideAir(), np.zeros((0, 0), dtype=np.uint64),
                     tstark.StarkConfig(), device="cpu")


def test_port_imports_without_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import vectorx_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'vectorx_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'vectorx_tpu' or m.startswith('vectorx_tpu.')]\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr

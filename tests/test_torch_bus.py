"""The LogUp memory bus (`BusPort`) in the port against the JAX package, on
CPU torch, with the bus AIR of `tests/test_bus.py`: a value written once
with multiplicity k must be read exactly k times with the identical value.

* `proof_to_json` of the port's proof equals the reference's, unstreamed
  and streamed;
* each package's verifier accepts the other's proof;
* a tampered read and a read of an unwritten address fail the prover;
* the proof does not transfer to another program (preprocessed columns).
"""

import json

import numpy as np
import pytest
import torch

from test_bus import BusAir as JBusAir
from vectorx_tpu import stark as jstark
from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.stark import serialize as jser
from vectorx_tpu_torch import stark as tstark
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.stark import serialize as tser
from vectorx_tpu_torch.stark.air import Air, BusPort, bus_aux_layout
from vectorx_tpu_torch.stark.prover import prove_streamed

torch.set_num_threads(1)

# the config of tests/test_bus.py
KNOBS = dict(rate_bits=3, cap_height=0, num_queries=12, final_poly_len=4,
             pow_bits=0)
CFG = tstark.StarkConfig(fri=FriConfig(**KNOBS))
JCFG = jstark.StarkConfig(fri=JFriConfig(**KNOBS))


class BusAir(Air):
    """The port's twin of `tests/test_bus.py::BusAir`: width 4, port 0 on
    columns (0, 1), port 1 on (2, 3).  X is written once (fanout 2) and
    read twice at distant rows; Y written once, read once."""

    WRITES = JBusAir.WRITES
    READS = JBusAir.READS

    def __init__(self, corrupt_row=None, corrupt_addr=None):
        super().__init__(width=4, log_n=6, constraint_degree=2)
        self.corrupt_row = corrupt_row
        self.corrupt_addr = corrupt_addr

    def bus_ports(self):
        return [BusPort(value_cols=(0, 1), addr_col=0, mult_col=1),
                BusPort(value_cols=(2, 3), addr_col=2, mult_col=3)]

    def constant_columns(self):
        cols = np.zeros((4, self.n), dtype=np.uint64)
        for row, (addr, _v, fanout) in self.WRITES.items():
            cols[0, row] = addr
            cols[1, row] = fanout
        for row, (addr, _v) in self.READS.items():
            cols[2, row] = addr
            cols[3, row] = gl.P - 1           # multiplicity -1
        if self.corrupt_addr is not None:
            cols[2, self.corrupt_addr] = 3    # read from an unwritten addr
        return cols

    def transition(self, alg, local, nxt, public, consts=None):
        return []

    def build_trace(self):
        tr = np.zeros((4, self.n), dtype=np.uint64)
        for row, (_a, (v0, v1), _f) in self.WRITES.items():
            tr[0, row + 1], tr[1, row + 1] = v0, v1
        for row, (_a, (v0, v1)) in self.READS.items():
            tr[2, row + 1], tr[3, row + 1] = v0, v1
        if self.corrupt_row is not None:
            tr[2, self.corrupt_row + 1] ^= 1
        return tr


@pytest.fixture(scope="module")
def proofs():
    """(port proof JSON, streamed port proof JSON, reference JSON)."""
    air = BusAir()
    trace = air.build_trace()
    assert np.array_equal(trace, JBusAir().build_trace())
    assert np.array_equal(air.constant_columns(),
                          JBusAir().constant_columns())
    tp = tstark.prove(air, trace, CFG, device="cpu")
    ts = prove_streamed(air, trace, CFG, device="cpu")
    jp = jstark.prove(JBusAir(), trace, JCFG)
    return (tser.proof_to_json(tp), tser.proof_to_json(ts),
            jser.proof_to_json(jp))


def test_bus_aux_layout_matches_reference():
    from vectorx_tpu.stark.air import bus_aux_layout as jlayout
    from vectorx_tpu.stark.air import lookup_boundaries as jbnd
    from vectorx_tpu_torch.stark.air import lookup_boundaries

    assert bus_aux_layout(BusAir()) == jlayout(JBusAir()) == (0, 4, 6)
    assert lookup_boundaries(BusAir()) == jbnd(JBusAir())


@pytest.mark.parametrize("which", ["prove", "prove_streamed"])
def test_bus_proof_json_matches_reference(proofs, which):
    tjson = proofs[0] if which == "prove" else proofs[1]
    assert json.dumps(tjson) == json.dumps(proofs[2])


def test_each_verifier_accepts_the_others_proof(proofs):
    tjson, _, jjson = proofs
    assert tstark.verify(BusAir(), tser.proof_from_json(jjson), CFG,
                         device="cpu")
    assert jstark.verify(JBusAir(), jser.proof_from_json(tjson), JCFG)


@pytest.mark.parametrize("corrupt", [dict(corrupt_row=20),
                                     dict(corrupt_addr=30)],
                         ids=["tampered_read", "unwritten_address"])
def test_bad_bus_traffic_fails_the_prover(corrupt):
    air = BusAir(**corrupt)
    with pytest.raises(AssertionError):
        tstark.prove(air, air.build_trace(), CFG, device="cpu")


def test_bus_proof_not_transferable(proofs):
    other = BusAir(corrupt_addr=30)   # different preprocessed commitment
    assert not tstark.verify(other, tser.proof_from_json(proofs[0]), CFG,
                             device="cpu")

"""Both GRANDPA justification cells' statements on the CPU at a small size.

`header_range_256.justification` at 4 authorities runs through the
harness, and its forged statement is rejected, which is the verdict
expected, and the reference's verdict agrees.  `zk_justification_300
.ladder` is cut to one signature a chunk (2^10 rows): its statements are
real signatures of the chain's justification, the reference's trace equals
the program's, and `compare` counts what differs.  No ladder is proved on
the CPU: an nbits=253 chunk takes minutes there.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time

import numpy as np

from conftest import ROOT, spec
from prover_bench import harness
from prover_bench.statements import (ed25519_ladder_chunks,
                                     grandpa_justification)

SEED = 2 ** 31 + 7919


def _config(name: str) -> dict:
    conf = next(c for c in spec()["configs"] if c["name"] == name)
    with open(os.path.join(ROOT, conf["file"])) as f:
        return json.load(f)


def test_justification_cell_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORX_VK_CACHE", str(tmp_path / "vk"))
    s = copy.deepcopy(spec())
    entry = next(c for c in s["configs"] if c["name"] == "header_range_256")
    entry["file"] = "header_range_256.json"
    (tmp_path / entry["file"]).write_text(json.dumps(_config_at(4)))
    r = harness.run_cell(str(tmp_path), s, "header_range_256.justification",
                         SEED, 0.0, False, "cpu", time.perf_counter())
    assert r["correct"] and (r["attempted"], r["failed"]) == (1, 0)
    assert r["checks"]["verdict_diff"]["value"] == 0
    assert set(r["metrics"]) == {"verify_s", "setup_s"}


def test_forged_justification_is_rejected_and_not_failed():
    with open(os.path.join(ROOT, "prover_bench", "traffic",
                           "justification.json")) as f:
        traffic = json.load(f)
    st = grandpa_justification.Statements(_config_at(4), traffic, SEED,
                                          "cpu")
    slot = traffic["forged_slot"]
    for i in (slot - 1, slot):
        inp = st.inputs(i)
        out = st.prove(inp, None)
        assert st.verify(inp, out)              # the verdict expected
        kept = st.keep(out)
        assert kept["verdict"] == (i != slot)
        assert st.compare(kept, st.reference(inp)) == {"verdict_diff": 0}


def test_a_check_without_the_signatures_is_not_correct(monkeypatch):
    """The control of `verdict_diff`: the reference with the signature
    check taken out (the threshold, commitment and precommit alone, as a
    gateway that trusted a host pre-check would run) passes the forged
    justification, and the comparison refuses it."""
    from prover_bench.reference import ed25519

    with open(os.path.join(ROOT, "prover_bench", "traffic",
                           "justification.json")) as f:
        traffic = json.load(f)
    st = grandpa_justification.Statements(_config_at(4), traffic, SEED,
                                          "cpu")
    inp = st.inputs(traffic["forged_slot"])
    truth = st.reference(inp)
    assert truth == {"verdict": False}
    monkeypatch.setattr(ed25519, "verify", lambda *a: True)
    control = st.reference(inp)
    assert st.compare(control, truth) == {"verdict_diff": 1}


def _config_at(authorities: int) -> dict:
    return dict(_config("header_range_256"),
                max_authority_set_size=authorities)


@dataclasses.dataclass
class _Proof:
    caps: list
    rest: list


def test_ladder_statements_trace_and_compare():
    from prover_bench.reference.ed25519_ladder_air import Ed25519LadderAir

    config = dict(_config("zk_justification_300"), max_ladder_log_n=10,
                  max_authority_set_size=3, signers=3)
    with open(os.path.join(ROOT, "prover_bench", "traffic",
                           "ladder.json")) as f:
        traffic = json.load(f)
    st = ed25519_ladder_chunks.Statements(config, traffic, SEED, "cpu")
    assert (st.per_chunk, st.chunks) == (1, 3)
    inp = st.inputs(4)                           # justification 1, chunk 1
    assert inp["sigs"] == st.justification_sigs(1)[1:2]
    assert st.inputs(1)["sigs"] != inp["sigs"]
    air = st._air.Ed25519LadderAir(inp["sigs"], nbits=st.nbits)
    assert air.log_n == 10
    trace = air.build_trace()
    ref_trace = Ed25519LadderAir(inp["sigs"], nbits=st.nbits).build_trace()
    proof = _Proof([[1, 2], [3, 4]], [5])
    kept = st.keep({"trace": trace, "proof": proof})
    same = st.compare(kept, {"trace": ref_trace, "proof": proof})
    assert same == {"trace_diff": 0, "proof_diff": 0}
    ref_trace[7, 3] ^= np.uint64(1)
    other = st.compare(kept, {"trace": ref_trace,
                              "proof": _Proof([[1, 2], [3, 5]], [5, 6])})
    assert other == {"trace_diff": 1, "proof_diff": 2}

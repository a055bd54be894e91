"""The window's accounting (statements started, the overshoot, the result
line's keys) with a stand-in traffic kind, and the device trace cut at
span boundaries on a synthetic trace."""

from __future__ import annotations

import time

import pytest

from prover_bench import devtrace, harness, spans


class Sleepy:
    """A traffic kind whose statements take `STEP` seconds to prove."""

    STEP = 0.05
    checks = {"answer_diff": 0}

    def __init__(self, config, traffic, seed, device):
        self.seed = seed

    def inputs(self, i):
        return {"i": i}

    def prove(self, inp, rec):
        time.sleep(self.STEP)
        return {"answer": inp["i"] * 2}

    def verify(self, inp, out):
        return True

    def keep(self, out):
        return dict(out)

    def reference(self, inp, fri=None):
        return {"answer": inp["i"] * 2}

    def compare(self, kept, ref):
        return {"answer_diff": int(kept["answer"] != ref["answer"])}


@pytest.fixture
def sleepy(tiny, monkeypatch):
    monkeypatch.setattr(harness, "statements_module",
                        lambda kind: type("M", (), {"Statements": Sleepy}))
    return tiny


@pytest.mark.parametrize("seconds", [0.0, 0.12, 0.3])
def test_window_statements_and_overshoot(sleepy, seconds):
    root, s = sleepy
    t0 = time.perf_counter()
    r = harness.run_cell(root, s, "header_range_256.roots", 7, seconds,
                         False, "cpu", t0)
    # no statement starts after `seconds`; the first always does
    n = r["attempted"]
    assert n >= 1
    assert (n - 1) * Sleepy.STEP <= seconds + 0.02
    assert n * Sleepy.STEP >= seconds - 0.02
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] and r["failed"] == 0
    assert set(r["metrics"]) == {"prove_s", "verify_s", "setup_s"}
    assert r["metrics"]["prove_s"]["value"] == pytest.approx(Sleepy.STEP,
                                                             abs=0.02)
    assert r["checks"] == {"rejected": {"value": 0, "limit": 0},
                           "answer_diff": {"value": 0, "limit": 0}}


def test_a_wrong_answer_is_not_correct(sleepy, monkeypatch):
    root, s = sleepy
    monkeypatch.setattr(Sleepy, "reference",
                        lambda self, inp, fri=None: {"answer": -1})
    r = harness.run_cell(root, s, "header_range_256.roots", 7, 0.0, False,
                         "cpu", time.perf_counter())
    assert not r["correct"]
    assert r["checks"]["answer_diff"] == {"value": 1, "limit": 0}


def test_a_statement_that_raises_is_failed(sleepy, monkeypatch):
    root, s = sleepy

    def boom(self, inp, rec):
        raise AssertionError("planted")

    monkeypatch.setattr(Sleepy, "prove", boom)
    r = harness.run_cell(root, s, "header_range_256.roots", 7, 0.0, False,
                         "cpu", time.perf_counter())
    assert not r["correct"] and r["failed"] == r["attempted"] == 1
    assert "prove_s" not in r["metrics"]


def test_device_trace_cut_at_markers():
    """Two nested spans; ops inside each; gaps charged to the innermost
    span open across them."""
    rec = spans.Recorder()
    rec.marker = lambda: None
    with rec.span("prove"):
        with rec.span("poseidon"):
            pass
    M = "marker"
    # boundaries: open prove, open poseidon, close poseidon, close prove
    ops = [(0, 10, M),
           (20, 30, "a"),            # in prove, 10 ns idle before
           (30, 40, M),              # open poseidon
           (50, 80, "b"), (70, 90, "c"),   # overlapping ops in poseidon
           (100, 110, M),            # close poseidon
           (110, 130, "a"),
           (150, 160, M)]            # close prove
    idle = devtrace.attribute(ops, M, rec.boundaries, rec.spans)
    prove, pos = rec.spans
    assert pos.dev_s == pytest.approx(60e-9)
    assert pos.kernel_s == pytest.approx(50e-9)
    assert pos.busy_s == pytest.approx(40e-9)
    assert prove.dev_s == pytest.approx(140e-9)
    assert prove.kernel_s == pytest.approx(80e-9)
    assert prove.busy_s == pytest.approx(70e-9)
    assert prove.kernels == pytest.approx({"a": 30e-9, "b": 30e-9,
                                           "c": 20e-9})
    assert idle == pytest.approx({"prove": 30e-9, "prove/poseidon": 20e-9})


def test_markers_that_do_not_match_read_nothing():
    rec = spans.Recorder()
    rec.marker = lambda: None
    with rec.span("prove"):
        pass
    assert devtrace.attribute([(0, 1, "m")], "m", rec.boundaries,
                              rec.spans) is None

"""The check that decides `correct`, at CPU size: the reference agrees with
the program; the control (one query fewer) and each fault the cells can
have, planted under the timed path, come out as not correct.

Faults: an answer altered where it is produced (a final FRI coefficient),
half of the batch left out (half of every committed matrix's rows, or the
polynomial's second extension row, zeroed before the program works on
them), and a step that returns its state unchanged (an FRI fold that hands
back its input's first half).
"""

from __future__ import annotations

import time

import pytest
import torch

from prover_bench import control, harness

CELLS = ["header_range_256.roots", "rotate_300.machine_fri"]


def run(tiny, cell, trace=False):
    root, s = tiny
    return harness.run_cell(root, s, cell, 2 ** 31 + 977, 0.0, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_program(tiny, cell):
    r = run(tiny, cell)
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0 for c in r["checks"].values())


def test_a_traced_cpu_run_reads_spans_and_no_device_metric(tiny):
    r = run(tiny, "header_range_256.roots", trace=True)
    assert r["correct"]
    got = set(r["metrics"])
    assert {"trace_build_s", "commit_s", "fri_s", "poseidon_s",
            "ntt_s"} <= got
    # readers that find no device trace return nothing, never a 0 share
    assert not got & {"poseidon_roofline", "ntt_roofline",
                      "device_idle_pct.prove", "device_idle_pct.verify"}
    assert "busy_s" not in r["device"] and "breakdown" not in r


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_refused(tiny, cell):
    root, s = tiny
    got = control.readings(root, s, cell, 5, "cpu")
    assert got["control"]["proof_diff"] > 0
    assert got["control_rejected"]


def _altered_final(monkeypatch):
    from vectorx_tpu_torch.fri import fri

    orig = fri.fri_final_coeffs

    def altered(c, cur_shift, final_len):
        ok, coeffs = orig(c, cur_shift, final_len)
        coeffs[0] = ((coeffs[0][0] + 1) % (2 ** 64 - 2 ** 32 + 1),
                     coeffs[0][1])
        return ok, coeffs

    monkeypatch.setattr(fri, "fri_final_coeffs", altered)


def _half_batch(monkeypatch, cell):
    if cell.startswith("header_range"):
        from vectorx_tpu_torch.stark import stages

        orig = stages.commit_rows

        def half(rows, **kw):
            rows = rows.clone()
            rows[rows.shape[0] // 2:] = 0
            return orig(rows, **kw)

        monkeypatch.setattr(stages, "commit_rows", half)
    else:
        from vectorx_tpu_torch import ntt

        orig = ntt.coset_lde

        def half(coeffs, rate_bits, *a, **kw):
            coeffs = coeffs.clone()
            coeffs[coeffs.shape[0] // 2:] = 0
            return orig(coeffs, rate_bits, *a, **kw)

        monkeypatch.setattr(ntt, "coset_lde", half)


def _unchanged_fold(monkeypatch):
    from vectorx_tpu_torch.fri import fri

    def unchanged(c, beta, cur_log, cur_shift):
        h = c[0].shape[0] // 2
        return c[0][:h].clone(), c[1][:h].clone()

    monkeypatch.setattr(fri, "fri_fold", unchanged)


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch",
                                   "unchanged_state"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    if fault == "altered_answer":
        _altered_final(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch, cell)
    else:
        _unchanged_fold(monkeypatch)
    torch.manual_seed(0)
    r = run(tiny, cell)
    assert not r["correct"], r["checks"]

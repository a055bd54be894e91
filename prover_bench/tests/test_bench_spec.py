"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each entry names, and the chip time a full check takes."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
# no key of `reduced` may name a width
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|per_tok|width|columns|bytes)")


def test_keys_and_sizes():
    s = spec()
    assert set(s) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(s["paths"]) <= 16 and all(
        PATH.match(p) and ".." not in p.split("/") and not p.startswith("/")
        for p in s["paths"])
    assert 1 <= len(s["command"]) <= 32
    assert all(TEXT.match(w) for w in s["command"])
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (s["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_command_names_only_files_under_paths():
    s = spec()
    for word in s["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p.rstrip("/") + "/")
                       for p in s["paths"]), word


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_keys(section):
    s = spec()
    entries = s[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    allowed = {"configs": CONFIG_KEYS, "workloads": CELL_KEYS,
               "end_to_end": E2E_KEYS | {"workloads"},
               "per_layer": LAYER_KEYS | {"workloads"}}[section]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) <= allowed and set(e) >= (allowed - {"workloads"}), e
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), e[key]


def test_configs_and_cells():
    s = spec()
    files = [c["file"] for c in s["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in s["workloads"]}
    pairs = set()
    for c in s["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in s["paths"])
        assert c["source"].startswith("https://")
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
            assert key in config["reduced"] and key in config["source_values"]
    for w in s["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(ROOT, "prover_bench", "traffic",
                               w["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(ROOT, "prover_bench",
                                           "statements", kind + ".py"))
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= max(
        1, len(s["workloads"]) // 4)


def test_metrics():
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in s["end_to_end"]}
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        # each of its cells reports the end-to-end metric it moves
        assert set(m.get("workloads", cells)) <= reports[m["moves"]], m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in s["end_to_end"] + s["per_layer"]:
        assert os.path.exists(os.path.join(ROOT, "prover_bench", "metrics",
                                           m["name"] + ".py")), m["name"]
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for c in cells:
        assert sum(1 for m in s["end_to_end"]
                   if c in m.get("workloads", cells)) >= 2
        assert any(c in m.get("workloads", cells) for m in s["per_layer"])


@pytest.mark.parametrize("section", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(section):
    """Each metric's reader loads by its name and reads a run; a cell's
    twin of a metric (`<name>.<traffic>`) reads what its base reads."""
    from prover_bench import harness

    run = harness.Run(setup_s=3.0, prove_s=[1.0, 2.0], verify_s=[0.5],
                      peak_bytes=1 << 30)
    names = {m["name"] for m in spec()[section]}
    for name in names:
        r = harness.reader(name)
        assert callable(r.read) and isinstance(getattr(r, "SPANS", []), list)
        base = name.rsplit(".", 1)[0]
        if base in names | {m["name"] for m in spec()["end_to_end"]}:
            assert r.read(run) == harness.reader(base).read(run), name

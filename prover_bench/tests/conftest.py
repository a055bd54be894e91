"""Fixtures of the benchmark's CPU tests: tiny cells of both traffic kinds
and a card fixture that skips where torch sees no CUDA device."""

from __future__ import annotations

import copy
import json
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_FRI = {"rate_bits": 2, "cap_height": 1, "num_queries": 2,
            "final_poly_len": 4, "pow_bits": 1}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips where torch sees none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card")
    return "cuda"


def spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(root, spec) of the benchmark's cells cut to CPU size: 2-leaf trees
    and 2^8-row chunks (one node), a degree < 2^8 polynomial, 2 queries.
    The traffic files are the benchmark's own."""
    import torch

    torch.set_num_threads(2)
    monkeypatch.setenv("VECTORX_VK_CACHE", str(tmp_path / "vk"))
    s = copy.deepcopy(spec())
    for conf, sizes in (("header_range_256", {"tree_leaves": 2,
                                              "max_batch_log_n": 8}),
                        ("rotate_300", {"machine_log_n": 8})):
        entry = next(c for c in s["configs"] if c["name"] == conf)
        with open(os.path.join(ROOT, entry["file"])) as f:
            config = json.load(f)
        config.update(sizes, fri=TINY_FRI)
        entry["file"] = f"{conf}.json"
        (tmp_path / entry["file"]).write_text(json.dumps(config))
    return str(tmp_path), s

"""The roofline counts follow from shapes alone, whatever implements the
work: a Poseidon state's fixed cost, a transform's or an LDE's butterflies
and bytes, and the counters that read them from a call's arguments."""

from __future__ import annotations

import math

import pytest

from prover_bench import layers, roofline


class Shape:
    """A stand-in for a CUDA tensor: the counters read shapes only."""

    def __init__(self, *shape, cuda=True):
        self.shape = shape
        self.is_cuda = cuda

    def numel(self):
        return math.prod(self.shape)


def test_poseidon_cost():
    # 8 full rounds: 12 S-boxes of 4 products and a dense 12x12 MDS;
    # 22 partial rounds: one S-box and the sparse 23-product matrix;
    # one dense matrix left by the decomposition
    assert roofline.POSEIDON_PRODUCTS == 8 * (48 + 144) + 22 * 27 + 144
    assert roofline.poseidon_work(3) == (3 * 2274, 3 * 192)


def test_peaks():
    assert roofline.PEAK_INT32_MADS_PER_S == pytest.approx(1.67270e13,
                                                           rel=1e-4)
    assert roofline.PEAK_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("rows,log_n", [(1, 0), (299, 14), (2, 23)])
def test_transform_and_lde(rows, log_n):
    n = 1 << log_n
    assert roofline.transform_work(rows, log_n) == (
        rows * n // 2 * log_n, rows * n * 16)
    assert roofline.lde_work(rows, log_n, 3) == (
        rows * (8 * n) // 2 * log_n, rows * 9 * n * 8)


def test_which_bound_binds():
    ops, which = roofline.least_seconds(*roofline.poseidon_work(1 << 20))
    assert which == "ops"
    assert ops == pytest.approx(2274 * 4 * (1 << 20) / 1.6727e13, rel=1e-4)
    assert roofline.least_seconds(0, 3_350_000_000_000) == (1.0, "bytes")


def test_counters_read_shapes():
    assert layers.hash_states((Shape(1 << 17, 299),), {}) == {
        "states": (1 << 17) * 38}
    assert layers.compress_states((Shape(64, 4), Shape(64, 4)), {}) == {
        "states": 64}
    assert layers.permute_states((Shape(5, 7, 12),), {}) == {"states": 35}
    assert layers.transform_shape((Shape(6, 1 << 17), 17, True), {}) == {
        "rows": 6, "log_n": 17, "rate_bits": 0, "lde": False}
    assert layers.lde_shape((Shape(2, 1 << 20), 3), {}) == {
        "rows": 2, "log_n": 20, "rate_bits": 3, "lde": True}
    # host tensors do no device work
    assert layers.permute_states((Shape(9, 12, cuda=False),), {}) == {
        "states": 0}
    assert layers.lde_shape((Shape(2, 64, cuda=False), 3), {}) == {}


def test_spans_per_statement_and_idle():
    from prover_bench.spans import Span

    def span(sid, layer, path, sec, **dev):
        s = Span(sid=sid, layer=layer, parent=None, path=path, t0=0.0,
                 t1=sec)
        for k, v in dev.items():
            setattr(s, k, v)
        return s

    spans = [span(0, "prove", ("traced",), 10.0, traced=True, dev_s=10.0,
                  busy_s=2.5),
             span(1, "poseidon", ("traced", "prove"), 6.0),
             span(2, "poseidon", ("traced", "verify"), 1.0),
             span(3, "verify", ("traced",), 2.0, traced=True, dev_s=2.0,
                  busy_s=0.0)]
    assert layers.per_statement(spans, "poseidon", 2) == 3.0
    assert layers.per_statement(spans, "ntt", 2) is None
    assert layers.idle_pct(spans, "prove") == 75.0
    assert layers.idle_pct(spans, "verify") == 100.0

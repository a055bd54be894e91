#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vectorx_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its result and timing; any failed check raises,
so the script exits non-zero and prints no final line:

0. setup: needs a CUDA device; prints the card's name and power limit
   (nvidia-smi) and builds the NTT kernels from `vectorx_tpu_torch/csrc/`.
1. kernels against their plain torch versions on the card: the whole
   transform (forward, inverse, coset, LDE, round trip) at log_n in
   {1, 2, 5, 10, 13, 14, 16, 20, 23, 24} with batches, leading dims and
   non-canonical inputs, each kernel alone at the shapes the main path gives
   it, and median times at (8, 2^20), (4, 2^23), (1, 2^24).
2. the `entry()` twin on CUDA and on CPU: equal Merkle roots.
3. the main path at a real size and the production FRI config
   (`FriConfig()`: rate 3, 28 queries, 16 pow bits): FibonacciAir(log_n=21)
   and RangeCheckAir(log_n=20, bits=16, V=8), each proved on CUDA cold, warm
   and warm with per-stage timers, verified after each, and rejected after
   tampering; every kernel must have launched during the proofs.
4. CUDA against CPU proofs at log_n=8: identical proof JSON.

The last lines are a JSON record of the kernels, the card's name and power
limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Median time of `fn` in ms over `reps` runs after one warm-up, by
    CUDA events."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(got, want) -> int:
    """Largest |got - want| over canonical field values (exact ints)."""
    from vectorx_tpu_torch.field import goldilocks as gl

    a = gl.to_u64(got).reshape(-1)
    b = gl.to_u64(want).reshape(-1)
    bad = (a != b).nonzero()[0]
    return max((abs(int(a[i]) - int(b[i])) for i in bad[:1000]), default=0)


def random_field(rng, shape, device):
    """Random u64 values with the non-canonical edge values planted."""
    import numpy as np

    from vectorx_tpu_torch.field import goldilocks as gl

    x = rng.integers(0, 2**64, size=shape, dtype=np.uint64).reshape(-1)
    edge = np.array([0, 1, gl.P - 1, gl.P, gl.P + 1, 2**64 - 2**32,
                     2**64 - 1], dtype=np.uint64)
    x[:min(len(edge), x.size)] = edge[:x.size]
    return gl.from_u64(x.reshape(shape), device)


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

SIZES = (1, 2, 5, 10, 13, 14, 16, 20, 23, 24)
TIMED = ((8, 20), (4, 23), (1, 24))


def phase_kernels(dev, card: str) -> dict:
    import numpy as np
    import torch

    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.ntt import (coset_intt, coset_ntt, cuda_ntt, intt,
                                       lde, ntt)

    ntt_mod = importlib.import_module("vectorx_tpu_torch.ntt.ntt")

    rng = np.random.default_rng(1)
    worst = 0

    def same(got, want, what):
        nonlocal worst
        err = max_abs_err(got, want)
        worst = max(worst, err)
        if err:
            raise AssertionError(f"{what}: kernel != plain (max err {err})")

    for log_n in SIZES:
        t0 = time.perf_counter()
        shapes = [(1, 1 << log_n), (3, 1 << log_n)]
        if log_n <= 16:
            shapes.append((2, 3, 1 << log_n))
        for shape in shapes:
            x = random_field(rng, shape, dev)
            for inverse in (False, True):
                for shift in (None, gl.GENERATOR):
                    got = cuda_ntt.transform(x, log_n, inverse, shift)
                    want = cuda_ntt.transform_plain(x, log_n, inverse, shift)
                    same(got, want, f"log_n={log_n} {shape} inv={inverse} "
                                    f"shift={shift}")
            back = intt(ntt(x))
            if not bool((gl.canonicalize(back) == gl.canonicalize(x)).all()):
                raise AssertionError(f"log_n={log_n}: intt(ntt(x)) != x")
            back = coset_intt(coset_ntt(x))
            if not bool((gl.canonicalize(back) == gl.canonicalize(x)).all()):
                raise AssertionError(f"log_n={log_n}: coset round trip")
        torch.cuda.synchronize()
        log(f"phase 1: transform log_n={log_n} {shapes} fwd/inv/coset "
            f"== plain, round trips ok ({time.perf_counter() - t0:.2f} s)")

    for log_n, rate in ((10, 3), (16, 3), (21, 3)):
        x = random_field(rng, (2, 1 << log_n), dev)
        got = lde(x, rate)
        c = cuda_ntt.transform_plain(x, log_n, True)
        c = torch.nn.functional.pad(c, (0, (1 << (log_n + rate)) - (1 << log_n)))
        want = cuda_ntt.transform_plain(c, log_n + rate, False, gl.GENERATOR)
        same(got, want, f"lde log_n={log_n}")
    log("phase 1: lde log_n in (10, 16, 21) at rate 3 == plain")

    # each kernel alone at the main path's shapes (the 2^24 four-step)
    S = cuda_ntt.S_BITS
    a, c = cuda_ntt.split(24)
    R, C = 1 << a, 1 << c
    x = random_field(rng, (1, 1 << 24), dev)
    steps = cuda_ntt.plan(x, 24, False, gl.GENERATOR, S)
    k1_args = steps[0][1:]                  # K1 down the columns, with coset
    k2_args = steps[1][1:]                  # K2 with the w^(c·k1) twiddle
    y1 = cuda_ntt.ntt_rows(x, *k1_args)
    same(y1, cuda_ntt.ntt_rows_plain(x, *k1_args), "ntt_rows_smem alone")
    y2 = cuda_ntt.twiddle_transpose(y1, *k2_args)
    same(y2, cuda_ntt.twiddle_transpose_plain(y1, *k2_args),
         "ntt_twiddle_transpose alone")
    # times: K1 on 2^12 contiguous rows of 2^12 against the plain
    # stage-by-stage transform; K2 against its plain version
    rows = x.reshape(R, C)
    rows_args = (R, c, (1, 0, 1, C), ntt_mod.twiddles(c, False, dev), None,
                 (1, 0, 1), None, 1)
    same(cuda_ntt.ntt_rows(rows, *rows_args),
         cuda_ntt.transform_plain(rows, c, False), "ntt_rows_smem rows")
    k1_ms = cuda_ms(lambda: cuda_ntt.ntt_rows(rows, *rows_args))
    k1_plain = cuda_ms(lambda: cuda_ntt.transform_plain(rows, c, False))
    k2_ms = cuda_ms(lambda: cuda_ntt.twiddle_transpose(y1, *k2_args))
    k2_plain = cuda_ms(lambda: cuda_ntt.twiddle_transpose_plain(y1, *k2_args))
    log(f"phase 1: ntt_rows_smem (2^{a} rows x 2^{c}) {k1_ms:.3f} ms, plain "
        f"{k1_plain:.3f} ms; ntt_twiddle_transpose (2^{a} x 2^{c}) "
        f"{k2_ms:.3f} ms, plain {k2_plain:.3f} ms  [{card}]")

    for b, log_n in TIMED:
        x = random_field(rng, (b, 1 << log_n), dev)
        kms = cuda_ms(lambda: cuda_ntt.transform(x, log_n, False))
        pms = cuda_ms(lambda: cuda_ntt.transform_plain(x, log_n, False), 3)
        log(f"phase 1: NTT ({b}, 2^{log_n}) kernels {kms:.3f} ms, plain "
            f"{pms:.3f} ms, speedup {pms / kms:.2f}x  [{card}]")
    torch.cuda.synchronize()
    return {"worst": worst, "k1_ms": k1_ms, "k1_plain": k1_plain,
            "k2_ms": k2_ms, "k2_plain": k2_plain}


# ---------------------------------------------------------------------------
# Phase 3: the main path at a real size
# ---------------------------------------------------------------------------

class StageTimer:
    """Seconds per prover stage (and in all NTTs and Poseidon permutations,
    which run inside the stages), by wrapping each with synchronizing host
    timers while active."""

    def __init__(self):
        from vectorx_tpu_torch.hash import poseidon
        from vectorx_tpu_torch.stark import prover, stages

        ntt_mod = importlib.import_module("vectorx_tpu_torch.ntt.ntt")
        self.targets = [
            (stages, "commit_rows"), (prover, "aux_witness"),
            (prover, "_composition"), (stages, "quotient_coeffs"),
            (stages, "deep_eval_groups"), (stages, "deep_compose"),
            (stages, "fri_commit_layer"), (stages, "fri_fold"),
            (stages, "fri_final_coeffs"), (stages, "grind"),
            (stages, "open_positions"), (ntt_mod, "_transform"),
            (poseidon, "permute")]
        self.times = {}
        self._saved = []

    def __enter__(self):
        import torch

        for mod, attr in self.targets:
            orig = getattr(mod, attr)

            def wrapped(*a, _orig=orig, _name=attr, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                torch.cuda.synchronize()
                self.times[_name] = (self.times.get(_name, 0.0)
                                     + time.perf_counter() - t0)
                return out

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def summary(self) -> str:
        return ", ".join(f"{k} {v:.3f} s" for k, v in
                         sorted(self.times.items(), key=lambda kv: -kv[1]))


def prove_and_check(name, air, cfg, dev, card):
    import torch

    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.stark import prove, verify
    from vectorx_tpu_torch.stark.serialize import (proof_from_json,
                                                   proof_to_json)

    trace = air.build_trace()
    timer = StageTimer()
    for run in ("cold", "warm", "warm, stage-timed"):
        before = sum(cuda_ntt.LAUNCHES.values())
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        if run == "warm, stage-timed":
            with timer:
                proof = prove(air, trace, cfg, device=dev)
        else:
            proof = prove(air, trace, cfg, device=dev)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        grew = sum(cuda_ntt.LAUNCHES.values()) - before
        if grew <= 0:
            raise AssertionError(f"{name}: no NTT kernel launched in prove")
        peak = torch.cuda.max_memory_allocated(dev)
        t0 = time.perf_counter()
        ok = verify(air, proof, cfg, device=dev)
        t_verify = time.perf_counter() - t0
        if not ok:
            raise AssertionError(f"{name}: verify rejected the proof ({run})")
        log(f"phase 3: {name} {run}: prove {t_prove:.3f} s, verify "
            f"{t_verify:.3f} s, peak device memory {peak / 2**30:.3f} GiB, "
            f"{grew} kernel launches  [{card}]")
    log(f"phase 3: {name} stage seconds (NTT and Poseidon run inside the "
        f"stages): {timer.summary()}  [{card}]")
    d = proof_to_json(proof)
    bad = proof_from_json(d)
    c0, c1 = bad.trace_at_zeta[0]
    bad.trace_at_zeta[0] = ((c0 + 1) % gl.P, c1)
    if verify(air, bad, cfg, device=dev):
        raise AssertionError(f"{name}: tampered opened value accepted")
    bad = proof_from_json(d)
    c0, c1 = bad.fri_proof.final_coeffs[0]
    bad.fri_proof.final_coeffs[0] = ((c0 + 1) % gl.P, c1)
    if verify(air, bad, cfg, device=dev):
        raise AssertionError(f"{name}: tampered FRI final coefficient "
                             f"accepted")
    log(f"phase 3: {name}: tampered opening and FRI final coefficient "
        f"rejected")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    import numpy as np

    from vectorx_tpu_torch import entry
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.stark import (FibonacciAir, RangeCheckAir,
                                         StarkConfig, prove)
    from vectorx_tpu_torch.stark.serialize import proof_to_json

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 0: card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_ntt.load()
    log(f"phase 0: kernels built from vectorx_tpu_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {cuda_ntt.BUILD_INFO['seconds']:.2f} s)")
    for line in cuda_ntt.BUILD_INFO["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase 0: ptxas: {line.strip()}")

    k = phase_kernels(dev, card)

    t0 = time.perf_counter()
    r_cuda = entry.root(dev)
    r_cpu = entry.root("cpu")
    if r_cuda != r_cpu:
        raise AssertionError(f"entry twin: CUDA root {r_cuda} != CPU {r_cpu}")
    log(f"phase 2: entry twin root {r_cuda} equal on CUDA and CPU "
        f"({time.perf_counter() - t0:.2f} s)")

    cfg = StarkConfig(fri=FriConfig())
    rng = np.random.default_rng(0)
    values = rng.integers(0, 1 << 16, size=(8, (1 << 20) - 1),
                          dtype=np.uint64)
    statements = [("FibonacciAir(log_n=21)", FibonacciAir(log_n=21)),
                  ("RangeCheckAir(log_n=20, bits=16, V=8)",
                   RangeCheckAir(20, 16, values))]
    for name in cuda_ntt.LAUNCHES:
        cuda_ntt.LAUNCHES[name] = 0
    for name, air in statements:
        prove_and_check(name, air, cfg, dev, card)
    launches = dict(cuda_ntt.LAUNCHES)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    log(f"phase 3: kernel launches on the main path: {launches}")

    small = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=1,
                                      num_queries=12, final_poly_len=4,
                                      pow_bits=0))
    vals = np.random.default_rng(11).integers(0, 1 << 6, size=(4, 255),
                                              dtype=np.uint64)
    for name, air in (("FibonacciAir(log_n=8)", FibonacciAir(log_n=8)),
                      ("RangeCheckAir(log_n=8, bits=6, V=4)",
                       RangeCheckAir(8, 6, vals))):
        t0 = time.perf_counter()
        a = json.dumps(proof_to_json(prove(air, air.build_trace(), small,
                                           device=dev)))
        b = json.dumps(proof_to_json(prove(air, air.build_trace(), small,
                                           device="cpu")))
        if a != b:
            raise AssertionError(f"{name}: CUDA and CPU proofs differ")
        log(f"phase 4: {name}: CUDA and CPU proof JSON identical "
            f"({len(a)} bytes, {time.perf_counter() - t0:.2f} s)")

    kernels = [
        {"name": "ntt_rows_smem", "route": "cuda",
         "source": "vectorx_tpu_torch/csrc/ntt.cu",
         "replaces": "vectorx_tpu/ntt/pallas_ntt.py:159",
         "launches": launches["ntt_rows_smem"], "max_abs_err": k["worst"],
         "ms": k["k1_ms"], "plain_ms": k["k1_plain"]},
        {"name": "ntt_twiddle_transpose", "route": "cuda",
         "source": "vectorx_tpu_torch/csrc/ntt.cu",
         "replaces": "vectorx_tpu/ntt/pallas_ntt.py:273",
         "launches": launches["ntt_twiddle_transpose"],
         "max_abs_err": k["worst"], "ms": k["k2_ms"],
         "plain_ms": k["k2_plain"]},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

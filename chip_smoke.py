#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`vectorx_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py               # phases 0-12
    python3 chip_smoke.py --succinct    # phases 0-2, 13 and 14

Phases, each printed with its result and timing; any failed check raises,
so the script exits non-zero and prints no final line:

0. setup: needs a CUDA device; prints the card's name and power limit
   (nvidia-smi) and builds the NTT kernels from `vectorx_tpu_torch/csrc/`.
1. kernels against their plain torch versions on the card: the whole
   transform (forward, inverse, coset, LDE, round trip) at log_n in
   {1, 2, 5, 10, 13, 14, 16, 17, 20, 23, 24} with batches, leading dims
   and non-canonical inputs; every pair of u64 edge values and rows of
   edge values; the header_range path's own transforms (a Blake2b chunk's
   2664-row trace iNTT at 2^14 and its coset LDE to 2^17, whole and in the
   prover's row blocks); each kernel alone at every step of the 2^24, the
   (512, 2^17) and (50, 2^20) coset and the (2664, 2^14) inverse plans
   ((50, 2^20): the aggregated rotate machine's widest column group on one
   coset); then median times of each step and of the whole transforms at
   (8, 2^20), (4, 2^23), (1, 2^24), (2664, 2^14), (512, 2^17) and
   (50, 2^20), each beside its bound (bytes or integer multiply-adds, at
   the SM clock read under load), its share of the bound, its plain
   version and the time recorded for the first version of the kernels.
2. the `entry()` twin on CUDA and on CPU: equal Merkle roots; Poseidon's
   dense matvecs as float64 limb matmuls equal to the field-op products
   on 2^20 random states, each timed, and a whole permutation timed.
3. the STARK prover path at the production FRI config (`FriConfig()`:
   rate 3, 28 queries, 16 pow bits): FibonacciAir(log_n=16) and
   RangeCheckAir(log_n=15, bits=14, V=8), each proved on CUDA with
   per-stage timers, verified, and rejected after tampering; every kernel
   must have launched.
4. CUDA against CPU proofs at log_n=8: identical proof JSON for
   RangeCheckAir(8); the coset-streamed prover (`prove_streamed`) gives
   `prove`'s JSON on CUDA and the same JSON on CPU for the LogUp bus AIR
   of `tests/test_bus.py` and FibonacciAir(8); the machine proof of the
   FibonacciAir(3) aggregation (1047 rows, log_n 11) is identical on CUDA
   and CPU.
5. the byte hashes on the card: `blake2b_batch` over 4096 messages of
   random lengths up to 35,840 B against hashlib, `sha256_batch` against
   hashlib, the SHA-256 Merkle root of 256 leaves against the host root.
6. batched ed25519 on the card: 300 keys, 240 signed, accepted; one forged
   signature rejected; the CPU run agrees.
7. the header_range statement with the reference deployment's widths (300
   authorities, mixed headers of ~360-2100 B) at tree 16 (the deployment
   runs 256): the non-ZK `HeaderRangeCircuit.run` on the card equal to
   `DummyHeaderRange`'s output; then the ZK header_range as a user drives
   it, through the port's contract and gateway (`make_gateway(zk=True,
   device=cuda)`): `request_header_range`, then `fulfill_next`, which
   proves once (`prove_header_range_zk` at the production FRI config) and
   verifies once on the card before the commit; the contract stores the
   dummy's header hash and commitments; a tampered header hash and a
   tampered SHA chunk proof are rejected, and a tampered output with the
   same proof reverts the commit; every kernel must have launched on the
   gateway path.
8. the tree=2 ZK statement of the tests at their small config: every
   component proof's JSON on CUDA identical to the JAX reference's proof
   of the same statement (the golden fixtures under `tests/fixtures/`).
9. the rotate through the port's contract and gateway at 300 authorities
   (`request_rotate`, `fulfill_next`: the stored next-set hash equals
   `DummyRotate`'s); then the aggregated ZK rotate at `StarkConfig()`:
   `prove_rotate_zk` / `verify_rotate_zk` (output equal to
   `DummyRotate`'s), then `aggregate_rotate_proof`, one streamed machine
   proof of 724,556 rows (log_n 20), with its stage times, peak device
   memory and the host memory of its trees; `verify_rotate_zk_aggregated`
   accepts, and only then a tampered header hash and a tampered FRI final
   coefficient are rejected; every kernel must have launched on the path.
10. the port's services and CLI: the operator loop of
   `tests/test_services.py` (75 blocks, epochs of 20, tree 16) through the
   non-ZK gateway on the card up to block 70, across three rotations, with
   the state and events of the same loop through the dummy gateway; then
   `python -m vectorx_tpu_torch.bin.header_range_256 prove input.json` as
   a process on its default device and the fixture backend, at tree 256,
   its output equal to `DummyHeaderRange(256)`'s; the same with
   `VECTORX_DEVICE=cuda` and no visible CUDA device exits non-zero (that
   process runs beside the operator loop: it uses no card).
11. in a second process on the card (`--phase-11 <dir>`), started as soon
   as phase 7 has its proof and run beside phases 8-10: phase 7's
   component proofs folded into one machine proof by
   `aggregate_header_range_proof` (469,783 rows, log_n 19, at
   `StarkConfig(fri=FriConfig())`), with its stage times, peak device
   memory and launches; `verify_header_range_zk_aggregated` accepts, then
   rejects a tampered header hash, a tampered FRI final coefficient and
   the state and data trees' child statements swapped.  Then
   `Blake2bAir(bind="public")` over the first 4 of phase 7's headers and
   `Sha256Air(bind="public")` over 8 of its state-tree nodes, proved and
   verified on the card, a changed message limb and digest limb
   rejected, `public_shape`'s constant columns equal to the full AIR's,
   and their proof JSON equal to the CPU's proofs of the same statements;
   and `prove_merkle_root` over phase 7's 16 state roots, verified, its
   root equal to `sha256_merkle_root`'s, a tampered root rejected.  The
   parent waits for the process before its summary; a non-zero exit, a
   missing result line or a timeout fails the script.
12. in a third process on the card (`--phase-12 <dir>`), started after
   phase 2 and run beside phases 3-11: the in-ZK GRANDPA justification of
   the fixture chain at 20 authorities (16 signers) by
   `prove_justification_zk` at `StarkConfig(fri=FriConfig())`: the
   20-pubkey commitment chain, one SHA-512 chunk of the 16 challenge
   messages (log_n 12) and one ladder chunk of the 16 signatures at
   nbits=253 (log_n 14, 3520 columns; one of the 15 ladder chunks of the
   deployment's 300 authorities), with its stage times, Poseidon share,
   peak device memory and launches; `verify_justification_zk` accepts,
   then rejects a tampered challenge digest, a forged S in the statement,
   a `validator_signed` list under the threshold and a tampered FRI final
   coefficient of the ladder proof.  Then the nbits=8 ladder statement of
   `tests/test_ed25519_ladder.py` at that test's config, proved and
   verified on the card, a forged scalar and pubkey rejected.  The
   SHA-512 chunk's and the nbits=8 ladder's proof JSON equal the CPU's
   proofs of the same statements.  The parent waits for the process as
   for phase 11's.

With `--succinct` the script runs phases 0-2 and then, instead of phases
3-12, the succinct product pipeline (each statement takes longer on the
card than phases 3-12 together, so the two do not fit one 1200 s run):

13. in a process of its own on the card (`--phase-13 <dir>`, its caches in
   `<dir>`), started after phase 2: the succinct header_range (one
   machine proof) of phase 7's header mix at tree 2 and 4 authorities, at
   `StarkConfig(fri=FriConfig())`, through the port's contract and
   `make_gateway(zk="succinct")`: `request_header_range`, then
   `fulfill_next`, which proves once and
   verifies once on the card; the contract stores the dummy's header hash
   and commitments.  The prove's stage seconds (each child proof, the
   tape, `compile_tape`, the machine's trace and constant columns, the
   machine proof with its Poseidon share and whether it streamed), peak
   device memory and launches; then `verify_header_range_succinct` from a
   cold program and key cache accepts, and only then a tampered output
   through the gateway reverts the commit and a `validator_signed` list
   under the threshold and a tampered FRI final coefficient of the machine
   proof are rejected.
14. in another process on the card (`--phase-14 <dir>`), beside phase 13:
   the succinct rotate of the same chain's set 1 through
   `request_rotate` and `fulfill_next` on a `make_gateway(zk="succinct")`
   (the stored next-set hash equals `DummyRotate`'s), with the same stage
   seconds, peak memory and launches; the gateway's warm verify accepts,
   then a proof whose output carries another new-set hash (its statement
   program derived anew) and a tampered FRI final coefficient are
   rejected.
   Each rejection must come from the check it names: the STARK verify
   returning False, or the host bookkeeping before it; a verifier that
   rejects because something under it raised fails the phase.

The CPU sides of phases 4, 6 and 11 run in a second process
(`--host-checks <dir>`) and phase 12's in a third, at a lower priority
(`--host-justification <dir>`), both started before phase 1.  Each phase ends with a
line of its seconds and when it started and ended since the start.  The
last lines are a JSON record of the kernels, the card's name and power
limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import json
import os
import random
import shutil
import statistics
import subprocess
import sys
import tempfile
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


# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet): device
# memory at 3.35 TB/s; 32-bit integer multiply-adds on 64 lanes per SM per
# clock, 132 SMs, at the SM clock that nvidia-smi reads under load.
HBM_BYTES_PER_S = 3.35e12
SMS, INT_LANES = 132, 64
# a Goldilocks product: four 32x32->64 partial products, each two 32-bit
# multiply-adds (low and high word); its reduction and the butterfly's
# modular add and subtract take no multiply
GL_MUL_MADS = 8


def k1_mads(batch, C, log_n, col, tw, pre, post, twiddle, scale) -> int:
    """The 32-bit multiply-adds one K1 step needs: per column of length n,
    n/2·log2(n) - (n - 1) butterflies with a twiddle other than 1, plus
    one product per element for the coset power on load and one for the
    power or scale on store."""
    n = 1 << log_n
    products = (n * log_n) // 2 - n + 1
    products += n * ((pre is not None) + (post is not None or scale != 1))
    return GL_MUL_MADS * batch * C * products


def bound_ms(nbytes: int, mads: int, clock_mhz: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and multiply-adds over the integer issue rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = mads / (SMS * INT_LANES * clock_mhz * 1e6) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sm_clock_mhz(fn, reps: int) -> float:
    """The SM clock nvidia-smi reads while `reps` queued calls of `fn` keep
    the card busy."""
    import torch

    for _ in range(reps):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True)
    torch.cuda.synchronize()
    return float(out.stdout.strip().splitlines()[0])


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

SIZES = (1, 2, 5, 10, 13, 14, 16, 17, 20, 23, 24)
TIMED = ((8, 20), (4, 23), (1, 24))
# The first version of the kernels (K1 `ntt_rows_smem`, one element per
# thread and a barrier per radix-2 stage; K2 `ntt_twiddle_transpose`, which
# then also multiplied by the four-step twiddles): its recorded times at the
# same shapes on NVIDIA H100 80GB HBM3 at 700 W, one per run (PERF.md)
FIRST_MS = {
    "K1 (512, 2^17) column step": "1.596 / 1.683 ms",
    "K1 2^12 rows x 2^12": "0.498 / 0.530 / 0.502 / 0.491 ms",
    "K2 (512, 2^17)": "0.420 / 0.427 ms (twiddled)",
    "K2 2^12 x 2^12": "0.131 / 0.133 / 0.121 / 0.139 ms (twiddled)",
    "NTT (8, 2^20)": "0.642 / 0.593 / 0.618 / 0.592 ms",
    "NTT (4, 2^23)": "2.400 / 2.442 / 2.576 / 2.429 ms",
    "NTT (1, 2^24)": "1.274 / 1.328 / 1.312 / 1.316 ms",
}


def phase_kernels(dev, card: str) -> dict:
    import numpy as np
    import torch

    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.ntt import (coset_intt, coset_ntt, cuda_ntt, intt,
                                       lde, ntt)
    from vectorx_tpu_torch.recursion import machine
    from vectorx_tpu_torch.stark import blake2b_air, stages

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

    # the kernels' carry chains at the edges of u64: every pair of edge
    # values as a length-2 transform (its add and subtract), and rows made
    # only of edge values through the coset, twiddle and scale products
    e = np.array([0, 1, 2, 2**32 - 1, 2**32, gl.P - 1, gl.P, gl.P + 1, 2**63,
                  2**64 - 2**32, 2**64 - 2**32 - 1, 2**64 - 2**33, 2**33,
                  2**64 - 2, 2**64 - 1], dtype=np.uint64)
    pairs = gl.from_u64(np.stack(np.meshgrid(e, e), -1).reshape(-1, 2), dev)
    for log_n, x in ((1, pairs),
                     (8, gl.from_u64(rng.choice(e, (7, 1 << 8)), dev)),
                     (14, gl.from_u64(rng.choice(e, (3, 1 << 14)), dev))):
        for inverse in (False, True):
            for shift in (None, gl.GENERATOR):
                same(cuda_ntt.transform(x, log_n, inverse, shift),
                     cuda_ntt.transform_plain(x, log_n, inverse, shift),
                     f"edge values log_n={log_n} inv={inverse} shift={shift}")
    log(f"phase 1: edge values of u64 (all {len(e)}^2 pairs at log_n 1, "
        f"edge-only rows at 2^8 and 2^14) fwd/inv/coset == plain")

    for log_n, rate in ((10, 3), (16, 3), (21, 3)):
        x = random_field(rng, (2, 1 << log_n), dev)
        got = lde(x, rate)
        c = cuda_ntt.transform_plain(x, log_n, True)
        c = torch.nn.functional.pad(c, (0, (1 << (log_n + rate)) - (1 << log_n)))
        want = cuda_ntt.transform_plain(c, log_n + rate, False, gl.GENERATOR)
        same(got, want, f"lde log_n={log_n}")
    log("phase 1: lde log_n in (10, 16, 21) at rate 3 == plain")

    # the header_range path's transforms at its own widths: a 2^14-row
    # Blake2b chunk's trace iNTT (WIDTH, 2^14) and its coset LDE to 2^17
    # points, whole (`lde`) and in the row blocks `stages.coset_lde_rows`
    # hands the kernels, against the plain transform block by block
    t0 = time.perf_counter()
    rows_n, block = blake2b_air.WIDTH, stages.LDE_CHUNK_ELEMS >> 17
    x = random_field(rng, (rows_n, 1 << 14), dev)
    coeffs = stages.intt_rows(x)
    got = lde(x, 3)
    blocked = stages.lde_rows(coeffs, 3)
    for s in range(0, rows_n, block):
        c = cuda_ntt.transform_plain(x[s:s + block], 14, True)
        same(coeffs[s:s + block], c, f"intt ({rows_n}, 2^14) rows {s}+")
        c = torch.nn.functional.pad(c, (0, (1 << 17) - (1 << 14)))
        want = cuda_ntt.transform_plain(c, 17, False, gl.GENERATOR)
        same(got[s:s + block], want, f"lde ({rows_n}, 2^14) rows {s}+")
        same(blocked[s:s + block], want, f"lde_rows ({rows_n}) rows {s}+")
    del got, blocked, coeffs
    torch.cuda.synchronize()
    log(f"phase 1: intt ({rows_n}, 2^14) and lde to ({rows_n}, 2^17) at rate "
        f"3, whole and in blocks of {block} rows, == plain "
        f"({time.perf_counter() - t0:.2f} s)")

    # each kernel alone at every step of the main paths' four-step plans:
    # the first slice's 2^24 transform, the header_range path's (512, 2^17)
    # coset LDE block and its (2664, 2^14) trace iNTT, and the aggregated
    # rotate's per-coset transform of the machine's widest committed group
    # (its 50 constant columns at 2^20 rows, on coset 1 of 2^23)
    S = cuda_ntt.S_BITS
    m_rows, m_shift = machine.N_CONSTS, stages.coset_shift(1, 23)
    plans = {"2^24": (1, 24, False, gl.GENERATOR),
             "lde": (block, 17, False, gl.GENERATOR),
             "intt": (rows_n, 14, True, None),
             "machine": (m_rows, 20, False, m_shift)}
    steps_in, plan_inputs = {}, {}
    for key, (batch, log_n, inverse, shift) in plans.items():
        x = random_field(rng, (batch, 1 << log_n), dev)
        cur = x
        for i, (kind, *args) in enumerate(
                cuda_ntt.plan(x, log_n, inverse, shift, S)):
            if kind == "k1":
                out = cuda_ntt.ntt_tile(cur, *args)
                same(out, cuda_ntt.ntt_tile_plain(cur, *args),
                     f"ntt_tile alone, {key} step {i}")
            else:
                out = cuda_ntt.transpose(cur, *args)
                same(out, cuda_ntt.transpose_plain(cur, *args),
                     f"ntt_transpose alone, {key} step {i}")
            steps_in[key, i] = (kind, cur, args)
            cur = out
        same(cur.reshape(x.shape),
             cuda_ntt.transform_plain(x, log_n, inverse, shift),
             f"four-step {key} chain")
        plan_inputs[key] = (x, log_n, inverse, shift)
    log(f"phase 1: every K1/K2 step of the 2^24, ({block}, 2^17) and "
        f"({m_rows}, 2^20) coset plans and of the ({rows_n}, 2^14) iNTT plan "
        f"== its plain version")

    # times at the main paths' shapes, each beside its bound, its plain
    # version and the first version's recorded time
    x24 = plan_inputs["2^24"][0]
    clock = sm_clock_mhz(lambda: cuda_ntt.transform(x24, 24, False), 600)
    log(f"phase 1: SM clock under load {clock:.0f} MHz; bounds: bytes at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, operations at {SMS} SMs x "
        f"{INT_LANES} lanes x the clock, {GL_MUL_MADS} multiply-adds per "
        f"Goldilocks product, one product per butterfly  [{card}]")
    timed = {}

    def report(label, fn, plain, nbytes, mads, library=None):
        ms = cuda_ms(fn)
        plain_ms = cuda_ms(plain, 3)
        lib_ms = cuda_ms(library) if library is not None else None
        b_ms, by = bound_ms(nbytes, mads, clock)
        other = (f"operations {mads / (SMS * INT_LANES * clock * 1e6) * 1e3:.4f}"
                 if by == "bytes" else
                 f"bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f}")
        lib = "" if lib_ms is None else f"; library {lib_ms:.4f} ms"
        log(f"phase 1: {label}: {ms:.4f} ms; bound {b_ms:.4f} ms ({by}; "
            f"{other} ms), share {b_ms / ms * 100:.1f} %; plain "
            f"{plain_ms:.3f} ms{lib}; first version: "
            f"{FIRST_MS.get(label, 'not recorded')}"
            f"  [{card}]")
        timed[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": by, "library_ms": lib_ms}

    def step(label, key, i):
        kind, src, args = steps_in[key, i]
        if kind == "k1":
            report(label, lambda: cuda_ntt.ntt_tile(src, *args),
                   lambda: cuda_ntt.ntt_tile_plain(src, *args),
                   16 * src.numel(), k1_mads(*args))
        else:
            b, R, C = args
            report(label, lambda: cuda_ntt.transpose(src, *args),
                   lambda: cuda_ntt.transpose_plain(src, *args),
                   16 * src.numel(), 0,
                   library=lambda: src.reshape(b, R, C).transpose(1, 2)
                   .contiguous())

    step("K1 (512, 2^17) column step", "lde", 0)
    step("K1 (512, 2^17) row step", "lde", 1)
    step("K2 (512, 2^17)", "lde", 2)
    step("K1 2^12 x 2^12 column step", "2^24", 0)
    step("K1 2^12 rows x 2^12", "2^24", 1)
    step("K2 2^12 x 2^12", "2^24", 2)
    step(f"K1 ({rows_n}, 2^14) iNTT column step", "intt", 0)
    step(f"K1 ({rows_n}, 2^14) iNTT row step", "intt", 1)
    step(f"K1 ({m_rows}, 2^20) coset column step", "machine", 0)
    step(f"K1 ({m_rows}, 2^20) coset row step", "machine", 1)
    step(f"K2 ({m_rows}, 2^20)", "machine", 2)

    whole = [(f"NTT ({b}, 2^{log_n})", random_field(rng, (b, 1 << log_n), dev),
              log_n, False, None) for b, log_n in TIMED]
    whole.append((f"iNTT ({rows_n}, 2^14)",) + plan_inputs["intt"])
    whole.append((f"coset LDE block ({block}, 2^17)",) + plan_inputs["lde"])
    whole.append((f"machine coset transform ({m_rows}, 2^20)",)
                 + plan_inputs["machine"])
    for label, x, log_n, inverse, shift in whole:
        mads = sum(k1_mads(*st[1:]) for st in
                   cuda_ntt.plan(x, log_n, inverse, shift, S) if st[0] == "k1")
        report(label, lambda: cuda_ntt.transform(x, log_n, inverse, shift),
               lambda: cuda_ntt.transform_plain(x, log_n, inverse, shift),
               16 * x.numel(), mads)
    torch.cuda.synchronize()
    return {"worst": worst, "timed": timed}


# ---------------------------------------------------------------------------
# Phase 2: Poseidon's dense matvecs on the card
# ---------------------------------------------------------------------------

def phase_poseidon(dev, card: str) -> None:
    """Poseidon's dense MDS and sigma matvecs as float64 limb matmuls (the
    route `permute` takes) against the field-op products, on 2^20 random
    states with u64 edge values; the time of the MDS both ways and of a
    whole permutation."""
    import numpy as np

    from vectorx_tpu_torch.hash import poseidon

    rng = np.random.default_rng(3)
    x = random_field(rng, (1 << 20, poseidon.WIDTH), dev)
    prm = poseidon._dev_params(dev)
    for name in ("mds", "sigma"):
        err = max_abs_err(poseidon._matmul_limbs(x, prm[name + "_T"]),
                          poseidon._mds_layer(x, prm[name]))
        if err:
            raise AssertionError(f"Poseidon {name}: limb matmuls != field "
                                 f"ops (max err {err})")
    ops = cuda_ms(lambda: poseidon._mds_layer(x, prm["mds"]))
    mm = cuda_ms(lambda: poseidon._matmul_limbs(x, prm["mds_T"]))
    perm = cuda_ms(lambda: poseidon.permute(x), 3)
    log(f"phase 2: Poseidon MDS and sigma on 2^20 states: limb matmuls == "
        f"field ops; MDS {mm:.3f} ms as matmuls, {ops:.3f} ms as field "
        f"ops; permute {perm:.3f} ms  [{card}]")


# ---------------------------------------------------------------------------
# Phase 3: the main path at a real size
# ---------------------------------------------------------------------------

class StageTimer:
    """Seconds per prover stage (and in all NTTs and Poseidon permutations,
    which run inside the stages), by wrapping each with synchronizing host
    timers while active."""

    def __init__(self, extra=()):
        from vectorx_tpu_torch.hash import poseidon
        from vectorx_tpu_torch.stark import prover, stages
        from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
        from vectorx_tpu_torch.stark.sha256_air import Sha256Air

        ntt_mod = importlib.import_module("vectorx_tpu_torch.ntt.ntt")
        self.targets = [
            (Blake2bAir, "build_trace"), (Sha256Air, "build_trace"),
            (stages, "commit_rows"), (prover, "aux_witness"),
            (prover, "_composition"), (stages, "quotient_coeffs"),
            (stages, "deep_eval_groups"), (stages, "deep_compose"),
            (stages, "fri_commit_layer"), (stages, "fri_fold"),
            (stages, "fri_final_coeffs"), (stages, "grind"),
            (stages, "open_positions"), (ntt_mod, "_transform"),
            (poseidon, "permute"), *extra]
        self.times = {}
        self._saved = []

    def __enter__(self):
        import torch

        for mod, attr in self.targets:
            orig = getattr(mod, attr)
            # a class's method is named with its class (the trace builds)
            name = f"{mod.__name__}.{attr}" if isinstance(mod, type) else attr

            def wrapped(*a, _orig=orig, _name=name, **kw):
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


def reset_launches() -> None:
    from vectorx_tpu_torch.ntt import cuda_ntt

    for name in cuda_ntt.LAUNCHES:
        cuda_ntt.LAUNCHES[name] = 0


def read_launches(path: str) -> dict:
    """The kernel launch counts since `reset_launches`; every kernel must
    have launched on `path`."""
    from vectorx_tpu_torch.ntt import cuda_ntt

    counts = dict(cuda_ntt.LAUNCHES)
    for name, count in counts.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{path} path")
    return counts


def prove_and_check(name, air, cfg, dev, card):
    import torch

    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.stark import prove, verify
    from vectorx_tpu_torch.stark.serialize import (proof_from_json,
                                                   proof_to_json)

    trace = air.build_trace()
    timer = StageTimer()
    before = sum(cuda_ntt.LAUNCHES.values())
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with timer:
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
        raise AssertionError(f"{name}: verify rejected the proof")
    log(f"phase 3: {name}, stage-timed: prove {t_prove:.3f} s, verify "
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


# ---------------------------------------------------------------------------
# Phase 5: byte hashes on the card
# ---------------------------------------------------------------------------

def phase_hashes(dev, card: str) -> None:
    import hashlib

    import numpy as np
    import torch

    from vectorx_tpu_torch.hash.blake2b import blake2b_batch
    from vectorx_tpu_torch.hash.sha256 import sha256_batch
    from vectorx_tpu_torch.merkle import (sha256_merkle_root,
                                          sha256_merkle_root_device)

    rng = np.random.default_rng(5)
    count, max_len = 4096, 35840
    lens = rng.integers(0, max_len + 1, size=count)
    lens[:4] = (0, 1, 128, max_len)
    buf = rng.integers(0, 256, size=(count, max_len), dtype=np.uint8)
    t0 = time.perf_counter()
    got = blake2b_batch(buf, lens, dev)
    torch.cuda.synchronize()
    t_b2 = time.perf_counter() - t0
    for i in range(count):
        want = hashlib.blake2b(buf[i, :lens[i]].tobytes(), digest_size=32)
        if got[i].tobytes() != want.digest():
            raise AssertionError(f"blake2b_batch row {i} (length {lens[i]})")
    log(f"phase 5: blake2b_batch: {count} messages of 0-{max_len} B (mean "
        f"{lens.mean():.0f} B) == hashlib, {t_b2:.3f} s  [{card}]")

    t_sha = 0.0
    for length in (0, 55, 56, 64, 119, 1000):
        msgs = rng.integers(0, 256, size=(count, length), dtype=np.uint8)
        t0 = time.perf_counter()
        got = sha256_batch(msgs, dev)
        torch.cuda.synchronize()
        t_sha += time.perf_counter() - t0
        for i in range(count):
            if got[i].tobytes() != hashlib.sha256(msgs[i].tobytes()).digest():
                raise AssertionError(f"sha256_batch length {length} row {i}")
    log(f"phase 5: sha256_batch: {count} messages at each of 6 lengths "
        f"(0-1000 B) == hashlib, {t_sha:.3f} s  [{card}]")

    leaves = rng.integers(0, 256, size=(256, 32), dtype=np.uint8)
    t0 = time.perf_counter()
    root = sha256_merkle_root_device(leaves, dev)
    t_root = time.perf_counter() - t0
    if root != sha256_merkle_root([row.tobytes() for row in leaves]):
        raise AssertionError("sha256_merkle_root_device != host root")
    log(f"phase 5: sha256_merkle_root_device over 256 leaves == host root, "
        f"{t_root:.3f} s  [{card}]")


# ---------------------------------------------------------------------------
# Phase 6: batched ed25519 on the card
# ---------------------------------------------------------------------------

def ed25519_batch():
    """300 keys, 240 of them signing one message (the rest unsigned), as
    `batch_verify`'s arguments, and a signature set with one forgery."""
    import hashlib

    from vectorx_tpu_torch.curves import ed25519 as host

    n, n_signed = 300, 240
    keys = [hashlib.sha256(b"chip-smoke" + i.to_bytes(4, "little")).digest()
            for i in range(n)]
    pks = [host.public_key(k) for k in keys]
    msg = b"\x01" * 53
    signed = set(random.Random(6).sample(range(n), n_signed))
    mask = [i in signed for i in range(n)]
    sigs = [host.sign(k, msg) if on else bytes(64)
            for k, on in zip(keys, mask)]
    forged = list(sigs)
    victim = min(signed)
    forged[victim] = host.sign(keys[victim], msg + b"!")
    return pks, [msg] * n, sigs, mask, forged


def ed25519_verify(batch, sigs, device) -> tuple[bool, float]:
    import torch

    from vectorx_tpu_torch.curves.ed25519_batch import batch_verify

    pks, msgs, _, mask, _ = batch
    t0 = time.perf_counter()
    ok = batch_verify(pks, msgs, sigs, mask, rng=random.Random(7),
                      device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    return ok, time.perf_counter() - t0


def phase_ed25519(dev, card: str, host: "HostChecks") -> None:
    batch = ed25519_batch()
    ok, t_dev = ed25519_verify(batch, batch[2], dev)
    if not ok:
        raise AssertionError("batch_verify rejected valid signatures")
    bad, t_bad = ed25519_verify(batch, batch[4], dev)
    if bad:
        raise AssertionError("batch_verify accepted a forged signature")
    ok_cpu, t_cpu = host.result()["ed25519"]
    if ok_cpu != ok:
        raise AssertionError("batch_verify: CUDA and CPU disagree")
    log(f"phase 6: ed25519 batch_verify, 300 keys, 240 signed: accepted in "
        f"{t_dev:.3f} s, forged signature rejected in {t_bad:.3f} s; CPU "
        f"agrees ({t_cpu:.3f} s in the host-check process)  [{card}]")


# ---------------------------------------------------------------------------
# Phase 7: the header_range statement at full size
# ---------------------------------------------------------------------------

# the reference deployment's header_range with 300 authorities and headers
# cycling through 100/10/60/25 % of a 2048 B bound, at tree 16 (the
# deployment's is 256) so that the whole script fits its limit
HR_TREE, HR_AUTH = 16, 300


def header_range_chain(tree: int = HR_TREE, auth: int = HR_AUTH):
    """Phase 7's fixture chain and its blocks (trusted, target] (phases 13
    and 14: the same header mix at tree 2 and 4 authorities)."""
    from vectorx_tpu_torch.io.fixtures import FixtureChain

    base, frac = 2048 - 180, (100, 10, 60, 25)
    chain = FixtureChain(seed=19, num_blocks=3 * tree + 2,
                         epoch_length=2 * tree,
                         authorities_per_era=lambda e: auth,
                         extension_bytes=lambda b: base * frac[b % 4] // 100)
    return chain, 2 * tree, 3 * tree


def public_bind_statements(headers: list) -> list:
    """Phase 11's public-bind statements, depth cuts of phase 7's: the
    Blake2b hashes of the first 4 of its headers and the SHA-256 nodes of
    the first level of its state-root tree (8 nodes over 16 leaves), each
    with `bind="public"`; as (name, AIR, the shape `public_shape` takes)."""
    from vectorx_tpu_torch.circuits.subchain import decode_header_fields
    from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
    from vectorx_tpu_torch.stark.sha256_air import Sha256Air

    roots = [decode_header_fields(h, len(h)).state_root for h in headers]
    nodes = [roots[2 * i] + roots[2 * i + 1] for i in range(len(roots) // 2)]
    return [("Blake2bAir", Blake2bAir(headers[:4], bind="public"),
             [len(h) for h in headers[:4]]),
            ("Sha256Air", Sha256Air(nodes[:8], bind="public"),
             [2] * len(nodes[:8]))]


def phase_header_range(dev, card: str):
    """Phase 7; returns the launches on the gateway path and the gateway's
    ZK proof, which phase 11 aggregates."""
    import torch

    from vectorx_tpu_torch.circuits import (DummyHeaderRange,
                                            HeaderRangeCircuit)
    from vectorx_tpu_torch.circuits.zk_commitment import _sha_rows
    from vectorx_tpu_torch.circuits.zk_header_range import (
        _blake_rows, verify_header_range_zk)
    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.hash.sha256 import chained_hash
    from vectorx_tpu_torch.io.abi import HeaderRangeInput
    from vectorx_tpu_torch.services import (ContractError, MockGateway,
                                            VectorXContract, make_gateway,
                                            range_key)
    from vectorx_tpu_torch.stark import StarkConfig, prover
    from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir
    from vectorx_tpu_torch.stark.serialize import (proof_from_json,
                                                   proof_to_json)

    tree, auth, max_header = HR_TREE, HR_AUTH, 35840
    t0 = time.perf_counter()
    chain, trusted, target = header_range_chain()
    inp = HeaderRangeInput(trusted, chain.get_block_hash(trusted), 1,
                           chained_hash(chain.era_pubkeys(1)),
                           target).encode()
    sizes = [len(chain.get_encoded_header(b))
             for b in range(trusted + 1, target + 1)]
    want = DummyHeaderRange(tree).run(inp, chain)
    log(f"phase 7: fixture chain: blocks ({trusted}, {target}], headers "
        f"{min(sizes)}-{max(sizes)} B ({sum(sizes)} B), {auth} authorities "
        f"({time.perf_counter() - t0:.2f} s)")

    t0 = time.perf_counter()
    out = HeaderRangeCircuit(auth, max_header, tree).run(inp, chain,
                                                         device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    if out != want:
        raise AssertionError("HeaderRangeCircuit.run != DummyHeaderRange")
    log(f"phase 7: HeaderRangeCircuit({auth}, {max_header}, {tree}).run == "
        f"DummyHeaderRange output, {t_run:.3f} s  [{card}]")

    # the ZK header_range as a user drives it: the contract requests it,
    # the gateway proves it on the card, verifies the proof and only then
    # runs the contract's commit
    cfg = StarkConfig(fri=FriConfig())
    gw = make_gateway(chain, auth, tree, max_header, zk=True,
                      stark_config=cfg, device=dev)
    contract = VectorXContract(gw, trusted, chain.get_block_hash(trusted), 1,
                               chained_hash(chain.era_pubkeys(1)),
                               header_range_commitment_tree_size=tree)
    fid = contract.header_range_function_id
    hr_prover, hr_verifier = gw.provers[fid]
    timer = StageTimer()
    seen = {}

    def timed_prover(i):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with timer:
            seen["out"], seen["proof"] = hr_prover(i)
        torch.cuda.synchronize()
        seen["prove"] = time.perf_counter() - t0
        seen["peak"] = torch.cuda.max_memory_allocated(dev)
        return seen["out"], seen["proof"]

    def timed_verifier(i, out, zkp):
        t0 = time.perf_counter()
        ok = hr_verifier(i, out, zkp)
        seen["verify"] = time.perf_counter() - t0
        return ok

    gw.register_prover(fid, timed_prover, timed_verifier)
    contract.request_header_range(1, target)
    if gw.pending[0][1] != inp:
        raise AssertionError("the contract's request != phase 7's input")
    reset_launches()
    t0 = time.perf_counter()
    gw.fulfill_next()   # raises ContractError if the gateway rejects
    t_fulfill = time.perf_counter() - t0
    launches = read_launches("header_range gateway")
    proof, t_prove, t_verify, peak = (seen["proof"], seen["prove"],
                                      seen["verify"], seen["peak"])
    if proof.output_bytes != want:
        raise AssertionError("prove_header_range_zk output != "
                             "DummyHeaderRange output")
    key = range_key(trusted, target)
    if (contract.latest_block,
            contract.block_height_to_header_hash[target],
            contract.state_root_commitments[key],
            contract.data_root_commitments[key]) != \
            (target, want[:32], want[32:64], want[64:96]):
        raise AssertionError("the contract's stored header hash and "
                             "commitments != DummyHeaderRange output")
    log(f"phase 7: make_gateway(zk=True, device={dev}): request_header_range"
        f"(1, {target}) fulfilled in {t_fulfill:.3f} s (one prove, one "
        f"verify on the card); the contract stores the dummy's header hash "
        f"and state and data commitments  [{card}]")
    b2_shapes, pos = [], 0
    for sz in proof.header_chunk_sizes:
        rows = sum(_blake_rows(h) for h in proof.headers[pos:pos + sz])
        b2_shapes.append((sz, max(5, rows.bit_length())))
        pos += sz
    sha_shapes = [(sz, max(7, (sz * _sha_rows(bytes(64))).bit_length()))
                  for sz in proof.sha_chunk_sizes]
    first = proof.header_chunk_sizes[0]
    big = Blake2bAir.statement(proof.headers[:first],
                               proof.header_hashes[:first])
    standing = prover._commit_cols(big) * (big.n << cfg.rate_bits) * 8
    log(f"phase 7: prove_header_range_zk(tree_size={tree}, "
        f"max_authorities={auth}, FriConfig()): prove {t_prove:.3f} s, peak "
        f"device memory {peak / 2**30:.3f} GiB  [{card}]")
    log(f"phase 7: {len(b2_shapes)} Blake2b chunk proofs (headers, log_n) "
        f"{b2_shapes}; {len(sha_shapes)} SHA-256 chunk proofs (nodes, log_n) "
        f"{sha_shapes}; largest chunk's standing LDE {standing / 2**30:.3f} "
        f"GiB, peak / standing {peak / standing:.3f}  [{card}]")
    log(f"phase 7: stage seconds (NTT and Poseidon run inside the stages; "
        f"the trace builds are host numpy): {timer.summary()}  [{card}]")
    log(f"phase 7: kernel launches on the header_range gateway path (prove "
        f"and verify): {launches}")

    # the gateway's verifier accepted this proof; now it turns tampered
    # ones away, and a tampered output with this proof reverts the commit
    bad = dataclasses.replace(
        proof, header_hashes=[bytes(32)] + list(proof.header_hashes[1:]))
    if verify_header_range_zk(bad, tree, cfg, device=dev):
        raise AssertionError("tampered header hash accepted")
    sha0 = proof_from_json(proof_to_json(proof.sha_proofs[0]))
    leaf = sha0.trace_openings[0].leaf
    leaf[0] = (leaf[0] + 1) % gl.P
    bad = dataclasses.replace(proof,
                              sha_proofs=[sha0] + list(proof.sha_proofs[1:]))
    if verify_header_range_zk(bad, tree, cfg, device=dev):
        raise AssertionError("tampered SHA chunk proof accepted")
    bad_out = bytes([want[0] ^ 1]) + want[1:]
    evil = MockGateway()
    evil.register_prover(fid, lambda i: (bad_out, proof), hr_verifier)
    fresh = VectorXContract(evil, trusted, chain.get_block_hash(trusted), 1,
                            chained_hash(chain.era_pubkeys(1)),
                            header_range_commitment_tree_size=tree)
    fresh.request_header_range(1, target)
    try:
        evil.fulfill_next()
        raise AssertionError("a tampered output with the gateway's proof "
                             "was committed")
    except ContractError:
        pass
    if fresh.latest_block != trusted or fresh.data_root_commitments or \
            target in fresh.block_height_to_header_hash:
        raise AssertionError("a rejected fulfillment changed the contract")
    log(f"phase 7: the gateway's verify_header_range_zk accepted in "
        f"{t_verify:.3f} s; tampered header hash and tampered SHA chunk "
        f"proof rejected; a tampered output with the same proof reverts "
        f"the commit (ContractError, contract unchanged)  [{card}]")
    return launches, proof


# ---------------------------------------------------------------------------
# Phase 8: byte identity of the component proofs, CUDA against CPU
# ---------------------------------------------------------------------------

def reference_proof_json(air, trace_u64, config):
    """The JAX reference's proof of this statement, as the golden fixtures
    the tests load hold it (`tests/fixtures/proofs`, keyed by
    `tests/_proofcache.py::_key`), or None when there is none."""
    import gzip
    import importlib.util

    # loaded by its path: its top level imports only the standard library
    spec = importlib.util.spec_from_file_location(
        "_proofcache", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "tests", "_proofcache.py"))
    cache = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cache)
    path = os.path.join(cache.FIXTURE_DIR,
                        cache._key(air, trace_u64, config) + ".json.gz")
    if not os.path.exists(path):
        return None
    with gzip.open(path, "rt") as f:
        return json.load(f)


def phase_identity(dev, card: str) -> None:
    from vectorx_tpu_torch.circuits import zk_header_range
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.hash.sha256 import chained_hash
    from vectorx_tpu_torch.io.abi import HeaderRangeInput
    from vectorx_tpu_torch.io.fixtures import FixtureChain
    from vectorx_tpu_torch.stark import StarkConfig
    from vectorx_tpu_torch.stark.serialize import proof_to_json

    chain = FixtureChain(seed=19, num_blocks=12, epoch_length=6,
                         authorities_per_era=lambda e: 4)
    inp = HeaderRangeInput(7, chain.get_block_hash(7), 1,
                           chained_hash(chain.era_pubkeys(1)), 9).encode()
    cfg = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=0,
                                    num_queries=12, final_poly_len=4,
                                    pow_bits=0))
    t0 = time.perf_counter()
    proved = []
    orig = zk_header_range.prove

    def record(air, trace, config, *, device):
        proof = orig(air, trace, config, device=device)
        proved.append((air, trace, proof))
        return proof

    zk_header_range.prove = record
    try:
        zk_header_range.prove_header_range_zk(chain, inp, tree_size=2,
                                              max_authorities=8, config=cfg,
                                              device=dev)
    finally:
        zk_header_range.prove = orig
    size = 0
    for air, trace, proof in proved:
        ref = reference_proof_json(air, trace, cfg)
        if ref is None:
            raise AssertionError(f"no reference proof of the tree=2 "
                                 f"{type(air).__name__} statement")
        text = json.dumps(proof_to_json(proof))
        if text != json.dumps(ref):
            raise AssertionError(f"tree=2 header_range: the CUDA "
                                 f"{type(air).__name__} proof differs from "
                                 f"the reference's")
        size += len(text)
    log(f"phase 8: tree=2 header_range: {len(proved)} component proofs on "
        f"CUDA, JSON identical to the JAX reference's ({size} bytes, "
        f"{time.perf_counter() - t0:.2f} s)  [{card}]")


# ---------------------------------------------------------------------------
# Phase 4: the streamed prover and the machine proof, CUDA against CPU
# ---------------------------------------------------------------------------

def bus_air():
    """The LogUp bus statement of `tests/test_bus.py` (`BusAir`) on the
    port: value X written once with fanout 2 and read twice, Y written
    once and read once, across distant rows of a 2^6-row trace."""
    import numpy as np

    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.stark.air import Air, BusPort

    x, y = (123456789, 987654321), (42, 7)
    writes = {5: (1, x, 2), 40: (2, y, 1)}
    reads = {20: (1, x), 30: (1, x), 50: (2, y)}

    class BusAir(Air):
        def __init__(self):
            super().__init__(width=4, log_n=6, constraint_degree=2)

        def bus_ports(self):
            return [BusPort(value_cols=(0, 1), addr_col=0, mult_col=1),
                    BusPort(value_cols=(2, 3), addr_col=2, mult_col=3)]

        def constant_columns(self):
            cols = np.zeros((4, self.n), dtype=np.uint64)
            for row, (addr, _v, fanout) in writes.items():
                cols[0, row], cols[1, row] = addr, fanout
            for row, (addr, _v) in reads.items():
                cols[2, row], cols[3, row] = addr, gl.P - 1
            return cols

        def transition(self, alg, local, nxt, public, consts=None):
            return []

        def build_trace(self):
            tr = np.zeros((4, self.n), dtype=np.uint64)
            for row, (_a, (v0, v1), _f) in writes.items():
                tr[0, row + 1], tr[1, row + 1] = v0, v1
            for row, (_a, (v0, v1)) in reads.items():
                tr[2, row + 1], tr[3, row + 1] = v0, v1
            return tr

    return BusAir()


def small_config(cap_height: int, num_queries: int = 12,
                 final_poly_len: int = 4, pow_bits: int = 0):
    """The tests' small FRI configs at rate 3."""
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.stark import StarkConfig

    return StarkConfig(fri=FriConfig(
        rate_bits=3, cap_height=cap_height, num_queries=num_queries,
        final_poly_len=final_poly_len, pow_bits=pow_bits))


# tests/test_recursion_aggregate.py's config
AGG_KNOBS = dict(cap_height=1, num_queries=2, final_poly_len=2, pow_bits=1)
AGGREGATION = "FibonacciAir(3) aggregation"


def phase4_statements():
    """(name, AIR, config, streamed): RangeCheckAir(8) proved unstreamed;
    the bus AIR (tests/test_bus.py's config) and FibonacciAir(8)
    (tests/test_stark.py's) through `prove_streamed`."""
    import numpy as np

    from vectorx_tpu_torch.stark import FibonacciAir, RangeCheckAir

    vals = np.random.default_rng(11).integers(0, 1 << 6, size=(4, 255),
                                              dtype=np.uint64)
    return [("RangeCheckAir(log_n=8, bits=6, V=4)", RangeCheckAir(8, 6, vals),
             small_config(1), False),
            ("bus AIR of tests/test_bus.py", bus_air(), small_config(0), True),
            ("FibonacciAir(log_n=8)", FibonacciAir(8), small_config(1), True)]


def proof_text(proof) -> str:
    from vectorx_tpu_torch.stark.serialize import proof_to_json

    return json.dumps(proof_to_json(proof))


def host_checks() -> dict:
    """The CPU sides of phases 4 and 6, each with its seconds: the proofs
    of `phase4_statements`, the machine proof of the FibonacciAir(3)
    aggregation (child proof included) and the ed25519 batch verify."""
    from vectorx_tpu_torch.recursion.aggregate import aggregate_prove
    from vectorx_tpu_torch.stark import FibonacciAir, prove
    from vectorx_tpu_torch.stark.prover import prove_streamed

    out = {}
    for name, air, cfg, streamed in phase4_statements():
        t0 = time.perf_counter()
        fn = prove_streamed if streamed else prove
        out[name] = (proof_text(fn(air, air.build_trace(), cfg, device="cpu")),
                     time.perf_counter() - t0)
    t0 = time.perf_counter()
    cfg, child = small_config(**AGG_KNOBS), FibonacciAir(log_n=3)
    child_proof = prove(child, child.build_trace(), cfg, device="cpu")
    agg = aggregate_prove([child], [child_proof], cfg, device="cpu")
    out[AGGREGATION] = (proof_text(agg.proof), time.perf_counter() - t0)
    batch = ed25519_batch()
    out["ed25519"] = ed25519_verify(batch, batch[2], "cpu")
    return out


def host_public_bind(out_dir: str) -> dict:
    """The CPU side of phase 11's public bind: the proofs of
    `public_bind_statements` over phase 7's headers at `FriConfig()`, on
    the CPU, their JSON written to `out_dir`; the seconds of each."""
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.stark import StarkConfig, prove

    chain, trusted, target = header_range_chain()
    headers = [chain.get_encoded_header(b)
               for b in range(trusted + 1, target + 1)]
    cfg, out = StarkConfig(fri=FriConfig()), {}
    for name, air, _ in public_bind_statements(headers):
        t0 = time.perf_counter()
        text = proof_text(prove(air, air.build_trace(), cfg, device="cpu"))
        with open(os.path.join(out_dir, f"public_{name}.json"), "w") as f:
            f.write(text)
        out[name] = time.perf_counter() - t0
    return out


def host_justification(out_dir: str) -> dict:
    """The CPU side of phase 12: the proofs of
    `justification_cpu_statements` on the CPU, their JSON written to
    `out_dir`; the seconds of each."""
    from vectorx_tpu_torch.stark import prove

    out = {}
    for name, air, cfg in justification_cpu_statements():
        t0 = time.perf_counter()
        text = proof_text(prove(air, air.build_trace(), cfg, device="cpu"))
        with open(os.path.join(out_dir, f"justification_{name}.json"),
                  "w") as f:
            f.write(text)
        out[name] = time.perf_counter() - t0
    return out


# The CPU threads of each host process, and the niceness of the
# host-justification one, which proves on the cores that the card's
# processes and the host-check process leave idle
HOST_THREADS, JUSTIFICATION_NICE = 4, 5


class HostChecks:
    """The CPU sides of phases 4, 6, 11 and 12 in two processes, both
    started before phase 1 so that the host proves while the card runs the
    other phases: `chip_smoke.py --host-checks <dir>` prints one JSON line
    for `host_checks` and then one for `host_public_bind`, and
    `chip_smoke.py --host-justification <dir>` (at niceness
    `JUSTIFICATION_NICE`) one for `host_justification`.  The public-bind
    and justification proofs go to files in `<dir>`.  Each process has a
    cache directory of its own, so it derives every key and program
    itself."""

    FLAGS = ("--host-checks", "--host-justification")

    def __init__(self, t_start: float):
        # the script's start on the wall clock, which the processes share
        self.epoch0 = time.time() - (time.perf_counter() - t_start)
        self.tmp = tempfile.mkdtemp(prefix="vectorx-host-checks-")
        self.procs = {flag: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, self.tmp],
            stdout=subprocess.PIPE, text=True,
            env=dict(os.environ,
                     VECTORX_VK_CACHE=os.path.join(self.tmp, flag[2:])))
            for flag in self.FLAGS}
        self._result = None
        self._last = {}

    def result(self) -> dict:
        """The host-check process's first line: phases 4 and 6."""
        if self._result is None:
            proc = self.procs["--host-checks"]
            t0 = time.perf_counter()
            line = proc.stdout.readline()
            if not line:
                proc.wait()
                raise AssertionError(f"the host-check process failed (exit "
                                     f"{proc.returncode})")
            self._result = json.loads(line)
            log(f"host checks: waited {time.perf_counter() - t0:.2f} s for "
                f"the host-check process's first line")
        return self._result

    def _last_line(self, flag: str, timeout: float) -> dict:
        """The seconds of each proof on process `flag`'s last line, once
        the process has ended."""
        if flag not in self._last:
            if flag == "--host-checks":
                self.result()
            proc = self.procs[flag]
            what = f"the {flag[2:].replace('checks', 'check')} process"
            t0 = time.perf_counter()
            try:
                out, _ = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{what} did not end within "
                                     f"{timeout:.0f} s")
            lines = out.strip().splitlines()
            if proc.returncode != 0 or len(lines) != 1:
                raise AssertionError(f"{what} failed (exit "
                                     f"{proc.returncode})")
            res = json.loads(lines[0])
            log(f"host checks: {what} ended {res['t1'] - self.epoch0:.1f} s "
                f"since the start; waited {time.perf_counter() - t0:.2f} s "
                f"for it")
            self._last[flag] = res["seconds"]
        return self._last[flag]

    def public_bind(self, timeout: float) -> dict:
        """The seconds of each public-bind proof, whose JSON is in
        `proof_path("public", name)`."""
        return self._last_line("--host-checks", timeout)

    def justification(self, timeout: float) -> dict:
        """The seconds of each of phase 12's CPU proofs, whose JSON is in
        `proof_path("justification", name)`."""
        return self._last_line("--host-justification", timeout)

    def proof_path(self, kind: str, name: str) -> str:
        return os.path.join(self.tmp, f"{kind}_{name}.json")

    def stop(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.tmp, ignore_errors=True)


def phase_cuda_cpu(dev, card: str, host: HostChecks) -> None:
    import torch

    from vectorx_tpu_torch.recursion.aggregate import aggregate_prove
    from vectorx_tpu_torch.stark import FibonacciAir, prove
    from vectorx_tpu_torch.stark.prover import prove_streamed

    cpu = host.result()
    for name, air, cfg, streamed in phase4_statements():
        t0 = time.perf_counter()
        trace = air.build_trace()
        full = proof_text(prove(air, trace, cfg, device=dev))
        got = full
        if streamed:
            got = proof_text(prove_streamed(air, trace, cfg, device=dev))
            if got != full:
                raise AssertionError(f"{name}: CUDA prove_streamed != prove")
        if got != cpu[name][0]:
            raise AssertionError(f"{name}: CUDA and CPU proofs differ")
        what = ("prove_streamed == prove on CUDA, CUDA == CPU streamed"
                if streamed else "CUDA and CPU proof JSON identical")
        log(f"phase 4: {name}: {what} ({len(full)} bytes, CUDA "
            f"{time.perf_counter() - t0:.2f} s, CPU {cpu[name][1]:.2f} s)")

    # the aggregation of tests/test_recursion_aggregate.py's first child:
    # one machine proof of 1047 rows (log_n 11), on CUDA and on the CPU
    cfg, child = small_config(**AGG_KNOBS), FibonacciAir(log_n=3)
    t0 = time.perf_counter()
    child_proof = prove(child, child.build_trace(), cfg, device=dev)
    agg = aggregate_prove([child], [child_proof], cfg, device=dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    rows = agg.machine_air.program.n_rows
    if (rows, agg.machine_air.log_n) != (1047, 11):
        raise AssertionError(f"FibonacciAir(3) machine: {rows} rows")
    if proof_text(agg.proof) != cpu[AGGREGATION][0]:
        raise AssertionError("FibonacciAir(3) aggregation: machine proof "
                             "differs on CUDA and CPU")
    log(f"phase 4: {AGGREGATION}, {rows} machine rows (log_n 11): machine "
        f"proof JSON identical on CUDA ({t_dev:.2f} s) and CPU "
        f"({cpu[AGGREGATION][1]:.2f} s in the host-check process, child "
        f"proof included)  [{card}]")


# ---------------------------------------------------------------------------
# Phase 9: the aggregated ZK rotate at full width
# ---------------------------------------------------------------------------

def phase_rotate(dev, card: str) -> dict:
    import torch

    from vectorx_tpu_torch.circuits import DummyRotate, zk_rotate
    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.hash.sha256 import chained_hash
    from vectorx_tpu_torch.io.abi import RotateInput
    from vectorx_tpu_torch.io.fixtures import FixtureChain
    from vectorx_tpu_torch.recursion import aggregate, progcache
    from vectorx_tpu_torch.recursion.machine import MachineAir
    from vectorx_tpu_torch.services import (VectorXContract, compute_genesis,
                                            make_gateway)
    from vectorx_tpu_torch.stark import StarkConfig, prover, stages
    from vectorx_tpu_torch.stark.serialize import (proof_from_json,
                                                   proof_to_json)

    # the deployment's MAX_AUTHORITY_SET_SIZE on the chain of
    # tests/test_zk_rotate.py, at the production FRI config
    auth = 300
    t0 = time.perf_counter()
    chain = FixtureChain(seed=19, num_blocks=12, epoch_length=6,
                         authorities_per_era=lambda e: auth)
    inp = RotateInput(1, chained_hash(chain.era_pubkeys(1))).encode()
    want = DummyRotate().run(inp, chain)
    cfg = StarkConfig()
    log(f"phase 9: fixture chain, {auth} authorities, DummyRotate output "
        f"({time.perf_counter() - t0:.2f} s)")

    # the rotate as a user drives it: the contract requests it, the
    # gateway runs RotateCircuit (host signature and header checks)
    t0 = time.perf_counter()
    gw = make_gateway(chain, auth, device=dev)
    g = compute_genesis(chain, 7)
    contract = VectorXContract(gw, g.height, g.header_hash,
                               g.authority_set_id, g.authority_set_hash)
    contract.request_rotate(1)
    if gw.pending[0][1] != inp:
        raise AssertionError("the contract's rotate request != phase 9's "
                             "input")
    gw.fulfill_next()
    if contract.authority_set_id_to_hash.get(2) != want:
        raise AssertionError("the contract's next set hash != DummyRotate "
                             "output")
    log(f"phase 9: make_gateway(device={dev}): request_rotate(1) fulfilled "
        f"in {time.perf_counter() - t0:.3f} s; the contract stores "
        f"DummyRotate's hash of set 2  [{card}]")

    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    zk = zk_rotate.prove_rotate_zk(chain, inp, max_authorities=auth,
                                   config=cfg, device=dev)
    torch.cuda.synchronize()
    t_comp = time.perf_counter() - t0
    if zk.output_bytes != want:
        raise AssertionError("prove_rotate_zk output != DummyRotate output")
    t0 = time.perf_counter()
    if not zk_rotate.verify_rotate_zk(zk, auth, cfg, device=dev,
                                      rng=random.Random(9)):
        raise AssertionError("verify_rotate_zk rejected the proof")
    t_cver = time.perf_counter() - t0
    airs = zk_rotate.aggregate_children(zk.header_bytes, zk.header_hash,
                                        zk.commitment)
    log(f"phase 9: prove_rotate_zk: header {len(zk.header_bytes)} B, "
        f"children (AIR, log_n, width) "
        f"{[(type(a).__name__, a.log_n, a.width) for a in airs]}, "
        f"{t_comp:.3f} s; verify_rotate_zk accepted in {t_cver:.3f} s; "
        f"output == DummyRotate  [{card}]")

    # the aggregation, every stage timed; the host bytes of the HostTrees
    # and of the FRI codewords the streamed prover keeps on the host
    host = {"trees": 0, "codewords": 0}
    from_device = stages.HostTree.__dict__["from_device"]
    spill = stages.spill_codeword

    def tree_rec(tree):
        t = from_device.__get__(None, stages.HostTree)(tree)
        host["trees"] += t.nbytes()
        return t

    def spill_rec(c):
        out = spill(c)
        host["codewords"] += out[0].nbytes + out[1].nbytes
        return out

    timer = StageTimer(extra=[
        (aggregate, "_build_tape"), (aggregate, "compile_tape"),
        (MachineAir, "build_trace"), (MachineAir, "constant_columns"),
        (prover, "prove_streamed"), (prover, "preprocess"),
        (stages, "commit_streamed"), (stages, "coset_eval_rows"),
        (stages, "deep_compose_coset"), (stages, "to_coeffs"),
        (stages, "open_positions_host")])
    stages.HostTree.from_device = staticmethod(tree_rec)
    stages.spill_codeword = spill_rec
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        with timer:
            agg = zk_rotate.aggregate_rotate_proof(zk, cfg, device=dev)
        torch.cuda.synchronize()
    finally:
        stages.HostTree.from_device = from_device
        stages.spill_codeword = spill
    t_agg = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    prog = progcache.get(aggregate._stmt_key(airs, cfg))[0]
    machine = MachineAir(prog)
    if (prog.n_rows, machine.log_n) != (724556, 20):
        raise AssertionError(f"machine program: {prog.n_rows} rows, log_n "
                             f"{machine.log_n} (want 724556, 20)")
    if "prove_streamed" not in timer.times:
        raise AssertionError("the machine proof did not take prove_streamed")
    cols = prover._commit_cols(machine)
    standing = cols * (machine.n << cfg.rate_bits) * 8
    t = timer.times
    log(f"phase 9: aggregate_rotate_proof: {t_agg:.3f} s; machine "
        f"{prog.n_rows} rows (log_n {machine.log_n}), {cols} committed "
        f"columns x 2^{machine.log_n + cfg.rate_bits} points "
        f"({standing / 2**30:.3f} GiB as standing LDEs), streamed; peak "
        f"device memory {peak / 2**30:.3f} GiB; host memory: HostTrees "
        f"{host['trees'] / 2**30:.3f} GiB, FRI codewords "
        f"{host['codewords'] / 2**30:.3f} GiB  [{card}]")
    log(f"phase 9: tape {t['_build_tape']:.3f} s, compile_tape "
        f"{t['compile_tape']:.3f} s, trace build "
        f"{t['MachineAir.build_trace']:.3f} s, constant columns "
        f"{t['MachineAir.constant_columns']:.3f} s, prove_streamed "
        f"{t['prove_streamed']:.3f} s (Poseidon permute {t['permute']:.3f} s,"
        f" {t['permute'] / t['prove_streamed'] * 100:.1f} % of it)  [{card}]")
    log(f"phase 9: stage seconds (stages overlap: NTT and Poseidon run "
        f"inside them, the coset stages inside prove_streamed): "
        f"{timer.summary()}  [{card}]")

    # accept first: the verifiers turn any exception into a rejection, so
    # a rejection counts only after the same verifier accepted
    t0 = time.perf_counter()
    ok = zk_rotate.verify_rotate_zk_aggregated(agg, auth, cfg, device=dev,
                                               rng=random.Random(10))
    t_ver = time.perf_counter() - t0
    if not ok:
        raise AssertionError("verify_rotate_zk_aggregated rejected the proof")
    launches = read_launches("aggregated rotate")
    t0 = time.perf_counter()
    bad = dataclasses.replace(agg, header_hash=bytes(32))
    if zk_rotate.verify_rotate_zk_aggregated(bad, auth, cfg, device=dev,
                                             rng=random.Random(10)):
        raise AssertionError("tampered header hash accepted")
    outer = proof_from_json(proof_to_json(agg.aggregated_proof))
    c0, c1 = outer.fri_proof.final_coeffs[0]
    outer.fri_proof.final_coeffs[0] = ((c0 + 1) % gl.P, c1)
    bad = dataclasses.replace(agg, aggregated_proof=outer)
    if zk_rotate.verify_rotate_zk_aggregated(bad, auth, cfg, device=dev,
                                             rng=random.Random(10)):
        raise AssertionError("tampered FRI final coefficient accepted")
    log(f"phase 9: verify_rotate_zk_aggregated accepted in {t_ver:.3f} s; "
        f"then a tampered header hash and a tampered FRI final coefficient "
        f"rejected ({time.perf_counter() - t0:.3f} s)  [{card}]")
    log(f"phase 9: kernel launches on the aggregated rotate path (component "
        f"proofs, aggregation and verifies): {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the operator loop and a circuit CLI
# ---------------------------------------------------------------------------

def contract_text(contract) -> str:
    """A contract's state and event list as canonical JSON text."""
    def enc(v):
        if isinstance(v, bytes):
            return v.hex()
        if isinstance(v, dict):
            return {(k.hex() if isinstance(k, bytes) else str(k)): enc(x)
                    for k, x in v.items()}
        return v

    fields = ("latest_block", "latest_authority_set_id", "frozen",
              "block_height_to_header_hash", "authority_set_id_to_hash",
              "data_root_commitments", "state_root_commitments",
              "range_start_blocks")
    state = {f: enc(getattr(contract, f)) for f in fields}
    state["events"] = [[e.name, enc(e.args)] for e in contract.events]
    return json.dumps(state, sort_keys=True)


def cli(name: str, args: list, cwd: str, **env) -> subprocess.Popen:
    """`python -m vectorx_tpu_torch.bin.<name>` started in `cwd`, the
    checkout on its path, `env` over this process's environment (no
    VECTORX_DEVICE of its own: the entry point's default)."""
    full = {k: v for k, v in os.environ.items() if k != "VECTORX_DEVICE"}
    full.update(PYTHONPATH=os.path.dirname(os.path.abspath(__file__)),
                VECTORX_BACKEND="fixture", **env)
    return subprocess.Popen(
        [sys.executable, "-m", f"vectorx_tpu_torch.bin.{name}", *args],
        cwd=cwd, env=full, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def operator_loop(dev, card: str) -> None:
    """tests/test_services.py's system: the operator loop through the
    non-ZK gateway on the card, across three rotations, against the same
    loop through the dummy gateway."""
    import torch

    from vectorx_tpu_torch.io.fixtures import FixtureChain
    from vectorx_tpu_torch.services import (OperatorConfig, VectorXContract,
                                            VectorXOperator, compute_genesis,
                                            make_gateway)

    chain = FixtureChain(seed=9, num_blocks=75, epoch_length=20,
                         authorities_per_era=lambda e: 4)

    def loop(**gateway):
        gw = make_gateway(chain, max_authority_set_size=8,
                          max_num_headers=16, **gateway)
        g = compute_genesis(chain, 4)
        contract = VectorXContract(
            gw, g.height, g.header_hash, g.authority_set_id,
            g.authority_set_hash, header_range_commitment_tree_size=16)
        op = VectorXOperator(contract, chain,
                             OperatorConfig(update_delay_blocks=10))
        fulfilled = 0
        for _ in range(30):
            op.run_once()
            while gw.pending:
                gw.fulfill_next()
                fulfilled += 1
            if contract.latest_block >= 70:
                break
        return contract, fulfilled

    t0 = time.perf_counter()
    real, fulfilled = loop(device=dev)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    dummy, _ = loop(dummy=True)
    if real.latest_block < 70 or not {1, 2, 3} <= set(
            real.authority_set_id_to_hash):
        raise AssertionError(f"the operator loop stopped at block "
                             f"{real.latest_block}")
    if contract_text(real) != contract_text(dummy):
        raise AssertionError("the operator loop through the card's gateway "
                             "!= the loop through the dummy gateway")
    log(f"phase 10: operator loop through make_gateway(device={dev}): "
        f"{fulfilled} requests fulfilled up to block {real.latest_block} "
        f"(sets {sorted(real.authority_set_id_to_hash)}), {len(real.events)} "
        f"events, in {t_loop:.3f} s; state and events == the dummy "
        f"gateway's loop  [{card}]")


def phase_services(dev, card: str) -> None:
    from vectorx_tpu_torch.circuits import DummyHeaderRange
    from vectorx_tpu_torch.config import Config, make_fetcher
    from vectorx_tpu_torch.hash.sha256 import chained_hash
    from vectorx_tpu_torch.io.abi import HeaderRangeInput

    # the input of (b) and (c): the longest range the fixture backend's
    # chain justifies within one set, in the deployment's 256-header tree
    fetcher = make_fetcher(Config())
    e = fetcher.epoch_length
    inp = HeaderRangeInput(e, fetcher.get_block_hash(e), 1,
                           chained_hash(fetcher.era_pubkeys(1)),
                           2 * e).encode()
    want = DummyHeaderRange(256).run(inp, fetcher)
    tmp = tempfile.mkdtemp(prefix="vectorx-cli-")
    for sub in ("cuda", "none"):
        os.mkdir(os.path.join(tmp, sub))
        with open(os.path.join(tmp, sub, "input.json"), "w") as f:
            json.dump({"data": {"input": "0x" + inp.hex()}}, f)
    # (c) the header_range_256 CLI with cuda asked for and no CUDA device
    # visible must exit non-zero; it uses no card, so it runs beside (a),
    # the operator loop
    t_none = time.perf_counter()
    none = cli("header_range_256", ["prove", "input.json"],
               os.path.join(tmp, "none"), VECTORX_DEVICE="cuda",
               CUDA_VISIBLE_DEVICES="")
    try:
        operator_loop(dev, card)

        # (b) the header_range_256 CLI on the fixture backend at the
        # deployment's tree, on its default device
        t0 = time.perf_counter()
        proc = cli("header_range_256", ["prove", "input.json"],
                   os.path.join(tmp, "cuda"))
        _, err = proc.communicate(timeout=300)
        t_cli = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"header_range_256 prove exited "
                                 f"{proc.returncode}: {err[-2000:]}")
        with open(os.path.join(tmp, "cuda", "output.json")) as f:
            got = json.load(f)["data"]["output"]
        if got != "0x" + want.hex():
            raise AssertionError("header_range_256 prove output != "
                                 "DummyHeaderRange(256) output")
        log(f"phase 10: python -m vectorx_tpu_torch.bin.header_range_256 "
            f"prove ({e} headers ({e}, {2 * e}] in the 256-header tree, "
            f"fixture backend, default device): output == "
            f"DummyHeaderRange(256), {t_cli:.3f} s for the process  "
            f"[{card}]")

        _, err = none.communicate(timeout=300)
        t_none = time.perf_counter() - t_none
        if none.returncode == 0 or os.path.exists(
                os.path.join(tmp, "none", "output.json")):
            raise AssertionError("header_range_256 with no visible CUDA "
                                 "device did not exit non-zero")
        log(f"phase 10: the same with VECTORX_DEVICE=cuda and "
            f"CUDA_VISIBLE_DEVICES=\"\" (started before (a), beside it): "
            f"exit {none.returncode}, {t_none:.3f} s after its start "
            f"({err.strip().splitlines()[-1]})")
    finally:
        if none.poll() is None:
            none.kill()
            none.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 11: the aggregated header_range, the public bind and zk_merkle, in a
# second process on the card
# ---------------------------------------------------------------------------

# The aggregated machine of phase 7's statement (rows, log_n), as the
# statement tape gives it on the CPU
HR_AGG_MACHINE = (469783, 19)
# Seconds since the start by which the phase-11, phase-12, host-check and
# host-justification processes must have ended (the script's limit is
# 1200 s)
PHASE11_DEADLINE_S = 1150

_HEX_FIELDS = ("input_bytes", "output_bytes", "headers", "header_hashes",
               "state_levels", "data_levels")
_JUSTIFICATION_HEX = ("signed_message", "pubkeys", "signatures", "block_hash")


def _hex(v):
    """bytes, and lists of them at any depth, as hex strings."""
    return v.hex() if isinstance(v, bytes) else [_hex(x) for x in v]


def _unhex(v):
    return bytes.fromhex(v) if isinstance(v, str) else [_unhex(x) for x in v]


def write_header_range_proof(proof, path: str) -> None:
    """Phase 7's `ZkHeaderRangeProof` as JSON: its public fields, its
    justification and its component proofs as the port's proof JSON."""
    from vectorx_tpu_torch.stark.serialize import proof_to_json

    just = dataclasses.asdict(proof.justification)
    d = {f: _hex(getattr(proof, f)) for f in _HEX_FIELDS}
    d.update(header_chunk_sizes=proof.header_chunk_sizes,
             sha_chunk_sizes=proof.sha_chunk_sizes,
             header_proofs=[proof_to_json(p) for p in proof.header_proofs],
             sha_proofs=[proof_to_json(p) for p in proof.sha_proofs],
             justification={k: _hex(v) if k in _JUSTIFICATION_HEX else v
                            for k, v in just.items()})
    with open(path, "w") as f:
        json.dump(d, f)


def read_header_range_proof(path: str):
    from vectorx_tpu_torch.circuits.zk_header_range import ZkHeaderRangeProof
    from vectorx_tpu_torch.io.fixtures import JustificationData
    from vectorx_tpu_torch.stark.serialize import proof_from_json

    with open(path) as f:
        d = json.load(f)
    just = {k: _unhex(v) if k in _JUSTIFICATION_HEX else v
            for k, v in d["justification"].items()}
    return ZkHeaderRangeProof(
        **{f: _unhex(d[f]) for f in _HEX_FIELDS},
        header_chunk_sizes=d["header_chunk_sizes"],
        sha_chunk_sizes=d["sha_chunk_sizes"],
        header_proofs=[proof_from_json(p) for p in d["header_proofs"]],
        sha_proofs=[proof_from_json(p) for p in d["sha_proofs"]],
        justification=JustificationData(**just))


def phase_aggregated_header_range(dev, card: str, zk, cfg) -> dict:
    """Phase 7's component proofs folded into one machine proof on the
    card, stage-timed; the aggregated verifier accepts it, then rejects a
    tampered header hash, a tampered FRI final coefficient and the state
    and data trees' child statements swapped.  Returns the launches of
    the aggregation and its verify."""
    import torch

    from vectorx_tpu_torch.circuits import zk_header_range as zhr
    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.io.abi import HeaderRangeOutput
    from vectorx_tpu_torch.recursion import aggregate, progcache
    from vectorx_tpu_torch.recursion.machine import MachineAir
    from vectorx_tpu_torch.stark import prover
    from vectorx_tpu_torch.stark.serialize import (proof_from_json,
                                                   proof_to_json)

    tree = 2 * len(zk.state_levels[0])
    airs = zhr.aggregate_children(zk)
    log(f"phase 11: aggregated header_range of phase 7's proof (tree "
        f"{tree}, {len(zk.justification.pubkeys)} authorities, "
        f"FriConfig()): children (AIR, log_n, width) "
        f"{[(type(a).__name__, a.log_n, a.width) for a in airs]}")
    timer = StageTimer(extra=[
        (aggregate, "_build_tape"), (aggregate, "compile_tape"),
        (MachineAir, "build_trace"), (MachineAir, "constant_columns"),
        (prover, "prove_streamed")])
    orig_prove, stage = aggregate.prove, {}

    def machine_prove(*a, **kw):
        # the machine proof alone, and the Poseidon seconds inside it
        p0 = timer.times.get("permute", 0.0)
        t0 = time.perf_counter()
        out = orig_prove(*a, **kw)
        torch.cuda.synchronize()
        stage["prove"] = time.perf_counter() - t0
        stage["permute"] = timer.times.get("permute", 0.0) - p0
        return out

    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    aggregate.prove = machine_prove
    t0 = time.perf_counter()
    try:
        with timer:
            agg = zhr.aggregate_header_range_proof(zk, cfg, device=dev)
        torch.cuda.synchronize()
    finally:
        aggregate.prove = orig_prove
    t_agg = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    prog = progcache.get(aggregate._stmt_key(airs, cfg))[0]
    machine = MachineAir(prog)
    cols = prover._commit_cols(machine)
    streamed = "prove_streamed" in timer.times
    t = timer.times
    log(f"phase 11: aggregate_header_range_proof: {t_agg:.3f} s; machine "
        f"{prog.n_rows} rows (log_n {machine.log_n}; predicted "
        f"{HR_AGG_MACHINE[0]}, {HR_AGG_MACHINE[1]}), "
        f"{cols} committed columns x 2^{machine.log_n + cfg.rate_bits} "
        f"points, {'streamed' if streamed else 'not streamed'}; peak device "
        f"memory {peak / 2**30:.3f} GiB  [{card}]")
    log(f"phase 11: tape {t['_build_tape']:.3f} s, compile_tape "
        f"{t['compile_tape']:.3f} s, trace build "
        f"{t['MachineAir.build_trace']:.3f} s, constant columns "
        f"{t['MachineAir.constant_columns']:.3f} s, prove "
        f"{stage['prove']:.3f} s (Poseidon permute {stage['permute']:.3f} s, "
        f"{stage['permute'] / stage['prove'] * 100:.1f} % of it)  [{card}]")
    log(f"phase 11: stage seconds (stages overlap: NTT and Poseidon run "
        f"inside them): {timer.summary()}  [{card}]")
    if (prog.n_rows, machine.log_n) != HR_AGG_MACHINE:
        raise AssertionError(f"machine program: {prog.n_rows} rows, log_n "
                             f"{machine.log_n} (want {HR_AGG_MACHINE})")

    # accept first: the verifier turns any exception into a rejection, so
    # a rejection counts only after the same verifier accepted
    t0 = time.perf_counter()
    ok = zhr.verify_header_range_zk_aggregated(agg, tree, cfg, device=dev,
                                               rng=random.Random(11))
    t_ver = time.perf_counter() - t0
    if not ok:
        raise AssertionError("verify_header_range_zk_aggregated rejected the "
                             "proof")
    launches = read_launches("aggregated header_range")
    t0 = time.perf_counter()
    bad = dataclasses.replace(
        agg, header_hashes=[bytes(32)] + list(agg.header_hashes[1:]))
    if zhr.verify_header_range_zk_aggregated(bad, tree, cfg, device=dev,
                                             rng=random.Random(11)):
        raise AssertionError("tampered header hash accepted")
    outer = proof_from_json(proof_to_json(agg.aggregated_proof))
    c0, c1 = outer.fri_proof.final_coeffs[0]
    outer.fri_proof.final_coeffs[0] = ((c0 + 1) % gl.P, c1)
    bad = dataclasses.replace(agg, aggregated_proof=outer)
    if zhr.verify_header_range_zk_aggregated(bad, tree, cfg, device=dev,
                                             rng=random.Random(11)):
        raise AssertionError("tampered FRI final coefficient accepted")
    # the state tree's SHA-256 children claim the data tree's digests and
    # the other way round: the public wiring holds (the output's roots are
    # swapped too), only the machine proof's child statements differ
    out = HeaderRangeOutput.decode(agg.output_bytes)
    bad = dataclasses.replace(
        agg, state_levels=agg.data_levels, data_levels=agg.state_levels,
        output_bytes=HeaderRangeOutput(
            out.target_header_hash, out.data_root_commitment,
            out.state_root_commitment).encode())
    if zhr.verify_header_range_zk_aggregated(bad, tree, cfg, device=dev,
                                             rng=random.Random(11)):
        raise AssertionError("swapped child statements accepted")
    log(f"phase 11: verify_header_range_zk_aggregated accepted in "
        f"{t_ver:.3f} s; then a tampered header hash, a tampered FRI final "
        f"coefficient and the state and data trees' child statements "
        f"swapped rejected ({time.perf_counter() - t0:.3f} s)  [{card}]")
    log(f"phase 11: kernel launches on the aggregated header_range path "
        f"(aggregation and verify): {launches}")
    return launches


def phase_public_bind(dev, card: str, zk, cfg, out_dir: str) -> dict:
    """The public-bind statements of `public_bind_statements` proved and
    verified on the card (their proof JSON goes to `out_dir`, for the
    parent to hold against the CPU's), a changed message limb and digest
    limb rejected, `public_shape`'s constant columns equal to the full
    AIR's; then `prove_merkle_root` over phase 7's 16 state roots.
    Returns the launches of this path."""
    import numpy as np
    import torch

    from vectorx_tpu_torch.circuits.subchain import decode_header_fields
    from vectorx_tpu_torch.circuits.zk_merkle import (prove_merkle_root,
                                                      verify_merkle_root)
    from vectorx_tpu_torch.io.abi import HeaderRangeOutput
    from vectorx_tpu_torch.merkle import sha256_merkle_root
    from vectorx_tpu_torch.stark import prove, verify

    reset_launches()
    for name, air, shape in public_bind_statements(zk.headers):
        t0 = time.perf_counter()
        proof = prove(air, air.build_trace(), cfg, device=dev)
        torch.cuda.synchronize()
        t_prove = time.perf_counter() - t0
        t0 = time.perf_counter()
        if not verify(air, proof, cfg, device=dev):
            raise AssertionError(f"public-bind {name}: verify rejected")
        t_verify = time.perf_counter() - t0
        text = proof_text(proof)
        with open(os.path.join(out_dir, f"public_{name}.json"), "w") as f:
            f.write(text)
        for idx in (1, -1):   # a message limb; a digest limb
            bad = type(air)(air.messages, bind="public")
            pubs = bad.public_inputs()
            pubs[idx] = (pubs[idx] + 1) % (1 << 32)
            bad.public_inputs = lambda p=pubs: p
            if verify(bad, proof, cfg, device=dev):
                raise AssertionError(f"public-bind {name}: changed public "
                                     f"{idx} accepted")
        if not np.array_equal(type(air).public_shape(shape)
                              .constant_columns(), air.constant_columns()):
            raise AssertionError(f"public-bind {name}: public_shape's "
                                 f"constant columns != the full AIR's")
        log(f"phase 11: {name}(bind=\"public\") over {len(shape)} messages "
            f"(log_n {air.log_n}, {len(air.public_inputs())} publics, "
            f"FriConfig()): prove {t_prove:.3f} s, verify {t_verify:.3f} s; "
            f"a changed message limb and digest limb rejected; public_shape"
            f"({shape}) gives the same constant columns  [{card}]")

    leaves = [decode_header_fields(h, len(h)).state_root for h in zk.headers]
    t0 = time.perf_counter()
    mp = prove_merkle_root(leaves, cfg, device=dev)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    want = HeaderRangeOutput.decode(zk.output_bytes).state_root_commitment
    if not mp.root == sha256_merkle_root(leaves) == want:
        raise AssertionError("prove_merkle_root: root != sha256_merkle_root")
    t0 = time.perf_counter()
    if not verify_merkle_root(mp, cfg, device=dev):
        raise AssertionError("verify_merkle_root rejected the proof")
    t_verify = time.perf_counter() - t0
    launches = read_launches("public bind and zk_merkle")
    if verify_merkle_root(dataclasses.replace(mp, root=bytes(32)), cfg,
                          device=dev):
        raise AssertionError("zk_merkle: tampered root accepted")
    log(f"phase 11: prove_merkle_root over phase 7's {len(leaves)} state "
        f"roots ({len(mp.node_proofs)} SHA-256 chunk proof, "
        f"{sum(mp.chunk_sizes)} nodes): root == sha256_merkle_root == the "
        f"output's state commitment, prove {t_prove:.3f} s, verify "
        f"{t_verify:.3f} s; a tampered root rejected  [{card}]")
    log(f"phase 11: kernel launches on the public-bind and zk_merkle path: "
        f"{launches}")
    return launches


def phase11_child(path: str) -> dict:
    """`chip_smoke.py --phase-11 <dir>`: phase 11 on the card, from phase
    7's proof in `<dir>`; returns its launches and its seconds (imports
    included) for the last line."""
    t_start = time.perf_counter()
    import torch

    from vectorx_tpu_torch.config import Config, require_device
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.stark import StarkConfig

    dev = require_device(Config())
    card = card_line()
    cuda_ntt.load()
    zk = read_header_range_proof(os.path.join(path, "header_range.json"))
    log(f"phase 11: process on {torch.cuda.get_device_name(dev)}: phase 7's "
        f"proof read in {time.perf_counter() - t_start:.2f} s")
    cfg = StarkConfig(fri=FriConfig())
    agg = phase_aggregated_header_range(dev, card, zk, cfg)
    pb = phase_public_bind(dev, card, zk, cfg, path)
    return {"aggregated": agg, "public_bind": pb,
            "seconds": time.perf_counter() - t_start}


class CardPhase:
    """Phase `phase` in a process of its own on the card (`chip_smoke.py
    --phase-<phase> <dir>`), run beside the parent's phases (both are
    mostly host-bound).  Its output goes to files in `<dir>`; `result`
    waits for it, relays its lines and raises on a non-zero exit, a
    missing result line or a timeout."""

    def __init__(self, phase: int, t_start: float, beside: str):
        self.phase, self.beside = phase, beside
        self.relayed = False
        self.started = time.perf_counter() - t_start
        # the script's start on the wall clock, which the process shares
        self.epoch0 = time.time() - self.started
        self.dir = tempfile.mkdtemp(prefix=f"vectorx-phase{phase}-")
        self.prepare()
        self.out = open(os.path.join(self.dir, "stdout"), "w+")
        self.err = open(os.path.join(self.dir, "stderr"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), f"--phase-{phase}",
             self.dir], stdout=self.out, stderr=self.err,
            env=dict(os.environ, **self.env()))

    def prepare(self) -> None:
        """Files the process reads from its directory."""

    def env(self) -> dict:
        """Environment variables the process gets beside the parent's."""
        return {}

    def result(self, timeout: float) -> dict:
        t0 = time.perf_counter()
        what = f"the phase-{self.phase} process"
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(f"{what} did not end within {timeout:.0f} s")
        finally:
            self.relayed = True
            self.out.seek(0)
            lines = self.out.read().splitlines()
            for line in lines[:-1]:
                log(line)
        if self.proc.returncode != 0:
            self.err.seek(0)
            sys.stderr.write(self.err.read()[-4000:])
            raise AssertionError(f"{what} failed (exit "
                                 f"{self.proc.returncode})")
        try:
            res = json.loads(lines[-1])[f"phase {self.phase}"]
        except (IndexError, ValueError, KeyError):
            raise AssertionError(f"{what} printed no result line")
        log(f"phase {self.phase}: the process, started {self.started:.1f} s "
            f"since the start, ran {res['seconds']:.2f} s beside "
            f"{self.beside} (its work from {res['t0'] - self.epoch0:.1f} to "
            f"{res['t1'] - self.epoch0:.1f} s since the start); waited "
            f"{time.perf_counter() - t0:.2f} s for it")
        return res

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.relayed:
            # the script failed before waiting for this process: show how
            # far it got
            self.out.seek(0)
            for line in self.out.read().splitlines():
                log(f"(phase {self.phase}, stopped) {line}")
        self.out.close()
        self.err.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def _time_left(t_start: float) -> float:
    """Seconds left until `PHASE11_DEADLINE_S`, at least one."""
    return max(PHASE11_DEADLINE_S - (time.perf_counter() - t_start), 1.0)


class Phase11(CardPhase):
    """Phase 11, started as soon as phase 7 has its proof, beside phases
    8-10."""

    def __init__(self, proof, t_start: float):
        self.proof = proof
        super().__init__(11, t_start, "phases 8-10")

    def prepare(self) -> None:
        write_header_range_proof(self.proof, os.path.join(
            self.dir, "header_range.json"))

    def finish(self, host: HostChecks, t_start: float) -> dict:
        """Wait for this process and then for the host-check process's
        public-bind proofs, both by `PHASE11_DEADLINE_S`; the card's
        public-bind proof JSON must equal the CPU's.  Returns phase 11's
        launches."""
        launches = self.result(timeout=_time_left(t_start))
        for name, secs in host.public_bind(
                timeout=_time_left(t_start)).items():
            with open(os.path.join(self.dir, f"public_{name}.json")) as f:
                card_text = f.read()
            with open(host.proof_path("public", name)) as f:
                if f.read() != card_text:
                    raise AssertionError(f"public-bind {name}: the card's "
                                         f"proof != the CPU's")
            log(f"phase 11: public-bind {name} proof JSON on the card == the "
                f"CPU's from the host-check process ({len(card_text)} bytes; "
                f"CPU prove {secs:.2f} s)")
        return launches


# ---------------------------------------------------------------------------
# Phase 12: the in-ZK GRANDPA justification, in a third process on the card
# ---------------------------------------------------------------------------

# The fixture chain's authorities per era: 16 of 20 sign, one full ladder
# chunk (the deployment's 300 authorities, 240 signers, take 15)
JUSTIFICATION_AUTHORITIES = 20
# (AIR, log_n, width, streamed) of the statement's component proofs at
# FriConfig(), as their shapes give them on the CPU: the 20-step SHA-256
# commitment chain, the SHA-512 chunk of 16 challenge messages (2 blocks
# each), the ladder chunk of 16 signatures (its 5763 committed columns x
# 2^17 points pass the 2^29 streaming bound)
JUSTIFICATION_CHILDREN = [("Sha256Air", 12, 299, False),
                          ("Sha512Air", 12, 598, False),
                          ("Ed25519LadderAir", 14, 3520, True)]


def justification_statement():
    """(JustificationData, authority set hash) of the fixture chain at
    `JUSTIFICATION_AUTHORITIES` authorities (block 3)."""
    from vectorx_tpu_torch.hash.sha256 import chained_hash
    from vectorx_tpu_torch.io.fixtures import FixtureChain

    chain = FixtureChain(seed=23, num_blocks=8, epoch_length=4,
                         authorities_per_era=lambda e:
                         JUSTIFICATION_AUTHORITIES)
    j = chain.get_justification(3)
    return j, chained_hash(chain.era_pubkeys(j.authority_set_id))


def toy_ladder_signature():
    """`tests/test_ed25519_ladder.py::make_instance()`: [173]B = R + [89]A
    with A = [12345]B."""
    from vectorx_tpu_torch.curves import ed25519 as ed

    a_pt = ed.scalar_mult(12345, ed.B_POINT)
    ha = ed.scalar_mult(89, a_pt)
    neg_ha = ((ed.Q - ha[0]) % ed.Q, ha[1], ha[2], (ed.Q - ha[3]) % ed.Q)
    r_pt = ed.point_add(ed.scalar_mult(173, ed.B_POINT), neg_ha)
    return (ed.point_compress(a_pt), ed.point_compress(r_pt), 173, 89)


def justification_cpu_statements():
    """(name, AIR, config) of the proofs phase 12 holds against the CPU's:
    the statement's SHA-512 chunk at FriConfig(), and the nbits=8 ladder of
    `tests/test_ed25519_ladder.py` at that test's config.  A 253-bit ladder
    of one signature (log_n 10) has twice its LDE points, so twice its CPU
    Poseidon (minutes already at nbits=8), which the host-justification
    process has no time for."""
    from vectorx_tpu_torch.circuits import zk_justification as zkj
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.stark import StarkConfig
    from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir
    from vectorx_tpu_torch.stark.sha512_air import Sha512Air

    j, _ = justification_statement()
    msgs = zkj.challenge_messages(j.pubkeys, j.signatures, j.signed_message,
                                  zkj._enabled_indices(j))
    return [("sha512_chunk", Sha512Air(msgs), StarkConfig(fri=FriConfig())),
            ("ladder_nbits8", Ed25519LadderAir([toy_ladder_signature()],
                                               nbits=8), small_config(0))]


class ProveRecorder:
    """While active, wraps `prove` in each of `modules`: every call's AIR,
    log_n, width, whether it streamed, its seconds and its Poseidon
    seconds (from `timer`, which must be active around it)."""

    def __init__(self, modules, timer: StageTimer):
        self.modules, self.timer, self.calls = modules, timer, []
        self._saved = []

    def __enter__(self):
        import torch

        from vectorx_tpu_torch.stark import prover

        for mod in self.modules:
            orig = mod.prove

            def prove(air, trace, config, *, device, _orig=orig):
                p0 = self.timer.times.get("permute", 0.0)
                t0 = time.perf_counter()
                out = _orig(air, trace, config, device=device)
                torch.cuda.synchronize()
                program = getattr(air, "program", None)
                self.calls.append(dict(
                    air=type(air).__name__, log_n=air.log_n,
                    width=air.width,
                    streamed=prover._use_streaming(air, config),
                    seconds=time.perf_counter() - t0,
                    poseidon=self.timer.times.get("permute", 0.0) - p0,
                    rows=program.n_rows if program is not None else None))
                return out

            self._saved.append((mod, orig))
            mod.prove = prove
        return self

    def __exit__(self, *exc):
        for mod, orig in self._saved:
            mod.prove = orig
        self._saved.clear()


def phase_justification(dev, card: str, cfg, out_dir: str) -> dict:
    """`prove_justification_zk` of `justification_statement` on the card,
    stage-timed, each component proof timed with its Poseidon seconds;
    `verify_justification_zk` accepts it, then rejects a tampered
    challenge digest, a forged S, a `validator_signed` list under the
    threshold and a tampered FRI final coefficient of the ladder proof.
    The SHA-512 chunk's proof JSON goes to `out_dir`.  Returns the
    launches of the prove and its verify."""
    import torch

    from vectorx_tpu_torch.circuits import zk_commitment
    from vectorx_tpu_torch.circuits import zk_justification as zkj
    from vectorx_tpu_torch.curves.ed25519 import L
    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.stark import prover, stages
    from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir
    from vectorx_tpu_torch.stark.serialize import (proof_from_json,
                                                   proof_to_json)
    from vectorx_tpu_torch.stark.sha512_air import Sha512Air

    j, set_hash = justification_statement()
    log(f"phase 12: in-ZK justification of the fixture chain at "
        f"{j.num_authorities} authorities ({sum(j.validator_signed)} "
        f"signers, block {j.block_number}), FriConfig()")
    timer = StageTimer(extra=[
        (Sha512Air, "build_trace"), (Ed25519LadderAir, "build_trace"),
        (prover, "prove_streamed"), (stages, "commit_streamed"),
        (stages, "coset_eval_rows"), (stages, "deep_compose_coset")])
    rec = ProveRecorder([zkj, zk_commitment], timer)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with timer, rec:
        zk = zkj.prove_justification_zk(j, set_hash, cfg, device=dev)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    permute = timer.times.get("permute", 0.0)
    log(f"phase 12: prove_justification_zk: {t_prove:.3f} s (Poseidon "
        f"permute {permute:.3f} s, {permute / t_prove * 100:.1f} %), peak "
        f"device memory {peak / 2**30:.3f} GiB; chunks: SHA-512 "
        f"{zk.sha_chunk_sizes}, ladder {zk.ladder_chunk_sizes}  [{card}]")
    for c in rec.calls:
        log(f"phase 12:   {c['air']} (log_n {c['log_n']}, {c['width']} "
            f"columns, {'streamed' if c['streamed'] else 'not streamed'}): "
            f"prove {c['seconds']:.3f} s, Poseidon {c['poseidon']:.3f} s  "
            f"[{card}]")
    log(f"phase 12: stage seconds (stages overlap: NTT and Poseidon run "
        f"inside them): {timer.summary()}  [{card}]")
    shapes = [(c['air'], c['log_n'], c['width'], c['streamed'])
              for c in rec.calls]
    signed = [sum(j.validator_signed)]
    if shapes != JUSTIFICATION_CHILDREN or zk.sha_chunk_sizes != signed \
            or zk.ladder_chunk_sizes != signed:
        raise AssertionError(f"justification children {shapes}, chunks "
                             f"{zk.sha_chunk_sizes} / {zk.ladder_chunk_sizes}")
    with open(os.path.join(out_dir, "justification_sha512_chunk.json"),
              "w") as f:
        f.write(proof_text(zk.sha_proofs[0]))

    def verify(p):
        return zkj.verify_justification_zk(
            p, j.block_number, j.block_hash, j.authority_set_id, set_hash,
            cfg, device=dev)

    # accept first: the verifier turns any exception into a rejection, so
    # a rejection counts only after the same verifier accepted
    t0 = time.perf_counter()
    if not verify(zk):
        raise AssertionError("verify_justification_zk rejected the proof")
    t_ver = time.perf_counter() - t0
    launches = read_launches("justification")
    log(f"phase 12: verify_justification_zk accepted in {t_ver:.3f} s; "
        f"kernel launches on the justification path (prove and verify): "
        f"{launches}  [{card}]")
    first = zkj._enabled_indices(j)[0]
    s_int = int.from_bytes(zk.signatures[first][32:], "little")
    s_bad = s_int ^ 1 if s_int ^ 1 < L else s_int - 1
    sigs = list(zk.signatures)
    sigs[first] = sigs[first][:32] + s_bad.to_bytes(32, "little")
    n = zk.num_authorities
    under = [i < (2 * n) // 3 for i in range(len(zk.validator_signed))]
    lp = proof_from_json(proof_to_json(zk.ladder_proofs[0]))
    c0, c1 = lp.fri_proof.final_coeffs[0]
    lp.fri_proof.final_coeffs[0] = ((c0 + 1) % gl.P, c1)
    for what, bad in (
            ("a tampered challenge digest", dataclasses.replace(
                zk, challenge_digests=[b"\xff" * 64]
                + zk.challenge_digests[1:])),
            ("a forged S in the statement", dataclasses.replace(
                zk, signatures=sigs)),
            (f"validator_signed with {sum(under)} of {n}", dataclasses.replace(
                zk, validator_signed=under)),
            ("a tampered FRI final coefficient of the ladder proof",
             dataclasses.replace(zk, ladder_proofs=[lp]))):
        t0 = time.perf_counter()
        if verify(bad):
            raise AssertionError(f"verify_justification_zk accepted {what}")
        log(f"phase 12: {what} rejected ({time.perf_counter() - t0:.3f} s)")
    return launches


def phase_ladder_identity(dev, card: str, out_dir: str) -> None:
    """The nbits=8 ladder of `justification_cpu_statements` proved and
    verified on the card, a forged scalar and pubkey rejected; its proof
    JSON goes to `out_dir`."""
    import torch

    from vectorx_tpu_torch.curves import ed25519 as ed
    from vectorx_tpu_torch.stark import prove, verify
    from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir

    _, air, cfg = justification_cpu_statements()[1]
    sig = air.sigs[0]
    t0 = time.perf_counter()
    proof = prove(air, air.build_trace(), cfg, device=dev)
    torch.cuda.synchronize()
    t_prove = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not verify(Ed25519LadderAir.statement([sig], nbits=8), proof, cfg,
                  device=dev):
        raise AssertionError("ladder nbits=8: verify rejected the proof")
    t_ver = time.perf_counter() - t0
    other = ed.point_compress(ed.scalar_mult(999, ed.B_POINT))
    for what, forged in (("scalar", (sig[0], sig[1], sig[2] ^ 1, sig[3])),
                         ("pubkey", (other, *sig[1:]))):
        if verify(Ed25519LadderAir.statement([forged], nbits=8), proof, cfg,
                  device=dev):
            raise AssertionError(f"ladder nbits=8: forged {what} accepted")
    with open(os.path.join(out_dir, "justification_ladder_nbits8.json"),
              "w") as f:
        f.write(proof_text(proof))
    log(f"phase 12: ladder nbits=8 (tests/test_ed25519_ladder.py, log_n "
        f"{air.log_n}, its config): prove {t_prove:.3f} s, verify "
        f"{t_ver:.3f} s; a forged scalar and pubkey rejected  [{card}]")


def phase12_child(path: str) -> dict:
    """`chip_smoke.py --phase-12 <dir>`: phase 12 on the card; returns its
    launches and its seconds (imports included) for the last line."""
    t_start = time.perf_counter()
    import torch

    from vectorx_tpu_torch.config import Config, require_device
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.stark import StarkConfig

    dev = require_device(Config())
    card = card_line()
    cuda_ntt.load()
    log(f"phase 12: process on {torch.cuda.get_device_name(dev)}")
    launches = phase_justification(dev, card, StarkConfig(fri=FriConfig()),
                                   path)
    phase_ladder_identity(dev, card, path)
    return {"justification": launches,
            "seconds": time.perf_counter() - t_start}


class Phase12(CardPhase):
    """Phase 12, started after phase 2, beside phases 3-11."""

    def __init__(self, t_start: float):
        super().__init__(12, t_start, "phases 3-11")

    def finish(self, host: HostChecks, t_start: float) -> dict:
        """Wait for this process and then for the host-justification
        process's proofs, both by `PHASE11_DEADLINE_S`; the card's
        proof JSON must equal the CPU's.  Returns phase 12's launches."""
        launches = self.result(timeout=_time_left(t_start))
        for name, secs in host.justification(
                timeout=_time_left(t_start)).items():
            with open(os.path.join(self.dir,
                                   f"justification_{name}.json")) as f:
                card_text = f.read()
            with open(host.proof_path("justification", name)) as f:
                if f.read() != card_text:
                    raise AssertionError(f"justification {name}: the card's "
                                         f"proof != the CPU's")
            log(f"phase 12: {name} proof JSON on the card == the CPU's from "
                f"the host-justification process ({len(card_text)} bytes; "
                f"CPU prove {secs:.2f} s)")
        return launches


# ---------------------------------------------------------------------------
# Phases 13 and 14: the succinct header_range and rotate, each in a process
# of its own on the card
# ---------------------------------------------------------------------------

# phase 7's header mix at tree 2 (the deployment's is 256) and 4 of the
# deployment's 300 authorities (3 signers)
SUCCINCT_TREE, SUCCINCT_AUTH = 2, 4
# Seconds since the start by which the phase-13 and phase-14 processes
# must have ended (`--succinct`)
SUCCINCT_DEADLINE_S = 1150


class VerifyWatch:
    """While active, watches what the succinct verifiers run under their
    catch-all: the statement program (`progcache.cached_program`) and the
    STARK verify.  `reached` says the STARK verify ran; `raised` holds
    what either raised, which the verifier turned into a rejection."""

    def __enter__(self):
        from vectorx_tpu_torch.circuits import succinct_header_range as shr
        from vectorx_tpu_torch.recursion import progcache

        self.reached, self.raised = False, []
        self._saved = [(shr, "verify", shr.verify),
                       (progcache, "cached_program",
                        progcache.cached_program)]
        for mod, attr, orig in self._saved:
            def watched(*a, _orig=orig, _stark=mod is shr, **kw):
                self.reached = self.reached or _stark
                try:
                    return _orig(*a, **kw)
                except Exception as e:
                    self.raised.append(e)
                    raise
            setattr(mod, attr, watched)
        return self

    def __exit__(self, *exc):
        import torch

        for mod, attr, orig in self._saved:
            setattr(mod, attr, orig)
        torch.cuda.synchronize()    # a pending device error raises here


def rejects(what: str, verify_fn, *, stark: bool) -> None:
    """Raise unless `verify_fn()` is False for the reason named: from the
    STARK verify (`stark`) or from the host checks before any STARK work,
    and with nothing under the verifier raised."""
    with VerifyWatch() as w:
        ok = verify_fn()
    if ok:
        raise AssertionError(f"accepted {what}")
    if w.raised:
        raise AssertionError(f"{what}: rejected only because "
                             f"{w.raised[0]!r} was raised")
    if w.reached != stark:
        raise AssertionError(f"{what}: rejected {'before' if stark else 'by'}"
                             f" the STARK verify, expected "
                             f"{'by' if stark else 'before'} it")


def succinct_timers(extra_targets):
    """A StageTimer over the succinct prover's host stages."""
    from vectorx_tpu_torch.circuits import succinct_header_range as shr
    from vectorx_tpu_torch.recursion.machine import MachineAir
    from vectorx_tpu_torch.stark import prover, stages
    from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir
    from vectorx_tpu_torch.stark.sha512_air import Sha512Air

    return StageTimer(extra=[
        *extra_targets, (shr, "compile_tape"), (MachineAir, "build_trace"),
        (MachineAir, "constant_columns"), (Sha512Air, "build_trace"),
        (Ed25519LadderAir, "build_trace"), (prover, "prove_streamed"),
        (stages, "commit_streamed"), (stages, "coset_eval_rows"),
        (stages, "deep_compose_coset")])


def report_succinct(phase: int, what: str, rec: ProveRecorder,
                    timer: StageTimer, t_prove: float, peak: int,
                    tape: str, card: str) -> dict:
    """Log the prove's stage seconds; returns the machine's row count,
    log_n and whether it streamed."""
    *children, m = rec.calls
    if m["air"] != "MachineAir":
        raise AssertionError(f"phase {phase}: the last proof is a {m['air']}")
    t = timer.times
    log(f"phase {phase}: {what}: prove {t_prove:.3f} s (Poseidon permute "
        f"{t['permute']:.3f} s, {t['permute'] / t_prove * 100:.1f} %), peak "
        f"device memory {peak / 2**30:.3f} GiB, {len(children)} child "
        f"proofs  [{card}]")
    for c in children:
        log(f"phase {phase}:   {c['air']} (log_n {c['log_n']}, {c['width']} "
            f"columns, {'streamed' if c['streamed'] else 'not streamed'}): "
            f"prove {c['seconds']:.3f} s, Poseidon {c['poseidon']:.3f} s  "
            f"[{card}]")
    log(f"phase {phase}: machine: {m['rows']} rows (log_n {m['log_n']}, "
        f"{m['width']} columns, "
        f"{'streamed' if m['streamed'] else 'not streamed'}"
        f"); tape {t[tape]:.3f} s (child proofs' verification replayed "
        f"on it), compile_tape {t['compile_tape']:.3f} s, trace "
        f"{t['MachineAir.build_trace']:.3f} s, constant columns "
        f"{t['MachineAir.constant_columns']:.3f} s, machine prove "
        f"{m['seconds']:.3f} s (Poseidon {m['poseidon']:.3f} s, "
        f"{m['poseidon'] / m['seconds'] * 100:.1f} %)  [{card}]")
    log(f"phase {phase}: stage seconds (stages overlap: NTT and Poseidon run "
        f"inside them): {timer.summary()}  [{card}]")
    return {"rows": m["rows"], "log_n": m["log_n"],
            "streamed": m["streamed"]}


def timed_gateway(gw, fid, dev, rec, timer, seen: dict):
    """Re-register function `fid` of `gw` with its prover run under
    `rec` and `timer` and both sides timed into `seen`; returns the
    gateway's own verifier."""
    import torch

    prove_fn, verify_fn = gw.provers[fid]

    def timed_prover(i):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with timer, rec:
            seen["out"], seen["proof"] = prove_fn(i)
        torch.cuda.synchronize()
        seen["prove"] = time.perf_counter() - t0
        seen["peak"] = torch.cuda.max_memory_allocated(dev)
        return seen["out"], seen["proof"]

    def timed_verifier(i, out, p):
        t0 = time.perf_counter()
        ok = verify_fn(i, out, p)
        seen["verify"] = time.perf_counter() - t0
        return ok

    gw.register_prover(fid, timed_prover, timed_verifier)
    return verify_fn


def tampered_machine_fri(proof):
    """`proof` with its machine proof's first FRI final coefficient + 1."""
    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.stark.serialize import (proof_from_json,
                                                   proof_to_json)

    mp = proof_from_json(proof_to_json(proof.machine_proof))
    c0, c1 = mp.fri_proof.final_coeffs[0]
    mp.fri_proof.final_coeffs[0] = ((c0 + 1) % gl.P, c1)
    return dataclasses.replace(proof, machine_proof=mp)


def phase_succinct_header_range(dev, card: str, cfg, out_dir: str) -> dict:
    """Phase 13: the succinct header_range through the port's contract and
    `make_gateway(zk="succinct")`; the cold-cache verify; then the
    rejections.  Returns the launches of the gateway's prove and verify."""
    import torch

    from vectorx_tpu_torch.circuits import DummyHeaderRange
    from vectorx_tpu_torch.circuits import succinct_header_range as shr
    from vectorx_tpu_torch.hash.sha256 import chained_hash
    from vectorx_tpu_torch.io.abi import HeaderRangeInput
    from vectorx_tpu_torch.recursion import progcache
    from vectorx_tpu_torch.services import (ContractError, MockGateway,
                                            VectorXContract, make_gateway,
                                            range_key)
    from vectorx_tpu_torch.stark import vk

    tree, auth = SUCCINCT_TREE, SUCCINCT_AUTH
    chain, trusted, target = header_range_chain(tree, auth)
    set_hash = chained_hash(chain.era_pubkeys(1))
    inp = HeaderRangeInput(trusted, chain.get_block_hash(trusted), 1,
                           set_hash, target).encode()
    want = DummyHeaderRange(tree).run(inp, chain)
    sizes = [len(chain.get_encoded_header(b))
             for b in range(trusted + 1, target + 1)]
    log(f"phase 13: succinct header_range of blocks ({trusted}, {target}] "
        f"(headers {sizes} B), {auth} authorities, tree {tree}, FriConfig()")
    gw = make_gateway(chain, max_num_headers=tree, zk="succinct",
                      stark_config=cfg, device=dev)
    contract = VectorXContract(gw, trusted, chain.get_block_hash(trusted), 1,
                               set_hash, header_range_commitment_tree_size=tree)
    fid = contract.header_range_function_id
    timer = succinct_timers([(shr, "_range_tape")])
    rec, seen = ProveRecorder([shr], timer), {}
    gw_verify = timed_gateway(gw, fid, dev, rec, timer, seen)
    contract.request_header_range(1, target)
    if gw.pending[0][1] != inp:
        raise AssertionError("the contract's request != phase 13's input")
    reset_launches()
    t0 = time.perf_counter()
    gw.fulfill_next()   # raises ContractError if the gateway rejects
    t_fulfill = time.perf_counter() - t0
    launches = read_launches("succinct header_range gateway")
    proof, t_verify = seen["proof"], seen["verify"]
    key = range_key(trusted, target)
    if proof.output_bytes != want or (
            contract.latest_block,
            contract.block_height_to_header_hash[target],
            contract.state_root_commitments[key],
            contract.data_root_commitments[key]) != \
            (target, want[:32], want[32:64], want[64:96]):
        raise AssertionError("the succinct output or the contract's stored "
                             "hash and commitments != DummyHeaderRange's")
    log(f"phase 13: make_gateway(zk=\"succinct\", device={dev}): "
        f"request_header_range(1, {target}) fulfilled in {t_fulfill:.3f} s "
        f"(one prove, one warm verify {t_verify:.3f} s, on the card); "
        f"the contract stores the dummy's header hash and commitments  "
        f"[{card}]")
    machine = report_succinct(13, "prove_header_range_succinct", rec, timer,
                              seen["prove"], seen["peak"], "_range_tape",
                              card)
    log(f"phase 13: kernel launches on the succinct header_range path (prove "
        f"and the gateway's verify): {launches}")

    # a verifier on another machine: no program, no verification key
    progcache.clear_memory_cache()
    vk.clear_memory_cache()
    os.environ["VECTORX_VK_CACHE"] = tempfile.mkdtemp(dir=out_dir)
    cold = succinct_timers([(shr, "_range_tape")])
    t0 = time.perf_counter()
    with cold:
        ok = shr.verify_header_range_succinct(proof, cfg, device=dev)
    t_cold = time.perf_counter() - t0
    if not ok:
        raise AssertionError("the cold-cache verify rejected the proof")
    log(f"phase 13: verify_header_range_succinct from a cold program and key "
        f"cache accepted in {t_cold:.3f} s (tape "
        f"{cold.times['_range_tape']:.3f} s, compile_tape "
        f"{cold.times['compile_tape']:.3f} s, constant columns "
        f"{cold.times['MachineAir.constant_columns']:.3f} s)  [{card}]")

    # only after that accept: the rejections
    t0 = time.perf_counter()
    bad_out = want[:40] + bytes([want[40] ^ 1]) + want[41:]
    evil = MockGateway()
    evil.register_prover(fid, lambda i: (bad_out, proof), gw_verify)
    fresh = VectorXContract(evil, trusted, chain.get_block_hash(trusted), 1,
                            set_hash, header_range_commitment_tree_size=tree)
    fresh.request_header_range(1, target)

    def commit_tampered() -> bool:
        try:
            evil.fulfill_next()
        except ContractError:
            return False
        return True

    rejects("a tampered output with the gateway's proof", commit_tampered,
            stark=False)
    if fresh.latest_block != trusted or fresh.data_root_commitments:
        raise AssertionError("a rejected fulfillment changed the contract")
    n = proof.num_authorities
    under = [i < (2 * n) // 3 for i in range(len(proof.validator_signed))]
    for what, bad, stark in (
            (f"validator_signed with {sum(under)} of {n}",
             dataclasses.replace(proof, validator_signed=under), False),
            ("a tampered FRI final coefficient of the machine proof",
             tampered_machine_fri(proof), True)):
        rejects(what, functools.partial(
            shr.verify_header_range_succinct, bad, cfg, device=dev),
            stark=stark)
    log(f"phase 13: a tampered output through the gateway reverts the commit "
        f"(contract unchanged); validator_signed under the threshold and a "
        f"tampered FRI final coefficient rejected "
        f"({time.perf_counter() - t0:.3f} s)  [{card}]")
    return {"launches": launches, "machine": machine,
            "prove": seen["prove"], "peak": seen["peak"],
            "verify": t_verify, "cold_verify": t_cold}


def phase_succinct_rotate(dev, card: str, cfg) -> dict:
    """Phase 14: the succinct rotate of phase 13's chain's set 1 through
    the port's contract and `make_gateway(zk="succinct")`; then the
    rejections.  Returns the launches of the gateway's prove and verify."""
    from vectorx_tpu_torch.circuits import DummyRotate
    from vectorx_tpu_torch.circuits import succinct_header_range as shr
    from vectorx_tpu_torch.circuits import succinct_rotate as srt
    from vectorx_tpu_torch.hash.sha256 import chained_hash
    from vectorx_tpu_torch.io.abi import RotateInput
    from vectorx_tpu_torch.services import (VectorXContract, compute_genesis,
                                            make_gateway)

    chain, trusted, _ = header_range_chain(SUCCINCT_TREE, SUCCINCT_AUTH)
    inp = RotateInput(1, chained_hash(chain.era_pubkeys(1))).encode()
    want = DummyRotate().run(inp, chain)
    epoch_end = chain.last_justified_block(1)
    log(f"phase 14: succinct rotate of set 1 ({SUCCINCT_AUTH} authorities; "
        f"epoch-end block {epoch_end}, "
        f"{chain.get_header_rotate(epoch_end).header_size} B), FriConfig()")
    gw = make_gateway(chain, zk="succinct", stark_config=cfg, device=dev)
    g = compute_genesis(chain, trusted)
    contract = VectorXContract(gw, g.height, g.header_hash,
                               g.authority_set_id, g.authority_set_hash)
    fid = contract.rotate_function_id
    timer = succinct_timers([(srt, "_rotate_tape")])
    rec, seen = ProveRecorder([srt, shr], timer), {}
    timed_gateway(gw, fid, dev, rec, timer, seen)
    contract.request_rotate(1)
    if gw.pending[0][1] != inp:
        raise AssertionError("the contract's rotate request != phase 14's "
                             "input")
    reset_launches()
    t0 = time.perf_counter()
    gw.fulfill_next()
    t_fulfill = time.perf_counter() - t0
    launches = read_launches("succinct rotate gateway")
    proof = seen["proof"]
    if proof.output_bytes != want or \
            contract.authority_set_id_to_hash.get(2) != want:
        raise AssertionError("the succinct rotate output or the contract's "
                             "next set hash != DummyRotate's")
    log(f"phase 14: make_gateway(zk=\"succinct\", device={dev}): "
        f"request_rotate(1) fulfilled in {t_fulfill:.3f} s (one prove, one "
        f"warm verify {seen['verify']:.3f} s, on the card); the contract "
        f"stores DummyRotate's hash of set 2  [{card}]")
    machine = report_succinct(14, "prove_rotate_succinct", rec, timer,
                              seen["prove"], seen["peak"], "_rotate_tape",
                              card)
    log(f"phase 14: kernel launches on the succinct rotate path (prove and "
        f"the gateway's verify): {launches}")

    other = dataclasses.replace(proof, output_bytes=bytes(32))
    t0 = time.perf_counter()
    rejects("another new-set hash", functools.partial(
        srt.verify_rotate_succinct, other, config=cfg, device=dev),
        stark=True)
    t_other = time.perf_counter() - t0
    t0 = time.perf_counter()
    rejects("a tampered FRI final coefficient", functools.partial(
        srt.verify_rotate_succinct, tampered_machine_fri(proof), config=cfg,
        device=dev), stark=True)
    log(f"phase 14: another new-set hash rejected ({t_other:.3f} s, the "
        f"statement program derived); a tampered FRI final coefficient "
        f"rejected ({time.perf_counter() - t0:.3f} s)  [{card}]")
    return {"launches": launches, "machine": machine,
            "prove": seen["prove"], "peak": seen["peak"],
            "verify": seen["verify"], "other_verify": t_other}


def succinct_child(phase: int, path: str) -> dict:
    """`chip_smoke.py --phase-13|--phase-14 <dir>`: the succinct phase on
    the card; returns its result and its seconds for the last line."""
    t_start = time.perf_counter()
    import torch

    from vectorx_tpu_torch.config import Config, require_device
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.stark import StarkConfig

    dev = require_device(Config())
    card = card_line()
    cuda_ntt.load()
    log(f"phase {phase}: process on {torch.cuda.get_device_name(dev)}")
    cfg = StarkConfig(fri=FriConfig())
    if phase == 13:
        res = phase_succinct_header_range(dev, card, cfg, path)
    else:
        res = phase_succinct_rotate(dev, card, cfg)
    return dict(res, seconds=time.perf_counter() - t_start)


class SuccinctPhase(CardPhase):
    """Phase 13 or 14 (`--succinct`), started after phase 2, beside the
    other one; its caches in a directory of its own."""

    def __init__(self, phase: int, other: int, t_start: float):
        super().__init__(phase, t_start, f"phase {other}")

    def env(self) -> dict:
        return {"VECTORX_VK_CACHE": os.path.join(self.dir, "vk")}


def main(succinct: bool) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    from vectorx_tpu_torch.hash import poseidon_py
    from vectorx_tpu_torch.ntt import cuda_ntt

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 0: card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; os.cpu_count() {os.cpu_count()} for the "
        f"script's {3 if succinct else 4} processes")
    t0 = time.perf_counter()
    state = list(range(12))
    for _ in range(2000):
        state = poseidon_py.permute(state)
    log(f"phase 0: host probe: 2000 scalar Poseidon permutations "
        f"(poseidon_py) in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    cuda_ntt.load()
    log(f"phase 0: kernels built from vectorx_tpu_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {cuda_ntt.BUILD_INFO['seconds']:.2f} s)")
    for line in cuda_ntt.BUILD_INFO["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"phase 0: ptxas: {line.strip()}")
    lib = cuda_ntt.load()
    log("phase 0: ntt_tile<log_n> dynamic shared memory per block (rows / "
        "columns): " + ", ".join(
            f"{n}: {lib.vx_ntt_tile_smem(n, 0) // 1024} / "
            f"{lib.vx_ntt_tile_smem(n, 1) // 1024} KB"
            for n in range(cuda_ntt.S_BITS + 1)))
    if succinct:
        return run_phases(dev, card, None, t_start, succinct)
    host = HostChecks(t_start)
    try:
        return run_phases(dev, card, host, t_start, succinct)
    finally:
        host.stop()


def run_main(dev, card: str, host: HostChecks, t_start: float,
             done) -> dict:
    """Phases 3-12; returns the launches of every main path."""
    import numpy as np

    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.stark import FibonacciAir, RangeCheckAir, StarkConfig

    # phase 12 runs in its own process on the card from here on, after
    # phase 1's kernel medians
    p12 = Phase12(t_start)
    try:
        # the prover path of the first slice, five steps shallower than
        # there (2^21 / 2^20 rows) so that the whole script fits its limit
        cfg = StarkConfig(fri=FriConfig())
        rng = np.random.default_rng(0)
        values = rng.integers(0, 1 << 14, size=(8, (1 << 15) - 1),
                              dtype=np.uint64)
        statements = [("FibonacciAir(log_n=16)", FibonacciAir(log_n=16)),
                      ("RangeCheckAir(log_n=15, bits=14, V=8)",
                       RangeCheckAir(15, 14, values))]
        reset_launches()
        for name, air in statements:
            prove_and_check(name, air, cfg, dev, card)
        launches = read_launches("STARK prover")
        log(f"phase 3: kernel launches on the STARK prover path: {launches}")
        done(3)

        phase_cuda_cpu(dev, card, host)
        done(4)
        phase_hashes(dev, card)
        done(5)
        phase_ed25519(dev, card, host)
        done(6)
        hr_launches, hr_proof = phase_header_range(dev, card)
        p11 = Phase11(hr_proof, t_start)
        try:
            done(7)
            phase_identity(dev, card)
            done(8)
            rot_launches = phase_rotate(dev, card)
            done(9)
            phase_services(dev, card)
            done(10)
            p11_launches = p11.finish(host, t_start)
        finally:
            p11.stop()
        done(11)
        p12_launches = p12.finish(host, t_start)
    finally:
        p12.stop()
    done(12)

    for name in launches:
        launches[name] += hr_launches[name] + rot_launches[name] + \
            p11_launches["aggregated"][name] + \
            p11_launches["public_bind"][name] + \
            p12_launches["justification"][name]
    return launches


def run_succinct(t_start: float, done) -> dict:
    """Phases 13 and 14 (`--succinct`), each in a process of its own,
    started after phase 2 and run side by side; returns the launches of
    both paths."""
    procs = [SuccinctPhase(13, 14, t_start), SuccinctPhase(14, 13, t_start)]
    try:
        launches = {}
        for p in procs:
            res = p.result(timeout=max(
                SUCCINCT_DEADLINE_S - (time.perf_counter() - t_start), 1.0))
            for name, n in res["launches"].items():
                launches[name] = launches.get(name, 0) + n
            done(p.phase)
    finally:
        for p in procs:
            p.stop()
    return launches


def run_phases(dev, card: str, host: HostChecks | None, t_start: float,
               succinct: bool) -> int:
    import torch

    from vectorx_tpu_torch import entry

    marks = [time.perf_counter()]

    def done(phase: int) -> None:
        now = time.perf_counter()
        log(f"phase {phase}: {now - marks[-1]:.2f} s; from "
            f"{marks[-1] - t_start:.1f} to {now - t_start:.1f} s since the "
            f"start")
        marks.append(now)

    log(f"phase 0: {marks[0] - t_start:.2f} s")
    k = phase_kernels(dev, card)
    done(1)

    r_cuda = entry.root(dev)
    r_cpu = entry.root("cpu")
    if r_cuda != r_cpu:
        raise AssertionError(f"entry twin: CUDA root {r_cuda} != CPU {r_cpu}")
    log(f"phase 2: entry twin root {r_cuda} equal on CUDA and CPU")
    phase_poseidon(dev, card)
    done(2)

    if succinct:
        launches = run_succinct(t_start, done)
    else:
        launches = run_main(dev, card, host, t_start, done)

    # each kernel at the header_range path's (512, 2^17) coset LDE block,
    # the main path's largest: K1's column step, K2's transpose
    t1 = k["timed"]["K1 (512, 2^17) column step"]
    t2 = k["timed"]["K2 (512, 2^17)"]
    kernels = [
        {"name": "ntt_tile", "route": "cuda",
         "source": "vectorx_tpu_torch/csrc/ntt.cu",
         "replaces": "vectorx_tpu/ntt/pallas_ntt.py:159",
         "launches": launches["ntt_tile"], "max_abs_err": k["worst"], **t1},
        {"name": "ntt_transpose", "route": "cuda",
         "source": "vectorx_tpu_torch/csrc/ntt.cu",
         "replaces": "vectorx_tpu/ntt/pallas_ntt.py:274",
         "launches": launches["ntt_transpose"], "max_abs_err": k["worst"],
         **t2},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] and sys.argv[1] in HostChecks.FLAGS \
            and len(sys.argv) == 3:
        import torch

        torch.set_num_threads(HOST_THREADS)
        if sys.argv[1] == "--host-checks":
            print(json.dumps(host_checks()), flush=True)
            last = host_public_bind
        else:
            os.nice(JUSTIFICATION_NICE)
            last = host_justification
        print(json.dumps({"seconds": last(sys.argv[2]), "t1": time.time()}),
              flush=True)
        sys.exit(0)
    children = {"--phase-11": phase11_child, "--phase-12": phase12_child,
                "--phase-13": functools.partial(succinct_child, 13),
                "--phase-14": functools.partial(succinct_child, 14)}
    if sys.argv[1:2] and sys.argv[1] in children and len(sys.argv) == 3:
        t0 = time.time()
        res = children[sys.argv[1]](sys.argv[2])
        print(json.dumps({f"phase {sys.argv[1][8:]}": dict(
            res, t0=t0, t1=time.time())}), flush=True)
        sys.exit(0)
    if sys.argv[1:] not in ([], ["--succinct"]):
        raise SystemExit(f"usage: {sys.argv[0]} [--succinct]")
    sys.exit(main(sys.argv[1:] == ["--succinct"]))

#!/usr/bin/env python3
"""Time the Poseidon permutation with its matrix products as field ops or as
exact float64 limb matmuls, at batch sizes from one state up, on one device.

    python3 scripts/poseidon_paths.py [--device cuda|cpu] [--max-log N]
                                      [--prove LOG_N]

Variants of the same permutation (`vectorx_tpu_torch.hash.poseidon`):

- "ops": every product as field ops (`_mds_layer` for the dense 12x12
  matvecs, `mul` and `field_sum` for the sparse rounds);
- "dense mm": the dense matvecs as limb matmuls (`_matmul_limbs`), the
  sparse rounds as field ops, which is what `poseidon.permute` runs;
- "mm": every product as limb matmuls.

Each variant is first checked equal to `poseidon.permute` on random states.
Prints, per batch size, the median milliseconds of one call (host clock,
the device synchronized), over enough calls to fill about 0.3 s.  With
`--prove LOG_N`, also proves FibonacciAir(LOG_N) at the production
`FriConfig()` once with each variant in the order ops, dense mm, mm, mm,
dense mm, ops (after a small warm-up proof), and prints each prove's
seconds and peak device memory; the proofs must be identical.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def variant(dense_mm: bool, sparse_mm: bool):
    """A Poseidon permutation with the chosen route for its products."""
    import torch

    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.hash import poseidon as pv

    sparse_limbs = {}

    def run(state):
        prm = pv._dev_params(state.device)
        rc, half = prm["rc"], pv.FULL_ROUNDS // 2
        if sparse_mm and state.device not in sparse_limbs:
            rho_v, rho_w = pv._fast_partial_params()[:2]
            sparse_limbs[state.device] = (
                [pv.limbs([[x] for x in row], state.device) for row in rho_v],
                [pv.limbs([row], state.device) for row in rho_w])

        def dense(x, name):
            return (pv._matmul_limbs(x, prm[name + "_T"]) if dense_mm
                    else pv._mds_layer(x, prm[name]))

        s = state
        for r in range(half):
            s = dense(pv._sbox(gl.add(s, rc[r])), "mds")
        for i in range(pv.PARTIAL_ROUNDS):
            s = gl.add(s, prm["c"][i])
            s0 = pv._sbox(s[..., :1])
            s = torch.cat([s0, s[..., 1:]], dim=-1)
            if sparse_mm:
                v_t, w_t = sparse_limbs[state.device]
                v = pv._matmul_limbs(s, v_t[i])
                w = pv._matmul_limbs(s0, w_t[i])
            else:
                v = gl.field_sum(gl.mul(s, prm["v"][i]), -1)[..., None]
                w = gl.mul(s0, prm["w"][i])
            s = torch.cat([v, gl.add(s[..., 1:], w)], dim=-1)
        s = dense(s, "sigma")
        for r in range(half + pv.PARTIAL_ROUNDS, pv.N_ROUNDS):
            s = dense(pv._sbox(gl.add(s, rc[r])), "mds")
        return s

    return run


def time_ms(fn, sync) -> float:
    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    once = time.perf_counter() - t0
    reps = max(3, min(200, int(0.3 / max(once, 1e-6))))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def prove_ab(dev, log_n: int, variants: dict, sync) -> None:
    """One proof of FibonacciAir(log_n) per turn, `poseidon.permute`
    replaced by each variant in turn."""
    import torch

    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.hash import poseidon as pv
    from vectorx_tpu_torch.stark import FibonacciAir, StarkConfig, prove
    from vectorx_tpu_torch.stark.serialize import proof_to_json

    cfg = StarkConfig(fri=FriConfig())
    small = FibonacciAir(log_n=10)
    prove(small, small.build_trace(), cfg, device=dev)      # builds kernels
    air = FibonacciAir(log_n=log_n)
    trace = air.build_trace()
    orig, texts = pv.permute, set()
    for name in ("ops", "dense mm", "mm", "mm", "dense mm", "ops"):
        pv.permute = variants[name]
        try:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            sync()
            t0 = time.perf_counter()
            proof = prove(air, trace, cfg, device=dev)
            sync()
            secs = time.perf_counter() - t0
        finally:
            pv.permute = orig
        texts.add(json.dumps(proof_to_json(proof)))
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else float("nan"))
        print(f"prove FibonacciAir({log_n}), FriConfig(), Poseidon {name}: "
              f"{secs:.3f} s, peak device memory {peak:.3f} GiB", flush=True)
    if len(texts) != 1:
        raise AssertionError("the variants' proofs differ")
    print("the six proofs are identical", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-log", type=int, default=20,
                    help="largest batch, as log2 of the number of states")
    ap.add_argument("--prove", type=int, default=None, metavar="LOG_N",
                    help="also prove FibonacciAir(LOG_N) with each variant")
    args = ap.parse_args()

    import numpy as np
    import torch

    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.hash import poseidon as pv

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("poseidon_paths: no CUDA device")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    variants = {"ops": variant(False, False), "dense mm": variant(True, False),
                "mm": variant(True, True)}
    rng = np.random.default_rng(0)
    x = gl.from_u64(rng.integers(0, 2**64, size=(1000, pv.WIDTH),
                                 dtype=np.uint64), dev)
    want = gl.to_u64(pv.permute(x))
    for name, fn in variants.items():
        if not np.array_equal(gl.to_u64(fn(x)), want):
            raise AssertionError(f"variant {name} != poseidon.permute")
    print(f"poseidon_paths: {args.device}, torch {torch.__version__}, "
          f"{torch.get_num_threads()} host threads; every variant == "
          f"poseidon.permute", flush=True)
    print("states | " + " | ".join(f"{n} ms" for n in variants), flush=True)
    for log_b in (0, 2, 4, 6, 8, 10, 12, 16, 20):
        if log_b > args.max_log:
            break
        xb = gl.from_u64(rng.integers(0, 2**64, size=(1 << log_b, pv.WIDTH),
                                      dtype=np.uint64), dev)
        ms = [time_ms(lambda f=f: f(xb), sync) for f in variants.values()]
        print(f"2^{log_b} | " + " | ".join(f"{m:.4f}" for m in ms),
              flush=True)
    if args.prove is not None:
        prove_ab(dev, args.prove, variants, sync)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Twin of `__graft_entry__.entry()`: one forward step of the flagship
compute — trace iNTT -> coset LDE -> batched Poseidon leaf hash -> Merkle
root — on the same shapes (W=8, log_n=8, rate_bits=3) and the same seeded
trace, so its root equals the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hash import poseidon
from vectorx_tpu_torch.ntt import coset_lde, intt

W, LOG_N, RATE_BITS = 8, 8, 3


def forward(trace: torch.Tensor) -> torch.Tensor:
    """(W, n) trace on any device -> its (4,) Merkle root (non-canonical)."""
    leaves = coset_lde(intt(trace), RATE_BITS).T   # (8n, W) leaf rows
    d = poseidon.hash_no_pad(leaves)
    while d.shape[0] > 1:
        d = poseidon.two_to_one(d[0::2], d[1::2])
    return d[0]


def entry(device):
    """(forward, (trace,)) with the trace made from seed 0 on `device`."""
    rng = np.random.default_rng(0)
    trace = rng.integers(0, gl.P, size=(W, 1 << LOG_N), dtype=np.uint64)
    return forward, (gl.from_u64(trace, device),)


def root(device) -> list[int]:
    """The canonical Merkle root of `entry()` computed on `device`."""
    fn, args = entry(device)
    return [int(x) for x in gl.to_u64(fn(*args))]


# ---------------------------------------------------------------------------
# Twin of `__graft_entry__.dryrun_multichip`: the sharded paths, one process
# per rank
# ---------------------------------------------------------------------------

def dryrun_rank(mesh) -> dict:
    """One rank's part of the dry run on `mesh`: the sharded prover step
    (B = 2·world traces of W = 4 columns, n = 32), the four-step NTT
    (R = C = 8·world) against its one-device version, and a sharded STARK
    proof of FibonacciAir(5) at the reference's dry-run config, verified
    and then resumed from the checkpoint store.  Its result carries the
    NTT kernel launches of the sharded paths (the one-device transform it
    is checked against not counted)."""
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.ntt import cuda_ntt
    from vectorx_tpu_torch.parallel.mesh import shard_batch
    from vectorx_tpu_torch.parallel.ntt_sharded import (
        four_step_ntt, four_step_ntt_reference)
    from vectorx_tpu_torch.parallel.prover_step import \
        make_sharded_prover_step
    from vectorx_tpu_torch.parallel.scheduler import CheckpointStore
    from vectorx_tpu_torch.parallel.sharded_prove import prove_sharded
    from vectorx_tpu_torch.stark import FibonacciAir, StarkConfig, verify

    p = mesh.world
    dev = mesh.device
    rng = np.random.default_rng(1)

    # 1. the sharded prover step: DP LDE + Merkle + all_gather + sum
    B, Wd, n = 2 * p, 4, 32
    trace = rng.integers(0, gl.P, size=(B, Wd, n), dtype=np.uint64)
    step = make_sharded_prover_step(mesh)
    roots, check = step(gl.from_u64(trace[shard_batch(mesh, B)], dev))
    assert roots.shape == (B, 4)

    # 2. the four-step NTT with its one all-to-all
    R = C = 8 * p
    poly = rng.integers(0, gl.P, size=(R, C), dtype=np.uint64)
    cols = slice(mesh.rank * C // p, (mesh.rank + 1) * C // p)
    out = four_step_ntt(gl.from_u64(poly[:, cols], dev), mesh)
    before = dict(cuda_ntt.LAUNCHES)
    want = four_step_ntt_reference(gl.from_u64(poly, dev), R, C)
    checked = {k: cuda_ntt.LAUNCHES[k] - v for k, v in before.items()}
    assert torch.equal(gl.canonicalize(out),
                       gl.canonicalize(want[shard_batch(mesh, R)]))

    # 3. a sharded STARK proof, verified, then resumed from the store
    cfg = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=0,
                                    num_queries=2, final_poly_len=2,
                                    pow_bits=0))
    air = FibonacciAir(log_n=5)
    store = CheckpointStore()
    proof, hit = prove_sharded(air, air.build_trace(), cfg, mesh,
                               store=store, job="dryrun")
    assert not hit and verify(air, proof, cfg, device=dev), \
        "sharded proof rejected"
    _, hit2 = prove_sharded(air, air.build_trace(), cfg, mesh, store=store,
                            job="dryrun")
    assert hit2, "checkpoint resume missed"
    return {"rank": mesh.rank, "world": p, "checksum": check,
            "roots": gl.to_u64(roots).tolist(),
            "trace_cap": proof.trace_cap,
            "launches": {k: v - checked[k]
                         for k, v in cuda_ntt.LAUNCHES.items()}}


def dryrun_multichip(world: int, *, backend: str, device: str = "cuda",
                     timeout: float = 600.0) -> dict:
    """Run `dryrun_rank` as `world` processes joined by `backend` ("gloo",
    or "nccl" with one card per rank), each rank on `device`, through a
    `file://` rendezvous in a temporary directory.  Every rank must end
    within `timeout` seconds (else all are killed) and agree; returns rank
    0's result with the kernel launches summed over the ranks."""
    import json
    import os
    import sys
    import tempfile

    from vectorx_tpu_torch.parallel.mesh import run_ranks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory(prefix="vectorx-dryrun-") as d:
        init = f"file://{os.path.join(d, 'rendezvous')}"
        outs = run_ranks([[sys.executable, "-m", "vectorx_tpu_torch.entry",
                           "dryrun", init, str(world), str(rank), backend,
                           device] for rank in range(world)],
                         timeout=timeout, env=env)
    results = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    for r in results[1:]:
        for key in ("checksum", "roots", "trace_cap"):
            if r[key] != results[0][key]:
                raise AssertionError(f"dry-run ranks disagree on {key}")
    return dict(results[0], launches={
        k: sum(r["launches"][k] for r in results)
        for k in results[0]["launches"]})


def _dryrun_main(init: str, world: str, rank: str, backend: str,
                 device: str) -> None:
    import json

    import torch.distributed as dist

    from vectorx_tpu_torch.parallel.mesh import make_mesh
    from vectorx_tpu_torch.parallel.scheduler import init_distributed

    init_distributed(init, int(world), int(rank), backend)
    try:
        res = dryrun_rank(make_mesh(int(world), device=device))
    finally:
        dist.destroy_process_group()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] != ["dryrun"] or len(sys.argv) != 7:
        raise SystemExit("usage: python -m vectorx_tpu_torch.entry dryrun "
                         "<init-url> <world> <rank> <backend> <device>")
    _dryrun_main(*sys.argv[2:])

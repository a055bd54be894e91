"""The port's sharded prove on two gloo CPU ranks, and the dataclass JSON
that its checkpoints hold, held against the JAX package.

* `proof_to_json` of the port's FibonacciAir(4) proof is the reference's
  `sharded_prove.proof_to_json` blob of its proof of the same statement
  (`tests/test_sharded_prove.py`'s statement and `CFG`), and the blob
  round-trips into a proof that both verifiers accept.
* `prove_sharded` of FibonacciAir(5) at world 2 at `CFG` (the dry-run
  config) gives, on both ranks, the JSON of the one-device port proof and
  of the reference's `prove`; the reference's verifier accepts it, and a
  second call resumes it from the shared checkpoint directory.
* two statements whose reference proofs are golden fixtures (read through
  `tests/_proofcache.py`) prove sharded to the reference's JSON and the
  one-device port's: `tests/test_torch_stark.py`'s RangeCheck statement
  at its config (constant columns, LogUp aux columns, a cap of 2 digests)
  and FibonacciAir(4) at `tests/test_recursion_tape.py`'s (4 bits of
  grinding, which rank 0 does and rank 1 replays).
* a RangeCheckAir with a cap of 4 digests (each rank's subtree stops two
  digests below its root) and 2 bits of grinding proves sharded to the
  one-device port proof's JSON.  No golden fixture holds a proof with a
  cap of more than 2 digests, and a cold XLA:CPU prove of one takes
  minutes, so this one is held against the reference through the port's
  unsharded prover (`tests/test_torch_stark.py` holds that to the
  reference).

The two rank processes run once per module; the reference's proof of
FibonacciAir(5) (a real XLA:CPU prove: no golden fixture holds it) runs in
this process meanwhile.
"""

import concurrent.futures
import json
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

from vectorx_tpu.fri.fri import FriConfig as JFriConfig
from vectorx_tpu.parallel import sharded_prove as jsp
from vectorx_tpu.stark import FibonacciAir as JFibonacciAir
from vectorx_tpu.stark import StarkConfig as JStarkConfig
from vectorx_tpu.stark import prove as jprove
from vectorx_tpu.stark.range_air import RangeCheckAir as JRangeCheckAir
from vectorx_tpu.stark.verifier import verify as jverify
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.parallel import sharded_prove as sp
from vectorx_tpu_torch.parallel.mesh import run_ranks
from vectorx_tpu_torch.stark import (FibonacciAir, RangeCheckAir,
                                     StarkConfig, prove, verify)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANK_TIMEOUT_S = 300
KNOBS = dict(rate_bits=3, cap_height=0, num_queries=2, final_poly_len=2,
             pow_bits=0)
CFG = StarkConfig(fri=FriConfig(**KNOBS))
JCFG = JStarkConfig(fri=JFriConfig(**KNOBS))
RC_KNOBS = dict(rate_bits=3, cap_height=2, num_queries=3, final_poly_len=2,
                pow_bits=2)
# tests/test_torch_stark.py's config and tests/test_recursion_tape.py's
STARK_KNOBS = dict(rate_bits=3, cap_height=1, num_queries=12,
                   final_poly_len=4, pow_bits=0)
TAPE_KNOBS = dict(rate_bits=3, cap_height=1, num_queries=4,
                  final_poly_len=4, pow_bits=4)


def range_air():
    values = np.random.default_rng(4).integers(0, 1 << 4, size=(2, 31),
                                               dtype=np.uint64)
    return RangeCheckAir(5, 4, values)


def _lookup_values():
    # the first statement `tests/test_lookup.py::_air()` draws
    return np.random.default_rng(11).integers(0, 1 << 6, size=(4, 255),
                                              dtype=np.uint64)


# name -> (AIR kind, its arguments, FRI knobs): proved sharded by the ranks
JOBS = {
    "range": ("range", [5, 4, range_air().values.tolist()], RC_KNOBS),
    "range8": ("range", [8, 6, _lookup_values().tolist()], STARK_KNOBS),
    "fib4_pow4": ("fib", 4, TAPE_KNOBS),
}


def build_air(kind, args, ref=False):
    if kind == "fib":
        return (JFibonacciAir if ref else FibonacciAir)(log_n=args)
    log_n, bits, values = args
    return (JRangeCheckAir if ref else RangeCheckAir)(
        log_n, bits, np.array(values, dtype=np.uint64))


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from vectorx_tpu_torch.fri.fri import FriConfig
    from vectorx_tpu_torch.parallel.mesh import make_mesh
    from vectorx_tpu_torch.parallel.scheduler import (CheckpointStore,
                                                      init_distributed)
    from vectorx_tpu_torch.parallel.sharded_prove import (proof_to_json,
                                                          prove_sharded)
    from vectorx_tpu_torch.stark import (FibonacciAir, RangeCheckAir,
                                         StarkConfig)

    init, rank, out, store_dir = sys.argv[1:5]
    rank = int(rank)
    knobs, jobs = json.loads(sys.argv[5])
    init_distributed(init, 2, rank, "gloo")
    mesh = make_mesh(2, device="cpu")
    res = {}
    air = FibonacciAir(log_n=5)
    cfg = StarkConfig(fri=FriConfig(**knobs))
    store = CheckpointStore(store_dir)
    proof, hit = prove_sharded(air, air.build_trace(), cfg, mesh,
                               store=store, job="fib5")
    res["fib5"] = json.dumps(proof_to_json(proof))
    res["fib5_hit"] = hit
    # a second call, through a fresh store over the same directory
    again, hit2 = prove_sharded(air, air.build_trace(), cfg, mesh,
                                store=CheckpointStore(store_dir), job="fib5")
    res["fib5_resumed"] = json.dumps(proof_to_json(again))
    res["fib5_hit2"] = hit2
    for name, (kind, args, job_knobs) in jobs.items():
        if kind == "fib":
            air = FibonacciAir(log_n=args)
        else:
            air = RangeCheckAir(args[0], args[1],
                                np.array(args[2], dtype=np.uint64))
        proof, _ = prove_sharded(air, air.build_trace(),
                                 StarkConfig(fri=FriConfig(**job_knobs)),
                                 mesh)
        res[name] = json.dumps(proof_to_json(proof))
    res["counts"] = mesh.counts
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
""")


def _run_ranks(d):
    script = d / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    init = f"file://{d / 'rendezvous'}"
    args = json.dumps([KNOBS, JOBS])
    run_ranks([[sys.executable, str(script), init, str(r),
                str(d / f"rank{r}.json"), str(d / "store"), args]
               for r in range(WORLD)], timeout=RANK_TIMEOUT_S, env=env)
    return [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(both ranks' results, the reference's FibonacciAir(5) proof), the
    reference proving while the ranks run."""
    d = tmp_path_factory.mktemp("sharded_prove")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_run_ranks, d)
        air = JFibonacciAir(log_n=5)
        ref = jprove(air, air.build_trace(), JCFG)
        return ranks.result(), ref


def test_proof_json_blob_matches_reference():
    air = FibonacciAir(log_n=4)
    proof = prove(air, air.build_trace(), CFG, device="cpu")
    blob = sp.proof_to_json(proof)
    jair = JFibonacciAir(log_n=4)
    ref = jprove(jair, jair.build_trace(), JCFG)
    assert json.dumps(blob) == json.dumps(jsp.proof_to_json(ref))
    back = sp.proof_from_json(json.loads(json.dumps(blob)))
    assert back == proof
    assert verify(air, back, CFG, device="cpu")
    assert jverify(jair, jsp.proof_from_json(blob), JCFG)


def test_sharded_fib5_matches_unsharded_and_reference(sharded):
    ranks, ref = sharded
    air = FibonacciAir(log_n=5)
    local = json.dumps(sp.proof_to_json(
        prove(air, air.build_trace(), CFG, device="cpu")))
    assert ranks[0]["fib5"] == ranks[1]["fib5"] == local
    assert local == json.dumps(jsp.proof_to_json(ref))
    got = sp.proof_from_json(json.loads(ranks[0]["fib5"]))
    assert verify(air, got, CFG, device="cpu")
    assert jverify(JFibonacciAir(log_n=5),
                   jsp.proof_from_json(json.loads(ranks[0]["fib5"])), JCFG)


def test_sharded_prove_resumes_from_store(sharded):
    ranks, _ = sharded
    for r in ranks:
        assert r["fib5_hit"] is False and r["fib5_hit2"] is True
        assert r["fib5_resumed"] == r["fib5"]


def test_sharded_range_check_matches_unsharded(sharded):
    """Constants, aux columns, a 4-digest cap and grinding, sharded."""
    ranks, _ = sharded
    air = range_air()
    cfg = StarkConfig(fri=FriConfig(**RC_KNOBS))
    local = prove(air, air.build_trace(), cfg, device="cpu")
    assert ranks[0]["range"] == ranks[1]["range"] == \
        json.dumps(sp.proof_to_json(local))
    assert verify(air, local, cfg, device="cpu")
    # every collective the layout uses ran, on both ranks alike
    assert ranks[0]["counts"] == ranks[1]["counts"]
    assert min(ranks[0]["counts"].values()) > 0


@pytest.mark.parametrize("name", ["range8", "fib4_pow4"])
def test_sharded_proof_matches_reference(sharded, name):
    """Sharded == the one-device port proof == the reference's golden
    proof of the same statement, and the port's verifier accepts it."""
    ranks, _ = sharded
    kind, args, knobs = JOBS[name]
    air = build_air(kind, args)
    cfg = StarkConfig(fri=FriConfig(**knobs))
    local = json.dumps(sp.proof_to_json(
        prove(air, air.build_trace(), cfg, device="cpu")))
    jair = build_air(kind, args, ref=True)
    ref = jprove(jair, jair.build_trace(),
                 JStarkConfig(fri=JFriConfig(**knobs)))
    assert ranks[0][name] == ranks[1][name] == local
    assert local == json.dumps(jsp.proof_to_json(ref))
    assert verify(air, sp.proof_from_json(json.loads(ranks[0][name])), cfg,
                  device="cpu")

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
* the RangeCheck statement of `tests/test_torch_stark.py` past a lowered
  `STREAM_THRESHOLD_ELEMS` (where the one-device `prove` streams) proves
  sharded to its golden reference proof, and the sharded constant
  commitment's cap is the streamed one's.
* the bus AIR of `tests/test_bus.py` (the sharded aux witness's bus sums,
  built by block of trace rows) proves sharded to the reference's JSON.
* the elements all-gathered over one sharded proof are the same for
  FibonacciAir(5) and FibonacciAir(7) but for one subtree-root digest a
  rank for each FRI layer the larger statement adds: no codeword or
  coefficient row is gathered.
* at world 4 (other FRI partner blocks, the subtrees meeting at other
  levels, the bus sums dealt to a third rank) FibonacciAir(5) and the bus
  AIR prove to the same JSON as at world 2.

The rank processes (two, and four) run once per module; the reference's
proof of FibonacciAir(5) (a real XLA:CPU prove: no golden fixture holds
it) runs in this process meanwhile.
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
from vectorx_tpu_torch.stark import prover as tprover

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


# the streaming bound the ranks prove "range8_bound" under: below the
# statement's committed elements, so the one-device `prove` streams it
LOW_BOUND = 1 << 8
BUS_KNOBS = dict(STARK_KNOBS, cap_height=0)     # tests/test_bus.py's config


def bus_columns():
    """`tests/test_bus.py`'s bus statement, as (constants, trace) lists."""
    from test_torch_bus import BusAir

    air = BusAir()
    return [air.constant_columns().tolist(), air.build_trace().tolist()]


# name -> (AIR kind, its arguments, FRI knobs): proved sharded by the ranks
JOBS = {
    "range": ("range", [5, 4, range_air().values.tolist()], RC_KNOBS),
    "range8": ("range", [8, 6, _lookup_values().tolist()], STARK_KNOBS),
    "range8_bound": ("range", [8, 6, _lookup_values().tolist()],
                     STARK_KNOBS),
    "fib4_pow4": ("fib", 4, TAPE_KNOBS),
    "bus": ("bus", None, BUS_KNOBS),      # the columns: `bus_columns()`
}
# proved at world 4
JOBS4 = {"fib5": ("fib", 5, KNOBS), "bus": JOBS["bus"]}


def build_air(kind, args, ref=False):
    if kind == "fib":
        return (JFibonacciAir if ref else FibonacciAir)(log_n=args)
    if kind == "bus":
        from test_bus import BusAir as JBusAir
        from test_torch_bus import BusAir

        return JBusAir() if ref else BusAir()
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
    from vectorx_tpu_torch.parallel.sharded_prove import (ShardedDomain,
                                                          proof_to_json,
                                                          prove_sharded)
    from vectorx_tpu_torch.stark import (FibonacciAir, RangeCheckAir,
                                         StarkConfig)
    from vectorx_tpu_torch.stark import prover
    from vectorx_tpu_torch.stark.air import Air, BusPort

    class BusAir(Air):
        # tests/test_bus.py's bus statement, from its columns

        def __init__(self, consts, trace):
            super().__init__(width=4, log_n=6, constraint_degree=2)
            self.consts = np.array(consts, dtype=np.uint64)
            self.trace = np.array(trace, dtype=np.uint64)

        def bus_ports(self):
            return [BusPort(value_cols=(0, 1), addr_col=0, mult_col=1),
                    BusPort(value_cols=(2, 3), addr_col=2, mult_col=3)]

        def constant_columns(self):
            return self.consts

        def transition(self, alg, local, nxt, public, consts=None):
            return []

        def build_trace(self):
            return self.trace

    init, rank, out, store_dir = sys.argv[1:5]
    rank = int(rank)
    world, knobs, jobs, low_bound = json.loads(sys.argv[5])
    init_distributed(init, world, rank, "gloo")
    mesh = make_mesh(world, device="cpu")
    # the elements this rank sends into all_gathers
    gathered = [0]
    all_gather = mesh.all_gather

    def counting_all_gather(x, dim=0):
        gathered[0] += x.numel()
        return all_gather(x, dim)

    mesh.all_gather = counting_all_gather

    def payload(prove_once):
        mesh.reset_counts()
        gathered[0] = 0
        out = prove_once()
        return out, {"gathered": gathered[0], "counts": dict(mesh.counts)}

    res = {"payload": {}}
    cfg = StarkConfig(fri=FriConfig(**knobs))
    if world == 2:
        air = FibonacciAir(log_n=5)
        store = CheckpointStore(store_dir)
        (proof, hit), res["payload"]["fib5"] = payload(
            lambda: prove_sharded(air, air.build_trace(), cfg, mesh,
                                  store=store, job="fib5"))
        res["fib5"] = json.dumps(proof_to_json(proof))
        res["fib5_hit"] = hit
        # a second call, through a fresh store over the same directory
        again, hit2 = prove_sharded(air, air.build_trace(), cfg, mesh,
                                    store=CheckpointStore(store_dir),
                                    job="fib5")
        res["fib5_resumed"] = json.dumps(proof_to_json(again))
        res["fib5_hit2"] = hit2
        air = FibonacciAir(log_n=7)
        _, res["payload"]["fib7"] = payload(
            lambda: prove_sharded(air, air.build_trace(), cfg, mesh))
    for name, (kind, args, job_knobs) in jobs.items():
        if kind == "fib":
            air = FibonacciAir(log_n=args)
        elif kind == "bus":
            air = BusAir(*args)
        else:
            air = RangeCheckAir(args[0], args[1],
                                np.array(args[2], dtype=np.uint64))
        job_cfg = StarkConfig(fri=FriConfig(**job_knobs))
        saved = prover.STREAM_THRESHOLD_ELEMS
        if name.endswith("_bound"):
            # past the streaming bound: the one-device prove streams
            prover.STREAM_THRESHOLD_ELEMS = low_bound
            assert prover._use_streaming(air, job_cfg)
            res[name + "_caps"] = [
                prover.preprocess(air, job_cfg, device="cpu",
                                  domain=domain)[0].cap_ints()
                for domain in (ShardedDomain(mesh), prover.stages.LOCAL)]
        try:
            proof, _ = prove_sharded(air, air.build_trace(), job_cfg, mesh)
        finally:
            prover.STREAM_THRESHOLD_ELEMS = saved
        res[name] = json.dumps(proof_to_json(proof))
    res["counts"] = mesh.counts
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
""")


def _run_ranks(d, world, jobs):
    d.mkdir()
    script = d / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    init = f"file://{d / 'rendezvous'}"
    jobs = {name: (kind, bus_columns() if kind == "bus" else args, knobs)
            for name, (kind, args, knobs) in jobs.items()}
    args = json.dumps([world, KNOBS, jobs, LOW_BOUND])
    run_ranks([[sys.executable, str(script), init, str(r),
                str(d / f"rank{r}.json"), str(d / "store"), args]
               for r in range(world)], timeout=RANK_TIMEOUT_S, env=env)
    return [json.loads((d / f"rank{r}.json").read_text())
            for r in range(world)]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(the ranks' results at world 2, at world 4, the reference's
    FibonacciAir(5) proof), the reference proving while the ranks run."""
    d = tmp_path_factory.mktemp("sharded_prove")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(_run_ranks, d / "world2", WORLD, JOBS)
        ranks4 = pool.submit(_run_ranks, d / "world4", 4, JOBS4)
        air = JFibonacciAir(log_n=5)
        ref = jprove(air, air.build_trace(), JCFG)
        return ranks.result(), ranks4.result(), ref


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
    ranks, _, ref = sharded
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
    ranks = sharded[0]
    for r in ranks:
        assert r["fib5_hit"] is False and r["fib5_hit2"] is True
        assert r["fib5_resumed"] == r["fib5"]


def test_sharded_range_check_matches_unsharded(sharded):
    """Constants, aux columns, a 4-digest cap and grinding, sharded."""
    ranks = sharded[0]
    air = range_air()
    cfg = StarkConfig(fri=FriConfig(**RC_KNOBS))
    local = prove(air, air.build_trace(), cfg, device="cpu")
    assert ranks[0]["range"] == ranks[1]["range"] == \
        json.dumps(sp.proof_to_json(local))
    assert verify(air, local, cfg, device="cpu")
    # every collective the layout uses ran, on both ranks alike
    assert ranks[0]["counts"] == ranks[1]["counts"]
    assert min(ranks[0]["counts"].values()) > 0


@pytest.mark.parametrize("name", ["range8", "fib4_pow4", "bus"])
def test_sharded_proof_matches_reference(sharded, name):
    """Sharded == the one-device port proof == the reference's golden
    proof of the same statement, and the port's verifier accepts it."""
    ranks = sharded[0]
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


def test_sharded_proof_past_the_streaming_bound(sharded):
    """Past a lowered `STREAM_THRESHOLD_ELEMS` the one-device `prove`
    streams; the sharded one takes the unstreamed schedule split over the
    ranks (the reference's `trace_sharding`), its constant commitment's
    cap is the streamed one's, and its proof is the reference's golden
    proof of the same statement."""
    ranks = sharded[0]
    kind, args, knobs = JOBS["range8_bound"]
    air = build_air(kind, args)
    cfg = StarkConfig(fri=FriConfig(**knobs))
    assert tprover._commit_cols(air) * (air.n << cfg.rate_bits) > LOW_BOUND
    jair = build_air(kind, args, ref=True)
    ref = json.dumps(jsp.proof_to_json(jprove(
        jair, jair.build_trace(), JStarkConfig(fri=JFriConfig(**knobs)))))
    for r in ranks:
        assert r["range8_bound"] == ref
        sharded_cap, streamed_cap = r["range8_bound_caps"]
        assert sharded_cap == streamed_cap


def test_all_gathered_elements_do_not_grow_with_the_statement(sharded):
    """FibonacciAir(5) and FibonacciAir(7) at `CFG`: the 4x larger domain
    gathers no element more, apart from its two more FRI layers' subtree
    roots (the cap of each layer needs every rank's root: one all_gather
    of one 4-element digest a rank at cap height 0); each of those layers
    also takes one all_to_all."""
    layers = 2
    for r in sharded[0]:
        small, large = r["payload"]["fib5"], r["payload"]["fib7"]
        assert large["gathered"] == small["gathered"] + 4 * layers
        assert small["gathered"] > 0
        for name, more in (("all_gather", layers), ("all_to_all", layers),
                           ("all_reduce", 0)):
            assert large["counts"][name] == small["counts"][name] + more


@pytest.mark.parametrize("name", ["fib5", "bus"])
def test_world_4_matches_world_2(sharded, name):
    """The statements at world 4 prove to the world-2 JSON, which the
    tests above hold to the one-device port proof and the reference's."""
    ranks, ranks4, ref = sharded
    for r in ranks4:
        assert r[name] == ranks[0][name]
    if name == "fib5":
        assert ranks4[0][name] == json.dumps(jsp.proof_to_json(ref))

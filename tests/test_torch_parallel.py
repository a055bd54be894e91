"""The port's `parallel/` on two gloo CPU ranks, held against the JAX
package: the four-step NTT (forward and inverse) and its one all-to-all,
the coset iNTT over row blocks of the sharded quotient (two all-to-alls),
the sharded prover step, `msm_sharded`, the communication model, the
two-process `init_distributed` case of `tests/test_multiprocess_mesh.py`
and the dry-run twin.

The two rank processes run once per module (`ranks`), every case in one
run, through a `file://` rendezvous under the module's temporary
directory; `run_ranks` kills both when one fails or the time limit passes.
The reference runs in this process on the 8-device virtual CPU mesh
(`tests/conftest.py`).
"""

import json
import os
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from vectorx_tpu.field import goldilocks as jgl
from vectorx_tpu.ntt import coset_intt as jcoset_intt
from vectorx_tpu.parallel import comm_model as jcomm
from vectorx_tpu.parallel import ntt_sharded as jns
from vectorx_tpu.parallel.prover_step import \
    make_sharded_prover_step as j_prover_step
from vectorx_tpu_torch.curves import ed25519 as host
from vectorx_tpu_torch.curves import ed25519_batch as ted
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.parallel import comm_model, ntt_sharded
from vectorx_tpu_torch.parallel.mesh import run_ranks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SHAPES = [(32, 32), (16, 32)]
# (R, C) of the coset iNTT over row blocks: two (B = 2) size-R·C vectors
COSET_SHAPES = [(16, 16), (8, 32)]
STEP = (16, 4, 32)                 # B, W, n of the prover step
RANK_TIMEOUT_S = 240


def poly(R, C, inverse):
    seed = 100 + 2 * R + C + int(inverse)
    return np.random.default_rng(seed).integers(0, gl.P, size=(R, C),
                                                dtype=np.uint64)


def coset_evals(R, C):
    return np.random.default_rng(300 + R + C).integers(
        0, gl.P, size=(2, R * C), dtype=np.uint64)


def step_traces():
    return np.random.default_rng(8).integers(0, gl.P, size=STEP,
                                             dtype=np.uint64)


def msm_case():
    """`tests/test_ed25519_batch.py::test_msm_sharded_matches_single_device`'s
    scalars and points (n = 6, w = 4)."""
    rng = np.random.default_rng(9)
    n = 6
    scalars = [int.from_bytes(rng.bytes(32), "little") % host.L
               for _ in range(n)]
    pts = [host.scalar_mult(int(rng.integers(1, 1 << 30)), host.B_POINT)
           for _ in range(n)]
    return scalars, pts


def _affine_ints(coords):
    x, y, z, _ = coords
    zi = pow(z, host.Q - 2, host.Q)
    return [x * zi % host.Q, y * zi % host.Q]


def affine(p):
    return _affine_ints([ted.to_ints(a.reshape(1, -1))[0] for a in p])


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from vectorx_tpu_torch.curves import ed25519_batch as ted
    from vectorx_tpu_torch.field import goldilocks as gl
    from vectorx_tpu_torch.parallel.comm_model import collective_counts
    from vectorx_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                                 replicated, shard_batch)
    from vectorx_tpu_torch.parallel.ntt_sharded import (coset_intt_blocks,
                                                        four_step_ntt)
    from vectorx_tpu_torch.parallel.prover_step import \\
        make_sharded_prover_step
    from vectorx_tpu_torch.parallel.scheduler import init_distributed

    init, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    with open(sys.argv[4]) as f:
        inputs = json.load(f)
    world = inputs["world"]
    init_distributed(init, world, rank, "gloo")
    mesh = make_mesh(world, device="cpu")
    res = {"rank": mesh.rank, "transport": mesh.transport, "ntt": {}}

    # the four-step NTT: this rank's column slab in, its row slab out, and
    # the collectives of each call
    for key, rows in inputs["ntt"].items():
        x = np.array(rows, dtype=np.uint64)
        C = x.shape[1]
        cols = slice(rank * C // world, (rank + 1) * C // world)
        mesh.reset_counts()
        y = four_step_ntt(gl.from_u64(x[:, cols], "cpu"), mesh,
                          inverse=key.endswith(":1"))
        res["ntt"][key] = {"rows": gl.to_u64(y).tolist(),
                           "counts": collective_counts(mesh)}

    # the coset iNTT over row blocks: this rank's block of points in, its
    # slab of coefficients in transposed digit order out
    res["coset"] = {}
    for key, (R, rows) in inputs["coset"].items():
        x = np.array(rows, dtype=np.uint64)
        m = x.shape[1] // world
        mesh.reset_counts()
        y = coset_intt_blocks(gl.from_u64(x[:, rank * m:(rank + 1) * m],
                                          "cpu"), mesh, gl.GENERATOR, R)
        res["coset"][key] = {"rows": gl.to_u64(y).tolist(),
                             "counts": collective_counts(mesh)}

    # the sharded prover step over this rank's traces
    tr = np.array(inputs["traces"], dtype=np.uint64)
    roots, check = make_sharded_prover_step(mesh)(
        gl.from_u64(tr[shard_batch(mesh, tr.shape[0])], "cpu"))
    res["step"] = {"roots": gl.to_u64(roots).tolist(), "check": check}

    # msm_sharded over the replicated points
    scalars, pts = inputs["msm"]
    dev_pts = tuple(ted.from_ints([q[c] for q in pts], device="cpu")
                    for c in range(4))
    res["msm"] = [[ted.to_ints(a.reshape(1, -1))[0] for a in
                   ted.msm_sharded(mesh, scalars, dev_pts, w=4)]]

    # test_multiprocess_mesh's case: a cross-process sum of each rank's
    # local shard, and a field op on a shard of a global array
    local = torch.arange(2, dtype=torch.int64) + 10 * rank
    res["sum"] = int(mesh.all_reduce_sum(local.sum().reshape(1))[0])
    vals = np.arange(4 * 8, dtype=np.uint64).reshape(4, 8)
    shard = gl.from_u64(vals[shard_batch(mesh, 4)], "cpu")
    sq = mesh.all_gather(gl.mul(shard, shard), dim=0)
    res["squares"] = gl.to_u64(sq).tolist()
    assert replicated(mesh, 4) == slice(0, 4)

    # the 2-D layout: one all_reduce on each axis
    axes = make_mesh_2d(2, 1, device="cpu")
    one = torch.ones(1, dtype=torch.int64)
    res["axes"] = {name: [m.world, int(m.all_reduce_sum(one)[0])]
                   for name, m in sorted(axes.items())}
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(res, f)
    print("OK", flush=True)
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results of one two-process run."""
    d = tmp_path_factory.mktemp("parallel_ranks")
    script = d / "worker.py"
    script.write_text(_WORKER)
    inputs = {"world": WORLD,
              "ntt": {f"{R}x{C}:{int(inv)}": poly(R, C, inv).tolist()
                      for R, C in SHAPES for inv in (False, True)},
              "coset": {f"{R}x{C}": [R, coset_evals(R, C).tolist()]
                        for R, C in COSET_SHAPES},
              "traces": step_traces().tolist(),
              "msm": msm_case()}
    (d / "inputs.json").write_text(json.dumps(inputs))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    init = f"file://{d / 'rendezvous'}"
    run_ranks([[sys.executable, str(script), init, str(r),
                str(d / f"rank{r}.json"), str(d / "inputs.json")]
               for r in range(WORLD)], timeout=RANK_TIMEOUT_S, env=env)
    res = [json.loads((d / f"rank{r}.json").read_text())
           for r in range(WORLD)]
    for r in res:
        r["msm"] = _affine_ints(r["msm"][0])
    return res


@pytest.fixture(scope="module")
def jmesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return JMesh(np.array(devs[:8]), ("batch",))


def _rows(ranks, key):
    return np.concatenate([np.array(r["ntt"][key]["rows"], dtype=np.uint64)
                           for r in ranks])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("R,C", SHAPES)
def test_four_step_matches_reference(ranks, jmesh, R, C, inverse):
    """The two ranks' row slabs == the reference's one-device digit-order
    transform and its `four_step_ntt` on the 8-device mesh."""
    got = _rows(ranks, f"{R}x{C}:{int(inverse)}")
    x = poly(R, C, inverse)
    lo, hi = jgl.from_u64(x.reshape(-1))
    want = jgl.to_u64(*jns.four_step_ntt_reference(lo, hi, R, C,
                                                   inverse=inverse))
    assert np.array_equal(got, want)
    sh = NamedSharding(jmesh, P(None, "batch"))
    lo, hi = jgl.from_u64(x)
    ol, oh = jns.four_step_ntt(jax.device_put(lo, sh),
                               jax.device_put(hi, sh), jmesh, axis="batch",
                               inverse=inverse)
    assert np.array_equal(got, jgl.to_u64(ol, oh))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("R,C", SHAPES + [(8, 16)])
def test_four_step_reference_matches_reference(R, C, inverse):
    x = poly(R, C, inverse).reshape(-1)
    got = ntt_sharded.four_step_ntt_reference(gl.from_u64(x, "cpu"), R, C,
                                              inverse=inverse)
    want = jgl.to_u64(*jns.four_step_ntt_reference(*jgl.from_u64(x), R, C,
                                                   inverse=inverse))
    assert np.array_equal(gl.to_u64(got), want)


@pytest.mark.parametrize("R,C", COSET_SHAPES)
def test_coset_intt_blocks_matches_reference(ranks, R, C):
    """The ranks' slabs, stacked, == `four_step_ntt_reference`'s inverse
    times shift^-i at coefficient i = k1 + R·k2, and == the one-device
    `coset_intt` (the port's and the reference's) read in transposed digit
    order; two all_to_alls a call."""
    from vectorx_tpu_torch.ntt import coset_intt

    got = np.concatenate([np.array(r["coset"][f"{R}x{C}"]["rows"],
                                   dtype=np.uint64) for r in ranks], axis=1)
    x = coset_evals(R, C)
    s = pow(gl.GENERATOR, gl.P - 2, gl.P)
    i = np.arange(R)[:, None] + R * np.arange(C)[None, :]
    shifts = gl.from_u64(np.array([[pow(s, int(v), gl.P) for v in row]
                                   for row in i], dtype=np.uint64), "cpu")
    for b in range(2):
        ref = ntt_sharded.four_step_ntt_reference(
            gl.from_u64(x[b], "cpu"), R, C, inverse=True)
        assert np.array_equal(got[b], gl.to_u64(gl.mul(ref, shifts)))
        one = gl.to_u64(coset_intt(gl.from_u64(x[b], "cpu")))
        assert np.array_equal(got[b], one.reshape(C, R).T)
        want = jgl.to_u64(*jcoset_intt(*jgl.from_u64(x[b])))
        assert np.array_equal(one, want)
    for r in ranks:
        assert r["coset"][f"{R}x{C}"]["counts"] == {
            "all_to_all": 2, "all_gather": 0, "all_reduce": 0}


def test_collective_census(ranks):
    """Exactly one all_to_all per four_step_ntt call, nothing else."""
    for r in ranks:
        for key, case in r["ntt"].items():
            assert case["counts"] == {"all_to_all": 1, "all_gather": 0,
                                      "all_reduce": 0}, key


def test_prover_step_matches_reference(ranks, jmesh):
    """Roots and checksum == `make_sharded_prover_step` on the 8-device
    mesh over the same 16 traces; both ranks hold the same result."""
    assert ranks[0]["step"] == ranks[1]["step"]
    tl, th = jgl.from_u64(step_traces())
    sh = NamedSharding(jmesh, P("batch"))
    cl, ch, check = j_prover_step(jmesh, axis="batch")(
        jax.device_put(tl, sh), jax.device_put(th, sh))
    want = jgl.to_u64(cl, ch)
    assert np.array_equal(np.array(ranks[0]["step"]["roots"],
                                   dtype=np.uint64), want)
    assert ranks[0]["step"]["check"] == int(check)


def test_msm_sharded_matches_msm(ranks):
    scalars, pts = msm_case()
    dev_pts = tuple(ted.from_ints([q[c] for q in pts], device="cpu")
                    for c in range(4))
    want = affine(ted.msm(scalars, dev_pts, w=4))
    assert ranks[0]["msm"] == ranks[1]["msm"] == want


@pytest.mark.parametrize("n,p,gbps", [(1 << 20, 8, 100.0), (1 << 16, 4, 25.0),
                                      (1 << 24, 2, 12.5), (64, 2, 1.0)])
def test_comm_model_matches_reference(n, p, gbps):
    got = comm_model.four_step_comm(n, p, gbps)
    want = jcomm.four_step_comm(n, p, gbps)
    assert got.egress_bytes_per_device == want.egress_bytes_per_device
    assert got.total_bytes == want.total_ici_bytes
    assert got.transfer_floor_s == want.transfer_floor_s
    assert got.local_elems_per_device == want.local_elems_per_device
    assert got.comm_fraction_vs_naive == want.comm_fraction_vs_naive
    assert comm_model.ELEM_BYTES == jcomm.ELEM_BYTES


def test_init_distributed_sum_and_field_op(ranks):
    """`tests/test_multiprocess_mesh.py`'s two-process case: the sum of
    both ranks' local shards, and a field op on each rank's shard."""
    want = int(np.arange(2).sum() + (np.arange(2) + 10).sum())
    vals = np.arange(4 * 8, dtype=np.uint64).reshape(4, 8)
    sq = jgl.to_u64(*jgl.mul(*jgl.from_u64(vals), *jgl.from_u64(vals)))
    for r in ranks:
        assert r["sum"] == want
        assert np.array_equal(np.array(r["squares"], dtype=np.uint64), sq)
        assert r["transport"] == "gloo"
        assert r["axes"] == {"batch": [2, 2], "poly": [1, 1]}


def test_dryrun_multichip(monkeypatch):
    """The dry-run twin as two gloo CPU processes; its proof's trace cap is
    the reference's (`__graft_entry__.dryrun_multichip`'s FibonacciAir(5)
    trace at its config: rate 3, cap height 0), committed by the
    reference's `stages.commit_rows` while the ranks run."""
    import concurrent.futures

    from vectorx_tpu.stark import FibonacciAir as JFibonacciAir
    from vectorx_tpu.stark import stages as jstages
    from vectorx_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        run = pool.submit(dryrun_multichip, 2, backend="gloo", device="cpu",
                          timeout=RANK_TIMEOUT_S)
        _, _, tree = jstages.commit_rows(
            *jgl.from_u64(JFibonacciAir(log_n=5).build_trace()),
            rate_bits=3, cap_height=0)
        res = run.result()
    assert res["trace_cap"] == tree.cap_ints()
    assert res["world"] == 2 and len(res["roots"]) == 4
    assert 0 <= res["checksum"] < 1 << 32

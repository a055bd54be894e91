"""The port's checkpointed header_range scheduler on CPU torch, held against
the JAX package's `parallel.scheduler`.

* The four cases of `tests/test_scheduler.py` on the port: the staged job
  equals the monolithic circuit and the dummy; a killed job resumes from
  the filesystem; two workers split the map stage; a bad trusted hash
  raises.
* The stage files of one job, written by the port and by the reference
  into stores of their own, are identical file for file, and
  `stages_done` counts the same.
* Below tree 8 the port commits over the first `max_num_headers` header
  slots, as its subchain and the dummy do; the reference's job commits
  over all 8 there (`vectorx_tpu/circuits/subchain.py:82-83`) and so
  differs from the dummy.
* A header past `max_header_size` is refused by the job and the subchain
  alike.
* `hash.sha256.sha256` against hashlib.
"""

import hashlib

import pytest
import torch

from vectorx_tpu.io.fixtures import FixtureChain as JFixtureChain
from vectorx_tpu.parallel.scheduler import CheckpointStore as JStore
from vectorx_tpu.parallel.scheduler import HeaderRangeJob as JJob
from vectorx_tpu_torch.circuits import DummyHeaderRange, HeaderRangeCircuit
from vectorx_tpu_torch.hash.sha256 import chained_hash, sha256
from vectorx_tpu_torch.io.abi import HeaderRangeInput
from vectorx_tpu_torch.io.fixtures import FixtureChain
from vectorx_tpu_torch.parallel.scheduler import (CheckpointStore,
                                                  HeaderRangeJob)

torch.set_num_threads(1)

CHAIN = FixtureChain(seed=13, num_blocks=80, epoch_length=30,
                     authorities_per_era=lambda e: 4)
JCHAIN = JFixtureChain(seed=13, num_blocks=80, epoch_length=30,
                       authorities_per_era=lambda e: 4)


def make_input(trusted=6, target=33, set_id=1, chain=CHAIN):
    return HeaderRangeInput(
        trusted_block=trusted,
        trusted_header_hash=chain.get_block_hash(trusted),
        authority_set_id=set_id,
        authority_set_hash=chained_hash(chain.era_pubkeys(set_id)),
        target_block=target,
    ).encode()


def job(inp, headers, **kw):
    return HeaderRangeJob(CHAIN, inp, max_num_headers=headers,
                          max_authority_set_size=8, device="cpu", **kw)


def test_staged_job_matches_monolithic_pipeline():
    inp = make_input()
    out = job(inp, 32).run()
    mono = HeaderRangeCircuit(max_authority_set_size=8,
                              max_num_headers=32).run(inp, CHAIN,
                                                      device="cpu")
    assert out == mono == DummyHeaderRange(32).run(inp, CHAIN)


def test_checkpoint_resume(tmp_path):
    inp = make_input()
    job1 = job(inp, 32, store=CheckpointStore(str(tmp_path)))
    job1.run_map_stage()                   # killed before the reduce
    assert job1.stats.computed == 4

    job2 = job(inp, 32, store=CheckpointStore(str(tmp_path)))
    out = job2.run()
    assert job2.stats.cached >= 4          # every leaf came from disk
    assert out == DummyHeaderRange(32).run(inp, CHAIN)

    job3 = job(inp, 32, store=CheckpointStore(str(tmp_path)))
    assert job3.run() == out
    assert job3.stats.computed == 0


def test_multi_worker_partition(tmp_path):
    inp = make_input(trusted=2, target=60, set_id=1)
    leaves = []
    for wid in (0, 1):
        w = job(inp, 64, store=CheckpointStore(str(tmp_path)),
                worker_id=wid, n_workers=2)
        leaves += w.run_map_stage()
    assert sorted(leaves) == list(range(8))
    fin = job(inp, 64, store=CheckpointStore(str(tmp_path)))
    assert fin.run() == DummyHeaderRange(64).run(inp, CHAIN)
    assert fin.stats.cached >= 8


def test_job_rejects_bad_trusted_hash():
    bad = HeaderRangeInput(
        trusted_block=6, trusted_header_hash=b"\x00" * 32,
        authority_set_id=1,
        authority_set_hash=chained_hash(CHAIN.era_pubkeys(1)),
        target_block=33).encode()
    with pytest.raises(Exception):
        job(bad, 32).run()


def test_stage_files_and_count_match_reference(tmp_path):
    """One job, half its map stage first (so the resumed run reads some
    stages from disk), then the rest: the same files with the same bytes,
    and the same `stages_done` after each step."""
    inp = make_input(trusted=2, target=40, set_id=1)
    ours = CheckpointStore(str(tmp_path / "port"))
    theirs = JStore(str(tmp_path / "ref"))
    a = job(inp, 64, store=ours, worker_id=1, n_workers=2)
    b = JJob(JCHAIN, inp, max_num_headers=64, max_authority_set_size=8,
             store=theirs, worker_id=1, n_workers=2)
    assert a.job_id == b.job_id
    assert a.run_map_stage() == b.run_map_stage()
    assert ours.stages_done(a.job_id) == theirs.stages_done(b.job_id) > 0
    a2 = job(inp, 64, store=CheckpointStore(str(tmp_path / "port")))
    b2 = JJob(JCHAIN, inp, max_num_headers=64, max_authority_set_size=8,
              store=JStore(str(tmp_path / "ref")))
    assert a2.run() == b2.run()
    assert (a2.stats.computed, a2.stats.cached) == \
        (b2.stats.computed, b2.stats.cached)
    assert a2.store.stages_done(a.job_id) == \
        b2.store.stages_done(b.job_id)
    mine = sorted((tmp_path / "port" / a.job_id).glob("*"))
    ref = sorted((tmp_path / "ref" / b.job_id).glob("*"))
    assert [p.name for p in mine] == [p.name for p in ref]
    assert len(mine) == 8 + 7 + 2          # leaves, reduces, justify, output
    for p, q in zip(mine, ref):
        assert p.read_bytes() == q.read_bytes(), p.name


@pytest.mark.parametrize("tree", [2, 4])
def test_job_below_tree_8_commits_over_its_headers(tree):
    """Phase 7's chain shape (mixed header sizes, the range (2·tree,
    3·tree] of set 1), as `test_torch_services.py::
    test_subchain_commits_over_the_tree` builds it: the port's job equals
    the dummy and the port's circuit; the reference's job commits over all
    8 slots of its one leaf and differs in both commitments."""
    base, frac = 2048 - 180, (100, 10, 60, 25)
    kw = dict(seed=19, num_blocks=3 * tree + 2, epoch_length=2 * tree,
              authorities_per_era=lambda e: 4,
              extension_bytes=lambda b: base * frac[b % 4] // 100)
    chain, jchain = FixtureChain(**kw), JFixtureChain(**kw)
    inp = make_input(2 * tree, 3 * tree, chain=chain)
    want = DummyHeaderRange(tree).run(inp, chain)
    out = HeaderRangeJob(chain, inp, max_num_headers=tree,
                         max_header_size=4096, max_authority_set_size=8,
                         device="cpu").run()
    assert out == want == HeaderRangeCircuit(8, 4096, tree).run(
        inp, chain, device="cpu")
    ref = JJob(jchain, inp, max_num_headers=tree, max_header_size=4096,
               max_authority_set_size=8).run()
    assert ref[:32] == want[:32]
    assert ref[32:64] != want[32:64] and ref[64:] != want[64:]


def test_job_and_subchain_refuse_an_oversize_header():
    """A header past `max_header_size` is refused by the job's leaf as by
    the circuit's subchain: both run `circuits.subchain`'s fetch step."""
    from vectorx_tpu_torch.circuits.subchain import (SubchainError,
                                                     verify_subchain)

    inp = make_input()
    small = min(len(CHAIN.get_encoded_header(b)) for b in range(7, 34))
    with pytest.raises(SubchainError, match="exceeds max size"):
        HeaderRangeJob(CHAIN, inp, max_num_headers=32,
                       max_header_size=small - 1, max_authority_set_size=8,
                       device="cpu").run()
    with pytest.raises(SubchainError, match="exceeds max size"):
        verify_subchain(CHAIN, 6, CHAIN.get_block_hash(6), 33, 32,
                        small - 1, device="cpu")


@pytest.mark.parametrize("size", [0, 1, 55, 56, 64, 119, 1000])
def test_sha256_matches_hashlib(size):
    data = bytes((7 * i + size) % 256 for i in range(size))
    assert sha256(data) == hashlib.sha256(data).digest()

"""The port's entry points against the JAX package, on CPU torch.

* The flows of `tests/test_services.py` (chain -> genesis -> contract ->
  operator -> gateway -> circuit provers, the indexers, the store, keccak,
  fill_block_range, genesis) run on the port; the operator loop's contract
  state and events equal, byte for byte, the same loop's through the JAX
  package's gateway and through the port's dummy gateway.
* The zk gateway's tamper-revert of `tests/test_zk_header_range.py:72-100`
  at tree 2, on one gateway proof made once for the module.
* The subchain commitment repair: at trees 2, 4, 8 and 16 the port's
  `HeaderRangeCircuit.run` equals `DummyHeaderRange.run`; the JAX
  package's equals it at 8 and 16 and differs at 2 and 4, where it
  commits over 8 leaves (`vectorx_tpu/circuits/subchain.py:82-83`).
* The CLIs: `build` and `prove` in a temporary directory, equal to both
  packages' circuits in-process, and a non-zero exit when `cuda` is asked
  for and there is none.
"""

import dataclasses
import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from _proofcache import FIXTURE_DIR, _key
from vectorx_tpu import config as jconfig
from vectorx_tpu import services as jservices
from vectorx_tpu.circuits import DummyHeaderRange as JDummyHeaderRange
from vectorx_tpu.circuits import HeaderRangeCircuit as JHeaderRangeCircuit
from vectorx_tpu.circuits import RotateCircuit as JRotateCircuit
from vectorx_tpu.io.fixtures import FixtureChain as JFixtureChain
from vectorx_tpu.io.keccak import keccak256 as jkeccak256
from vectorx_tpu.io.store import JustificationStore as JJustificationStore
from vectorx_tpu_torch import config, services
from vectorx_tpu_torch.circuits import (DummyHeaderRange, HeaderRangeCircuit,
                                        RotateCircuit, zk_header_range)
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io.abi import HeaderRangeInput, RotateInput
from vectorx_tpu_torch.io.fixtures import FixtureChain
from vectorx_tpu_torch.io.keccak import keccak256
from vectorx_tpu_torch.io.store import (JustificationStore,
                                        StoredJustificationData)
from vectorx_tpu_torch.services import (ContractError, EventsIndexer,
                                        JustificationIndexer, MockGateway,
                                        OperatorConfig, VectorXContract,
                                        VectorXOperator, apply_fill,
                                        compute_fill, compute_genesis,
                                        make_gateway, range_key)
from vectorx_tpu_torch.stark.prover import StarkConfig
from vectorx_tpu_torch.stark.serialize import proof_from_json

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = 20
CHAIN_KW = dict(seed=9, num_blocks=75, epoch_length=EPOCH,
                authorities_per_era=lambda e: 4)
CHAIN, JCHAIN = FixtureChain(**CHAIN_KW), JFixtureChain(**CHAIN_KW)


def make_system(pkg, chain, genesis_block=4, tree_size=16, interval=10,
                **gateway):
    """`tests/test_services.py`'s system on either package's services."""
    gw = pkg.make_gateway(chain, max_authority_set_size=8,
                          max_num_headers=tree_size, **gateway)
    g = pkg.compute_genesis(chain, genesis_block)
    contract = pkg.VectorXContract(
        gw, g.height, g.header_hash, g.authority_set_id,
        g.authority_set_hash, header_range_commitment_tree_size=tree_size)
    op = pkg.VectorXOperator(contract, chain, pkg.OperatorConfig(
        update_delay_blocks=interval))
    return gw, contract, op


def drain(gw):
    n = 0
    while gw.pending:
        gw.fulfill_next()
        n += 1
    return n


def run_loop(gw, contract, op, until=70):
    for _ in range(30):
        op.run_once()
        drain(gw)
        if contract.latest_block >= until:
            break
    return contract


def snapshot(contract) -> str:
    """The contract's state and event list as canonical JSON text."""
    def enc(v):
        if isinstance(v, bytes):
            return v.hex()
        if isinstance(v, dict):
            return {(k.hex() if isinstance(k, bytes) else str(k)): enc(x)
                    for k, x in v.items()}
        return v

    fields = ("latest_block", "latest_authority_set_id", "frozen",
              "header_range_commitment_tree_size",
              "block_height_to_header_hash", "authority_set_id_to_hash",
              "data_root_commitments", "state_root_commitments",
              "range_start_blocks")
    state = {f: enc(getattr(contract, f)) for f in fields}
    state["events"] = [[e.name, enc(e.args)] for e in contract.events]
    return json.dumps(state, sort_keys=True)


@pytest.fixture(scope="module")
def loops():
    """The operator loop until `latest_block >= 70` (three rotations)
    through the port's gateway on the CPU, the port's dummy gateway and the
    JAX package's gateway."""
    return {
        "port": run_loop(*make_system(services, CHAIN, device="cpu")),
        "dummy": run_loop(*make_system(services, CHAIN, dummy=True)),
        "jax": run_loop(*make_system(jservices, JCHAIN)),
    }


@pytest.mark.parametrize("data", [b"", b"abc", bytes(range(135)),
                                  bytes(range(136)), bytes(range(137)) * 3])
def test_keccak256_matches_reference(data):
    known = {
        b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
        b"abc":
            "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
    }
    assert keccak256(data) == jkeccak256(data)
    if data in known:
        assert keccak256(data).hex() == known[data]


def test_operator_advances_contract_through_epochs(loops):
    contract = loops["port"]
    assert contract.latest_block >= 70
    # crossed epochs 1, 2, 3: rotations stored
    assert {1, 2, 3} <= set(contract.authority_set_id_to_hash)
    assert contract.authority_set_id_to_hash[2] == \
        chained_hash(CHAIN.era_pubkeys(2))
    # every epoch-end block is a committed head (stepping stone)
    assert 20 in contract.block_height_to_header_hash
    assert contract.block_height_to_header_hash[40] == \
        CHAIN.get_block_hash(40)


@pytest.mark.parametrize("other", ["jax", "dummy"])
def test_operator_loop_matches(loops, other):
    """The same loop's contract state and events, byte for byte: through
    the JAX package's gateway, and through the port's dummy gateway."""
    assert snapshot(loops["port"]) == snapshot(loops[other])


def test_commitments_match_fetcher(loops):
    contract = loops["port"]
    stored = [e for e in contract.events
              if e.name == "HeaderRangeCommitmentStored"]
    assert len(stored) == len(contract.data_root_commitments) >= 4
    for ev in stored:
        start, end = ev.args["startBlock"], ev.args["endBlock"]
        key = range_key(start, end)
        assert contract.range_start_blocks[key] == start
        state_c, data_c = CHAIN.get_merkle_root_commitments(16, start, end)
        assert contract.data_root_commitments[key] == data_c
        assert contract.state_root_commitments[key] == state_c


def test_blocks_behind_head_health_signal():
    gw, contract, op = make_system(services, CHAIN, device="cpu")
    before = op.blocks_behind_head()
    assert before == CHAIN.get_head().block_number - contract.latest_block > 0
    res = op.run_once()
    drain(gw)
    assert res["blocks_behind_head"] == before  # measured pre-fulfill
    assert op.blocks_behind_head() < before     # catching up


def test_operator_waits_for_rotate_at_epoch_end():
    """A contract stuck at an epoch end knowing only the old set: the
    header_range waits until the rotate for the next set lands
    (vectorx.rs:229-238)."""
    gw = make_gateway(CHAIN, max_authority_set_size=8, max_num_headers=16,
                      device="cpu")
    contract = VectorXContract(
        gw, EPOCH, CHAIN.get_block_hash(EPOCH), 0,
        chained_hash(CHAIN.era_pubkeys(0)),
        header_range_commitment_tree_size=16)
    op = VectorXOperator(contract, CHAIN,
                         OperatorConfig(update_delay_blocks=10))
    assert op.find_and_request_header_range() is False
    assert op.find_and_request_rotate() is True
    drain(gw)
    assert op.find_and_request_header_range() is True
    drain(gw)
    assert contract.latest_block > EPOCH


def test_frozen_contract_rejects_commits():
    gw, contract, op = make_system(services, CHAIN, dummy=True)
    contract.update_freeze(True)
    op.run_once()
    with pytest.raises(ContractError, match="ContractFrozen"):
        drain(gw)
    assert contract.latest_block == 4


def test_justification_indexer_and_store():
    """The port's indexer over 25 blocks, its store equal to the JAX
    package's indexer's."""
    store, jstore = JustificationStore(), JJustificationStore()
    assert JustificationIndexer(CHAIN, store).run_follow(up_to=25) == 25
    jservices.JustificationIndexer(JCHAIN, jstore).run_follow(up_to=25)
    assert store.backend.dump() == jstore.backend.dump()
    assert store.get_blocks_in_range("fixture", 10, 20) == \
        list(range(10, 21))
    j = store.get_justification("fixture", 20)   # epoch end block
    assert j.authority_set_id == 0               # signed by the old set
    assert sum(j.validator_signed) * 3 > j.num_authorities * 2
    assert StoredJustificationData.from_json(j.to_json()) == j


def test_events_indexer_cursor_and_ranges(loops):
    contract = loops["port"]
    store = JustificationStore()
    ev_idx = EventsIndexer(contract, store, eth_chain_id=1)
    stored = ev_idx.run_once()
    assert stored == len(contract.data_root_commitments)
    assert ev_idx.run_once() == 0    # cursor advanced, nothing new
    ranges = store.get_data_commitment_ranges(1, contract.address, 0, 10**9)
    assert len(ranges) == stored
    for start, end, commitment in ranges:
        assert contract.data_root_commitments[range_key(start, end)] == \
            commitment


def test_fill_block_range_recovery():
    _, contract, _ = make_system(services, CHAIN, dummy=True)
    fill = compute_fill(CHAIN, 4, 52, tree_size=16)
    assert dataclasses.asdict(fill) == dataclasses.asdict(
        jservices.compute_fill(JCHAIN, 4, 52, tree_size=16))
    apply_fill(contract, fill)
    assert contract.latest_block == 52
    assert contract.block_height_to_header_hash[52] == \
        CHAIN.get_block_hash(52)
    _, data_c = CHAIN.get_merkle_root_commitments(16, 4, 20)
    assert contract.data_root_commitments[range_key(4, 20)] == data_c


def test_genesis_display():
    g = compute_genesis(CHAIN, 10)
    assert g.display() == jservices.compute_genesis(JCHAIN, 10).display()
    assert "GENESIS_HEIGHT=10" in g.display()
    assert g.header_hash == CHAIN.get_block_hash(10)


def test_gateway_names_its_device_and_mode():
    """No mode runs without a device but the dummy, and the succinct mode,
    not ported yet, raises when the gateway is built."""
    with pytest.raises(ValueError, match="device"):
        make_gateway(CHAIN, max_num_headers=16)
    with pytest.raises(ValueError, match="device"):
        make_gateway(CHAIN, max_num_headers=16, dummy=True, zk=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A-5"):
        make_gateway(CHAIN, max_num_headers=16, zk="succinct",
                     device="cpu")


def test_config_matches_reference(monkeypatch, tmp_path):
    env = {"AVAIL_URL": "wss://node.example", "CHAIN_ID": "5",
           "HEADER_RANGE_FUNCTION_ID": "0x" + "ab" * 32,
           "LOOP_DELAY_MINS": "3", "IS_DUMMY_OPERATOR": "true",
           "HEADER_RANGE_COMMITMENT_TREE_SIZE": "512"}
    monkeypatch.chdir(tmp_path)          # no .env here
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("VECTORX_DEVICE", raising=False)
    got = config.Config.from_env()
    want = dataclasses.asdict(jconfig.Config.from_env())
    assert dataclasses.asdict(got) == dict(want, device="cuda")
    monkeypatch.setenv("VECTORX_DEVICE", "cpu")
    assert config.require_device(config.Config.from_env()) == \
        torch.device("cpu")
    path = os.path.join(REPO, "deployments.json")
    assert config.load_deployments(path) == jconfig.load_deployments(path)


# ---- the zk gateway at tree 2 ---------------------------------------------

ZK_CFG = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=0,
                                   num_queries=12, final_poly_len=4,
                                   pow_bits=0))
ZK_CHAIN = FixtureChain(seed=19, num_blocks=12, epoch_length=6,
                        authorities_per_era=lambda e: 4)


@pytest.fixture(scope="module")
def zk_gateway():
    """`tests/test_zk_header_range.py`'s zk gateway at tree 2 on the port,
    fulfilled once: the gateway proves and verifies its proof.  The
    component proofs come from the golden fixtures of the same statements
    (the reference's proofs, whose JSON the port's proofs equal:
    `test_torch_header_range.py::test_zk_component_proofs_match_reference`);
    the gateway's verifier checks them for real."""
    orig = zk_header_range.prove

    def golden(air, trace, cfg, *, device):
        path = os.path.join(FIXTURE_DIR, _key(air, trace, cfg) + ".json.gz")
        with gzip.open(path, "rt") as f:
            return proof_from_json(json.load(f))

    gw = make_gateway(ZK_CHAIN, max_authority_set_size=8, max_num_headers=2,
                      zk=True, stark_config=ZK_CFG, device="cpu")
    g = compute_genesis(ZK_CHAIN, 7)
    contract = VectorXContract(
        gw, g.height, g.header_hash, g.authority_set_id,
        g.authority_set_hash, header_range_commitment_tree_size=2)
    fid = contract.header_range_function_id
    prover, verifier = gw.provers[fid]
    proved = []

    def recording(inp):
        proved.append(prover(inp))
        return proved[-1]

    gw.register_prover(fid, recording, verifier)
    contract.request_header_range(g.authority_set_id, 9)
    zk_header_range.prove = golden
    try:
        gw.fulfill_next()
    finally:
        zk_header_range.prove = orig
    return g, contract, proved


def test_zk_gateway_commits_the_verified_output(zk_gateway):
    g, contract, proved = zk_gateway
    assert len(proved) == 1
    out, zkp = proved[0]
    inp = HeaderRangeInput(7, ZK_CHAIN.get_block_hash(7), 1,
                           chained_hash(ZK_CHAIN.era_pubkeys(1)), 9).encode()
    want = DummyHeaderRange(2).run(inp, ZK_CHAIN)
    assert zkp.input_bytes == inp and out == want
    assert contract.latest_block == 9
    assert contract.block_height_to_header_hash[9] == want[:32]
    key = range_key(7, 9)
    assert contract.state_root_commitments[key] == want[32:64]
    assert contract.data_root_commitments[key] == want[64:96]


@pytest.mark.parametrize("tamper", ["output", "proof"])
def test_zk_gateway_tamper_reverts(zk_gateway, tamper):
    """The gateway's proof, replayed with a tampered output or a tampered
    header hash inside it, makes the fulfillment revert before the contract
    callback runs; nothing proves again."""
    g, contract, proved = zk_gateway
    out, zkp = proved[0]
    if tamper == "output":
        out = bytes([out[0] ^ 1]) + out[1:]
    else:
        zkp = dataclasses.replace(
            zkp, header_hashes=[bytes(32)] + list(zkp.header_hashes[1:]))
    gw = MockGateway()
    fresh = VectorXContract(
        gw, g.height, g.header_hash, g.authority_set_id,
        g.authority_set_hash, header_range_commitment_tree_size=2)
    before = snapshot(fresh)
    gw.register_prover(fresh.header_range_function_id,
                       lambda inp: (out, zkp),
                       contract.gateway.provers[
                           contract.header_range_function_id][1])
    fresh.request_header_range(g.authority_set_id, 9)
    with pytest.raises(ContractError, match="GatewayProofRejected"):
        gw.fulfill_next()
    after = json.loads(snapshot(fresh))
    after["events"] = after["events"][:-1]  # the request's own event
    assert json.dumps(after, sort_keys=True) == before
    assert len(proved) == 1


# ---- the subchain commitment over the tree's own leaves --------------------

@pytest.mark.parametrize("tree", [2, 4, 8, 16])
def test_subchain_commits_over_the_tree(tree):
    """`chip_smoke.py` phase 7's chain shape (mixed header sizes, the range
    (2 tree, 3 tree] of set 1), with 4 authorities: the port's circuit
    equals the dummy at every tree; the JAX package's equals it at 8 and
    16 and differs at 2 and 4 (a reference fault kept there)."""
    base, frac = 2048 - 180, (100, 10, 60, 25)
    kw = dict(seed=19, num_blocks=3 * tree + 2, epoch_length=2 * tree,
              authorities_per_era=lambda e: 4,
              extension_bytes=lambda b: base * frac[b % 4] // 100)
    chain, jchain = FixtureChain(**kw), JFixtureChain(**kw)
    trusted, target = 2 * tree, 3 * tree
    inp = HeaderRangeInput(trusted, chain.get_block_hash(trusted), 1,
                           chained_hash(chain.era_pubkeys(1)),
                           target).encode()
    want = DummyHeaderRange(tree).run(inp, chain)
    assert want == JDummyHeaderRange(tree).run(inp, jchain)
    assert HeaderRangeCircuit(8, 4096, tree).run(inp, chain,
                                                 device="cpu") == want
    ref = JHeaderRangeCircuit(8, 4096, tree).run(inp, jchain)
    assert ref[:32] == want[:32]                 # the target header hash
    if tree >= 8:
        assert ref == want
    else:
        assert ref[32:64] != want[32:64] and ref[64:] != want[64:]


# ---- the CLIs ---------------------------------------------------------------

def run_cli(name, args, cwd, **env):
    full = dict(os.environ, PYTHONPATH=REPO, VECTORX_BACKEND="fixture",
                VECTORX_DEVICE="cpu")
    full.update(env)
    return subprocess.run(
        [sys.executable, "-m", f"vectorx_tpu_torch.bin.{name}", *args],
        cwd=cwd, env=full, capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def cli_chain():
    """The fixture backend's chain (`make_fetcher`: seed 0, 256 blocks,
    epochs of 64, 4 authorities) in both packages."""
    chain = config.make_fetcher(config.Config())
    jchain = jconfig.make_fetcher(jconfig.Config())
    assert chain.get_block_hash(200) == jchain.get_block_hash(200)
    return chain, jchain


@pytest.mark.parametrize("name", ["dummy_header_range_256", "rotate"])
def test_cli_build_and_prove(cli_chain, tmp_path, name):
    """`build` writes the manifest; `prove` writes output.json with the
    output of the port's and the JAX package's circuits in-process."""
    chain, jchain = cli_chain
    if name == "rotate":
        inp = RotateInput(1, chained_hash(chain.era_pubkeys(1))).encode()
        want = RotateCircuit().run(inp, chain)
        assert want == JRotateCircuit().run(inp, jchain)
    else:
        inp = HeaderRangeInput(64, chain.get_block_hash(64), 1,
                               chained_hash(chain.era_pubkeys(1)),
                               128).encode()
        want = DummyHeaderRange(256).run(inp, chain)
        assert want == JDummyHeaderRange(256).run(inp, jchain)
    out = run_cli(name, ["build"], tmp_path)
    assert out.returncode == 0, out.stderr
    manifest = json.loads((tmp_path / "build" / f"{name}.json").read_text())
    assert manifest["name"] == name
    (tmp_path / "input.json").write_text(json.dumps(
        {"data": {"input": "0x" + inp.hex()}}))
    out = run_cli(name, ["prove", "input.json"], tmp_path)
    assert out.returncode == 0, out.stderr
    result = json.loads((tmp_path / "output.json").read_text())
    assert result["data"]["input"] == "0x" + inp.hex()
    assert result["data"]["output"] == "0x" + want.hex()


@pytest.mark.parametrize("name,args", [
    ("header_range_256", ["prove", "input.json"]),
    ("operator", ["--iterations", "1", "--no-sleep"]),
])
def test_cli_without_cuda_exits_nonzero(tmp_path, name, args):
    """`VECTORX_DEVICE=cuda` where no CUDA device is visible: the entry
    point exits non-zero with a message before any work, never carrying
    on on the CPU."""
    (tmp_path / "input.json").write_text(json.dumps(
        {"data": {"input": "0x" + bytes(104).hex()}}))
    out = run_cli(name, args, tmp_path, VECTORX_DEVICE="cuda",
                  CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "VECTORX_DEVICE=cuda" in out.stderr
    assert not (tmp_path / "output.json").exists()


def test_cli_operator_loop(tmp_path):
    """The operator CLI on the fixture backend as a dummy operator (no
    device): it loops, fulfils and reports the contract's head."""
    out = run_cli("operator", ["--iterations", "2", "--no-sleep",
                               "--genesis-block", "60"], tmp_path,
                  IS_DUMMY_OPERATOR="true")
    assert out.returncode == 0, out.stderr
    heads = [int(line.split("contract head=")[1].split()[0])
             for line in out.stderr.splitlines() if "contract head=" in line]
    assert len(heads) == 2 and 60 < heads[0] <= heads[1]

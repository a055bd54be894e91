"""The port's live Avail RPC backend on recorded responses, the twin of
`tests/test_avail_rpc.py`: `urlopen` is swapped for the same replay of
recorded-format results, so the parsing path (hex framing, SCALE authority
decode, storage reads, binary search, retry discipline) runs hermetically
with zero egress.  Each answer is also the JAX package's on the same
recording."""

import json

import pytest

from test_avail_rpc import PUBKEYS, _key, _Replay, _Resp
from vectorx_tpu.io.avail_rpc import AvailRpcFetcher as JAvailRpcFetcher
from vectorx_tpu_torch import scale
from vectorx_tpu_torch.hash.sha256 import chained_hash
from vectorx_tpu_torch.io.avail_rpc import AvailRpcFetcher, RpcError

URLOPEN = "urllib.request.urlopen"


def _authorities_scale(pubkeys, weight=1):
    out = scale.compact_encode(len(pubkeys))
    for pk in pubkeys:
        out += pk + int(weight).to_bytes(8, "little")
    return "0x" + out.hex()


def _fetchers(monkeypatch, recorded, fail_first=0):
    """The port's fetcher and the JAX package's over one replay each."""
    replays = [_Replay(recorded, fail_first=fail_first) for _ in range(2)]
    out = []
    for cls, replay in zip((AvailRpcFetcher, JAvailRpcFetcher), replays):
        monkeypatch.setattr(cls, "RETRY_DELAY_S", 0.0)
        f = cls("wss://node.example/ws")
        assert f.url.startswith("https://")
        out.append((f, replay))
    return out


def _call(monkeypatch, fetcher, replay, fn):
    monkeypatch.setattr(URLOPEN, replay)
    return fn(fetcher)


def _both(monkeypatch, recorded, fn, fail_first=0):
    """`fn` on the port's fetcher, asserted equal to the JAX package's."""
    (f, r), (jf, jr) = _fetchers(monkeypatch, recorded, fail_first)
    got = _call(monkeypatch, f, r, fn)
    assert got == _call(monkeypatch, jf, jr, fn)
    assert r.calls == jr.calls
    return got, r


def test_block_hash_header_and_finalized_head(monkeypatch):
    h7 = "0x" + (b"\xab" * 32).hex()
    header = {"number": "0x7", "parentHash": "0x" + "00" * 32,
              "stateRoot": "0x" + "11" * 32}
    recorded = {
        _key("chain_getBlockHash", [7]): h7,
        _key("chain_getHeader", [h7]): header,
        _key("chain_getFinalizedHead", []): h7,
    }
    got, _ = _both(monkeypatch, recorded, lambda f: (
        f.get_block_hash(7), f.get_header_json(b"\xab" * 32)["number"],
        f.get_finalized_head_hash(), f.get_head().block_number))
    assert got == (b"\xab" * 32, "0x7", b"\xab" * 32, 7)


def test_authorities_scale_decode_and_set_hash(monkeypatch):
    h9 = "0x" + (b"\xcd" * 32).hex()
    recorded = {
        _key("chain_getBlockHash", [9]): h9,
        _key("state_call",
             ["GrandpaApi_grandpa_authorities", "0x", h9]):
            _authorities_scale(PUBKEYS),
    }
    got, _ = _both(monkeypatch, recorded, lambda f: (
        f.get_authorities(9), f.compute_authority_set_hash(9)))
    assert got == (PUBKEYS, chained_hash(PUBKEYS))


def test_non_unit_weight_rejected(monkeypatch):
    h9 = "0x" + (b"\xcd" * 32).hex()
    recorded = {
        _key("chain_getBlockHash", [9]): h9,
        _key("state_call",
             ["GrandpaApi_grandpa_authorities", "0x", h9]):
            _authorities_scale(PUBKEYS, weight=2),
    }
    (f, replay), _ = _fetchers(monkeypatch, recorded)
    monkeypatch.setattr(URLOPEN, replay)
    with pytest.raises(AssertionError, match="weight"):
        f.get_authorities(9)


def test_authority_set_id_storage_read(monkeypatch):
    h5 = "0x" + (b"\x05" * 32).hex()
    recorded = {
        _key("chain_getBlockHash", [5]): h5,
        _key("state_getStorage",
             [AvailRpcFetcher.GRANDPA_CURRENT_SET_ID_KEY, h5]):
            "0x" + (42).to_bytes(8, "little").hex(),
    }
    got, _ = _both(monkeypatch, recorded,
                   lambda f: f.get_authority_set_id(5))
    assert got == 42


def test_last_justified_block_binary_search(monkeypatch):
    """Set id flips 7 -> 8 at block 13: last_justified_block(7) == 13, by a
    binary search (the same RPC calls as the reference's)."""
    head = 20
    recorded = {}
    hh = "0x" + (b"\xee" * 32).hex()
    recorded[_key("chain_getFinalizedHead", [])] = hh
    recorded[_key("chain_getHeader", [hh])] = {"number": hex(head)}
    for n in range(head + 1):
        bh = "0x" + n.to_bytes(1, "big").hex().rjust(64, "0")
        recorded[_key("chain_getBlockHash", [n])] = bh
        recorded[_key("state_getStorage",
                      [AvailRpcFetcher.GRANDPA_CURRENT_SET_ID_KEY, bh])] = \
            "0x" + (7 if n < 13 else 8).to_bytes(8, "little").hex()
    got, replay = _both(monkeypatch, recorded,
                        lambda f: f.last_justified_block(7))
    assert got == 13
    assert sum(1 for m, _ in replay.calls if m == "chain_getBlockHash") <= 16


@pytest.mark.parametrize("fail_first,ok", [(2, True), (3, False)])
def test_retry_then_success_or_exhaustion(monkeypatch, fail_first, ok):
    """Two failures then success stays within the 3-attempt budget; three
    exhaust it."""
    recorded = {_key("chain_getBlockHash", [7]): "0x" + (b"\xab" * 32).hex()}
    (f, replay), _ = _fetchers(monkeypatch, recorded, fail_first)
    monkeypatch.setattr(URLOPEN, replay)
    if ok:
        assert f.get_block_hash(7) == b"\xab" * 32
        assert len(replay.calls) == 3
    else:
        with pytest.raises(RpcError, match="failed after retries"):
            f.get_block_hash(7)


def test_rpc_error_payload_raises(monkeypatch):
    def err(req, timeout=None):
        body = json.loads(req.data)
        return _Resp({"jsonrpc": "2.0", "id": body["id"],
                      "error": {"code": -32601, "message": "nope"}})

    monkeypatch.setattr(URLOPEN, err)
    monkeypatch.setattr(AvailRpcFetcher, "RETRY_DELAY_S", 0.0)
    with pytest.raises(RpcError):
        AvailRpcFetcher("http://node.example").get_block_hash(7)

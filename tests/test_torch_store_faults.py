"""The port's Redis (RESP2) backend under injected faults, the twin of
`tests/test_store_faults.py`: dropped connections mid-stream reconnect with
the reference's retry discipline (3 attempts) and replay the command,
against the same in-process RESP2 server.  The port's store also writes
the JAX package's keys and values."""

import pytest

from test_store_faults import FlakyRedis
from vectorx_tpu.io import store as jstore
from vectorx_tpu_torch.io.store import (JustificationStore, MemoryBackend,
                                        RespBackend, StoredJustificationData)


@pytest.fixture
def flaky():
    servers = []

    def make(drop_every=0):
        s = FlakyRedis(drop_every=drop_every)
        servers.append(s)
        return s

    yield make
    for s in servers:
        s.close()


@pytest.fixture
def no_delay(monkeypatch):
    monkeypatch.setattr(RespBackend, "RECONNECT_DELAY_S", 0.0)


def _backend(server):
    return RespBackend("127.0.0.1", server.port, timeout=2.0)


def _justification(bn):
    return StoredJustificationData(
        block_number=bn, signed_message=b"\x01".hex(), pubkeys=[],
        signatures=[], validator_signed=[], num_authorities=0,
        authority_set_id=1)


def test_roundtrip_against_real_resp2(flaky, no_delay):
    b = _backend(flaky())
    b.set("k", "v1")
    assert b.get("k") == "v1"
    assert b.get("missing") is None
    b.zadd("z", 3, "c")
    b.zadd("z", 1, "a")
    assert b.zrangebyscore("z", 0, 5) == ["a", "c"]


def test_dropped_connection_reconnects_and_replays(flaky, no_delay):
    srv = flaky(drop_every=3)
    b = _backend(srv)
    for i in range(10):
        b.set(f"k{i}", f"v{i}")
    for i in range(10):
        assert b.get(f"k{i}") == f"v{i}"
    assert srv.accepts >= 3          # reconnects actually happened


def test_justification_store_survives_faults(flaky, no_delay):
    store = JustificationStore(backend=_backend(flaky(drop_every=4)))
    for bn in (5, 6, 9):
        store.add_justification("avail", _justification(bn))
    assert store.get_justification("avail", 6).block_number == 6
    assert store.get_blocks_in_range("avail", 5, 9) == [5, 6, 9]


def test_connect_failure_raises_after_retries(no_delay):
    with pytest.raises(ConnectionError, match="after 3 attempts"):
        RespBackend("127.0.0.1", 1)      # port 1: nothing listens


def test_store_writes_the_reference_keys_and_values():
    """The same calls on the port's store and the JAX package's leave the
    same keys, values and sorted sets behind (a memory dump each)."""
    stores = [JustificationStore(MemoryBackend()),
              jstore.JustificationStore(jstore.MemoryBackend())]
    for s, make in zip(stores, (StoredJustificationData,
                                jstore.StoredJustificationData)):
        for bn in (9, 5, 6):
            s.add_justification("avail", make(**vars(_justification(bn))))
        s.set_contract_cursor(1, "0xAbC", 17)
        s.add_data_commitment_range(1, "0xAbC", 4, 20, b"\x07" * 32)
        s.add_data_commitment_range(1, "0xAbC", 20, 36, b"\x08" * 32)
    port, ref = stores
    assert port.backend.dump() == ref.backend.dump()
    assert port.get_data_commitment_ranges(1, "0xabc", 0, 50) == \
        ref.get_data_commitment_ranges(1, "0xabc", 0, 50)
    back = MemoryBackend.load(port.backend.dump())
    assert JustificationStore(back).get_justification("avail", 9) == \
        port.get_justification("avail", 9)

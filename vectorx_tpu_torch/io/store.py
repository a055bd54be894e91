"""Justification / cursor / commitment-range store (C11).

Equivalent of the reference `RedisClient`
(upstream circuits/input/mod.rs:35-238): justifications stored as
JSON under ``{chain}:justification:{block}`` with a sorted-set block index,
per-contract event cursors, and data-commitment ranges as ABI-packed tuples
scored by end block.

Two backends share one interface:
* `MemoryBackend` — dict/sorted lists (default; also JSON-file persistable);
* `RespBackend` — a minimal RESP2 Redis client over a stdlib socket (no
  redis-py in the image); justifications are plain JSON strings (`SET`)
  rather than RedisJSON documents.

A copy of `vectorx_tpu.io.store` (host code; the port imports no module of
the JAX package).
"""

from __future__ import annotations

import bisect
import json
import socket
from dataclasses import asdict, dataclass


@dataclass
class StoredJustificationData:
    """Mirror of input/types.rs `StoredJustificationData`."""

    block_number: int
    signed_message: str          # hex
    pubkeys: list[str]           # hex, canonical order
    signatures: list[str]        # hex, aligned (dummy for non-signers)
    validator_signed: list[bool]
    num_authorities: int
    authority_set_id: int

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, data: str) -> "StoredJustificationData":
        return cls(**json.loads(data))


class MemoryBackend:
    def __init__(self):
        self.kv: dict[str, str] = {}
        self.zsets: dict[str, list[tuple[float, str]]] = {}

    def set(self, key: str, value: str) -> None:
        self.kv[key] = value

    def get(self, key: str) -> str | None:
        return self.kv.get(key)

    def zadd(self, key: str, score: float, member: str) -> None:
        z = self.zsets.setdefault(key, [])
        for i, (s, m) in enumerate(z):
            if m == member:
                del z[i]
                break
        bisect.insort(z, (score, member))

    def zrangebyscore(self, key: str, lo: float, hi: float) -> list[str]:
        return [m for (s, m) in self.zsets.get(key, []) if lo <= s <= hi]

    def dump(self) -> str:
        return json.dumps({"kv": self.kv, "zsets": self.zsets})

    @classmethod
    def load(cls, data: str) -> "MemoryBackend":
        b = cls()
        d = json.loads(data)
        b.kv = d["kv"]
        b.zsets = {k: [tuple(x) for x in v] for k, v in d["zsets"].items()}
        return b


class RespBackend:
    """Minimal RESP2 client: SET / GET / ZADD / ZRANGEBYSCORE.

    Reconnects with the reference's retry discipline — 3 attempts with a
    delay between them (upstream circuits/input/mod.rs:60-78) —
    on a dropped connection, replaying the failed command once the new
    connection is up."""

    RECONNECT_ATTEMPTS = 3
    RECONNECT_DELAY_S = 5.0

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 timeout: float = 5.0):
        self.host, self.port, self.timeout = host, port, timeout
        self.sock = None
        self.buf = b""
        self._connect()

    def _connect(self):
        last = None
        for attempt in range(self.RECONNECT_ATTEMPTS):
            try:
                self.sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout)
                self.buf = b""
                return
            except OSError as e:
                last = e
                if attempt + 1 < self.RECONNECT_ATTEMPTS:
                    import time

                    time.sleep(self.RECONNECT_DELAY_S)
        raise ConnectionError(
            f"redis connect failed after {self.RECONNECT_ATTEMPTS} "
            f"attempts: {last}")

    def _cmd(self, *parts):
        msg = f"*{len(parts)}\r\n".encode()
        for p in parts:
            if isinstance(p, str):
                p = p.encode()
            msg += f"${len(p)}\r\n".encode() + p + b"\r\n"
        try:
            self.sock.sendall(msg)
            return self._read_reply()
        except (OSError, ConnectionError):
            # dropped mid-command: reconnect (3 attempts) and replay once
            self._connect()
            self.sock.sendall(msg)
            return self._read_reply()

    def _read_line(self) -> bytes:
        while b"\r\n" not in self.buf:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        line, self.buf = self.buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self.buf) < n + 2:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("redis connection closed")
            self.buf += chunk
        data, self.buf = self.buf[:n], self.buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t in (b"+", b":"):
            return rest.decode()
        if t == b"-":
            raise RuntimeError(f"redis error: {rest.decode()}")
        if t == b"$":
            n = int(rest)
            return None if n == -1 else self._read_exact(n).decode()
        if t == b"*":
            n = int(rest)
            return [self._read_reply() for _ in range(n)]
        raise RuntimeError(f"unexpected reply {line!r}")

    def set(self, key, value):
        self._cmd("SET", key, value)

    def get(self, key):
        return self._cmd("GET", key)

    def zadd(self, key, score, member):
        self._cmd("ZADD", key, str(score), member)

    def zrangebyscore(self, key, lo, hi):
        return self._cmd("ZRANGEBYSCORE", key, str(lo), str(hi)) or []


class JustificationStore:
    """The C11 API surface over either backend."""

    def __init__(self, backend=None):
        self.backend = backend or MemoryBackend()

    # -- justifications (input/mod.rs:81-163) -------------------------------

    def add_justification(self, chain_id: str,
                          data: StoredJustificationData) -> None:
        self.backend.set(f"{chain_id}:justification:{data.block_number}",
                         data.to_json())
        self.backend.zadd(f"{chain_id}:justification:blocks",
                          data.block_number, str(data.block_number))

    def get_justification(self, chain_id: str,
                          block_number: int) -> StoredJustificationData | None:
        raw = self.backend.get(f"{chain_id}:justification:{block_number}")
        return StoredJustificationData.from_json(raw) if raw else None

    def get_blocks_in_range(self, chain_id: str, start: int,
                            end: int) -> list[int]:
        return sorted(int(b) for b in self.backend.zrangebyscore(
            f"{chain_id}:justification:blocks", start, end))

    # -- event cursors (input/mod.rs:165-200) -------------------------------

    def get_contract_cursor(self, eth_chain_id: int,
                            address: str) -> int | None:
        raw = self.backend.get(f"{eth_chain_id}:{address.lower()}:cursor")
        return int(raw) if raw is not None else None

    def set_contract_cursor(self, eth_chain_id: int, address: str,
                            cursor: int) -> None:
        self.backend.set(f"{eth_chain_id}:{address.lower()}:cursor",
                         str(cursor))

    # -- data-commitment ranges (input/mod.rs:202-238) ----------------------

    def add_data_commitment_range(self, chain_id: int, address: str,
                                  start: int, end: int,
                                  data_commitment: bytes) -> None:
        assert len(data_commitment) == 32
        packed = (start.to_bytes(4, "big") + end.to_bytes(4, "big")
                  + data_commitment)
        self.backend.zadd(f"{chain_id}:{address.lower()}:ranges", end,
                          packed.hex())

    def get_data_commitment_ranges(self, chain_id: int, address: str,
                                   start: int, end: int):
        out = []
        for member in self.backend.zrangebyscore(
                f"{chain_id}:{address.lower()}:ranges", start, end):
            raw = bytes.fromhex(member)
            out.append((int.from_bytes(raw[0:4], "big"),
                        int.from_bytes(raw[4:8], "big"), raw[8:40]))
        return out

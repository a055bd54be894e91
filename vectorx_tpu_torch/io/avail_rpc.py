"""Live Avail node client (C10's RPC backend) over HTTP JSON-RPC.

Equivalent of the reference `RpcDataFetcher`'s avail-subxt usage
(upstream circuits/input/mod.rs:292-968) with the same retry
discipline (3 attempts / 5 s — input/mod.rs:319-336).  Uses stdlib
urllib (no websocket/subxt client); Substrate nodes serve the
same RPC methods over HTTP POST.

NOTE: this backend requires network egress to an Avail node and is
therefore exercised only in deployments; the hermetic test suite runs
everything against `FixtureChain`, which shares this exact interface.

Port of `vectorx_tpu.io.avail_rpc` over the port's own `scale` and
`hash.sha256.chained_hash`.
"""

from __future__ import annotations

import json
import time
import urllib.request

from vectorx_tpu_torch import scale


class RpcError(RuntimeError):
    pass


class AvailRpcFetcher:
    MAX_ATTEMPTS = 3          # input/mod.rs:301
    RETRY_DELAY_S = 5.0       # input/mod.rs:302

    # grandpa.currentSetId storage key: xxhash128("Grandpa") ++
    # xxhash128("CurrentSetId") — precomputed, chain-independent.
    GRANDPA_CURRENT_SET_ID_KEY = (
        "0x5f9cc45b7a00c5899361e1c6099678dc8a2d09463effcc78a22d75b9cb87dffc")

    def __init__(self, url: str):
        assert url, "AVAIL_URL must be set for the rpc backend"
        self.url = url.replace("ws://", "http://").replace("wss://", "https://")
        self._id = 0
        self.epoch_length = None  # unknown for live chains

    def _call(self, method: str, params: list):
        last_err = None
        for _ in range(self.MAX_ATTEMPTS):
            try:
                self._id += 1
                body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                                   "method": method,
                                   "params": params}).encode()
                req = urllib.request.Request(
                    self.url, data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    out = json.loads(resp.read())
                if "error" in out:
                    raise RpcError(str(out["error"]))
                return out["result"]
            except Exception as e:  # noqa: BLE001 — retry everything
                last_err = e
                time.sleep(self.RETRY_DELAY_S)
        raise RpcError(f"{method} failed after retries: {last_err}")

    # -- primitive queries --------------------------------------------------

    def get_block_hash(self, block_number: int) -> bytes:
        res = self._call("chain_getBlockHash", [block_number])
        return bytes.fromhex(res.removeprefix("0x"))

    def get_header_json(self, block_hash: bytes) -> dict:
        return self._call("chain_getHeader", ["0x" + block_hash.hex()])

    def get_finalized_head_hash(self) -> bytes:
        res = self._call("chain_getFinalizedHead", [])
        return bytes.fromhex(res.removeprefix("0x"))

    def get_authority_set_id(self, block_number: int) -> int:
        at = "0x" + self.get_block_hash(block_number).hex()
        raw = self._call("state_getStorage",
                         [self.GRANDPA_CURRENT_SET_ID_KEY, at])
        return int.from_bytes(bytes.fromhex(raw.removeprefix("0x")), "little")

    def get_authorities(self, block_number: int) -> list[bytes]:
        """GrandpaApi_grandpa_authorities runtime call
        (input/mod.rs:612-639); asserts every weight is 1."""
        at = "0x" + self.get_block_hash(block_number).hex()
        raw = self._call("state_call",
                         ["GrandpaApi_grandpa_authorities", "0x", at])
        data = bytes.fromhex(raw.removeprefix("0x"))
        count, _, consumed = scale.compact_decode(data)
        out = []
        off = consumed
        for _ in range(count):
            pk = data[off:off + 32]
            weight = int.from_bytes(data[off + 32:off + 40], "little")
            assert weight == 1, "The weight of the authority is not 1!"
            out.append(pk)
            off += 40
        return out

    def compute_authority_set_hash(self, block_number: int) -> bytes:
        from vectorx_tpu_torch.hash.sha256 import chained_hash

        return chained_hash(self.get_authorities(block_number))

    # -- higher-level queries (same shapes as FixtureChain) -----------------

    def get_head(self):
        h = self.get_header_json(self.get_finalized_head_hash())

        class _Head:
            block_number = int(h["number"], 16)

        return _Head()

    def last_justified_block(self, target_authority_set_id: int) -> int:
        """Binary search over set ids (input/mod.rs:417-451)."""
        low, high = 0, self.get_head().block_number
        result = 0
        while low <= high:
            mid = (low + high) // 2
            mid_id = self.get_authority_set_id(mid)
            if mid_id == target_authority_set_id + 1:
                if mid == 0:
                    return mid
                if self.get_authority_set_id(mid - 1) == \
                        target_authority_set_id:
                    return mid
                high = mid - 1
            elif mid_id < target_authority_set_id + 1:
                low = mid + 1
            else:
                high = mid - 1
        return result

    def grandpa_prove_finality(self, block_number: int) -> bytes:
        res = self._call("grandpa_proveFinality", [block_number])
        return bytes.fromhex(res.removeprefix("0x"))

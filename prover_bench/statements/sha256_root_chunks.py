"""Traffic kind `sha256_root_chunks`: the batched SHA-256 chunk proofs of a
header_range request's state-root and data-root trees, one chunk a cycle.

A request of `tree_leaves` headers has two Merkle trees of SHA-256 over
32-byte roots; their interior nodes (64-byte messages, level by level,
the state tree first) are cut into chunks of as many nodes as fit
2^max_batch_log_n trace rows, as `circuits/zk_header_range.py` cuts them.
Statement i is full chunk i % C of request i // C, C full chunks a
request; every request's leaves are drawn from the seed.  The program
proves `Sha256Air(messages)` (bind="consts") at the configuration's
FriConfig and verifies it against `Sha256Air.statement(messages,
digests)`, as the gateway does before it commits.
"""

from __future__ import annotations

import hashlib
import importlib

import numpy as np

from prover_bench import compare
from prover_bench.seeds import derive


def tree_messages(leaves: list[bytes]) -> tuple[list, list]:
    """Level-major interior-node messages of a SHA-256 Merkle tree over
    `leaves` (a power of two of them), with their digests."""
    msgs, digs = [], []
    level = list(leaves)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), 2):
            m = level[i] + level[i + 1]
            d = hashlib.sha256(m).digest()
            msgs.append(m)
            digs.append(d)
            nxt.append(d)
        level = nxt
    return msgs, digs


class Statements:
    checks = {"trace_diff": 0, "proof_diff": 0}

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config = config
        self.seed = seed
        self.device = device
        self.leaves = config["tree_leaves"]
        self.per_chunk = ((1 << config["max_batch_log_n"])
                          // config["sha256_rows_per_node"])
        self.chunks = 2 * (self.leaves - 1) // self.per_chunk
        self._request = (None, None)
        self._prover = importlib.import_module(
            "vectorx_tpu_torch.stark.prover")
        self._verifier = importlib.import_module(
            "vectorx_tpu_torch.stark.verifier")
        self._air = importlib.import_module(
            "vectorx_tpu_torch.stark.sha256_air")
        fri = importlib.import_module("vectorx_tpu_torch.fri.fri")
        self.stark_config = self._prover.StarkConfig(
            fri=fri.FriConfig(**config["fri"]))

    def _requests(self, r: int):
        if self._request[0] != r:
            rng = np.random.default_rng(derive(self.seed, "request", r))
            raw = rng.bytes(64 * self.leaves)
            state = [raw[32 * i:32 * i + 32] for i in range(self.leaves)]
            data = [raw[32 * i:32 * i + 32]
                    for i in range(self.leaves, 2 * self.leaves)]
            sm, sd = tree_messages(state)
            dm, dd = tree_messages(data)
            self._request = (r, (sm + dm, sd + dd))
        return self._request[1]

    def inputs(self, i: int) -> dict:
        r, k = divmod(i, self.chunks)
        msgs, digs = self._requests(r)
        s = k * self.per_chunk
        return {"messages": msgs[s:s + self.per_chunk],
                "digests": digs[s:s + self.per_chunk]}

    def prove(self, inp: dict, rec) -> dict:
        with rec.span("trace_build"):
            air = self._air.Sha256Air(inp["messages"])
            trace = air.build_trace()
        proof = self._prover.prove(air, trace, self.stark_config,
                                   device=self.device)
        return {"trace": trace, "proof": proof}

    def verify(self, inp: dict, out: dict) -> bool:
        air = self._air.Sha256Air.statement(inp["messages"], inp["digests"])
        return bool(self._verifier.verify(air, out["proof"],
                                          self.stark_config,
                                          device=self.device))

    def keep(self, out: dict) -> dict:
        return {"trace": np.asarray(out["trace"], dtype=np.uint64),
                "proof": out["proof"]}

    def reference(self, inp: dict, fri: dict | None = None) -> dict:
        from prover_bench import reference

        trace, proof = reference.sha256_chunk_proof(
            inp["messages"], fri or self.config["fri"], self.device)
        return {"trace": trace, "proof": proof}

    def compare(self, kept: dict, ref: dict) -> dict:
        return {"trace_diff": compare.array_diff(kept["trace"], ref["trace"]),
                "proof_diff": compare.proof_diff(kept["proof"], ref["proof"])}

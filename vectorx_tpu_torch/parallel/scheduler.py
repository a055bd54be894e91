"""Distributed proof scheduler with per-stage checkpointing.  Port of
`vectorx_tpu.parallel.scheduler`.

A header_range job is decomposed into deterministic, content-keyed stages

    leaf:<j>       — fetch + hash + link-check 8 headers (Blake2b on the
                     job's device)
    reduce:<l>:<k> — combine two subchain nodes (SHA-256 parent)
    justify        — simple-justification check on the target header
    output         — assemble the packed ABI output

whose results persist in a `CheckpointStore` (JSON files in a directory
that every worker sees).  Any worker can resume a partially complete job;
leaves are partitioned deterministically over workers (leaf j → worker
j mod n_workers), so the workers split the map stage without coordination.

A leaf and a reduce run `circuits.subchain`'s own map and reduce steps.
The stage values equal the reference's, stage for stage, with one
exception the port's subchain also makes: below tree 8 a leaf commits over
the first `max_num_headers` of its 8 header slots, as the fetcher, the
dummy circuit and `circuits.subchain` do (the reference commits over all 8
there, `vectorx_tpu/circuits/subchain.py:82-83`).
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass, field
from pathlib import Path

from vectorx_tpu_torch.circuits.justification import \
    verify_simple_justification
from vectorx_tpu_torch.circuits.subchain import (HEADERS_PER_MAP, LeafOut,
                                                 SubchainError, _next_pow2,
                                                 fetch_headers, map_leaf,
                                                 reduce_pair)
from vectorx_tpu_torch.hash.sha256 import sha256
from vectorx_tpu_torch.io.abi import HeaderRangeInput, HeaderRangeOutput


class CheckpointStore:
    """Keyed JSON blobs on the filesystem; `None` path = in-memory only.
    A write goes to a temporary file of the writing process and is renamed
    into place, so concurrent writers of one stage never see a torn file."""

    def __init__(self, root: str | None = None):
        self.root = Path(root) if root else None
        if self.root:
            self.root.mkdir(parents=True, exist_ok=True)
        self.mem: dict[str, dict] = {}

    def _path(self, job: str, stage: str) -> Path:
        safe = stage.replace(":", "_")
        return self.root / job / f"{safe}.json"

    def get(self, job: str, stage: str) -> dict | None:
        if (v := self.mem.get(f"{job}/{stage}")) is not None:
            return v
        if self.root:
            p = self._path(job, stage)
            if p.exists():
                v = json.loads(p.read_text())
                self.mem[f"{job}/{stage}"] = v
                return v
        return None

    def put(self, job: str, stage: str, value: dict) -> None:
        self.mem[f"{job}/{stage}"] = value
        if self.root:
            p = self._path(job, stage)
            p.parent.mkdir(parents=True, exist_ok=True)
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(json.dumps(value))
            tmp.rename(p)

    def stages_done(self, job: str) -> int:
        """Memory entries plus files of `job`, as the reference counts
        (a stage both read or written and on disk counts twice)."""
        return len([k for k in self.mem if k.startswith(f"{job}/")]) + (
            len(list((self.root / job).glob("*.json")))
            if self.root and (self.root / job).exists() else 0)


@dataclass
class SchedulerStats:
    computed: int = 0
    cached: int = 0


def _merkle8(leaves: list[bytes]) -> bytes:
    """SHA-256 root over a leaf's committed header slots."""
    nodes = list(leaves)
    while len(nodes) > 1:
        nodes = [sha256(nodes[2 * i] + nodes[2 * i + 1])
                 for i in range(len(nodes) // 2)]
    return nodes[0]


def _node_json(n: LeafOut) -> dict:
    """A stage's value: the reference's JSON of a subchain node."""
    return {"num_blocks": n.num_blocks, "start_block": n.start_block,
            "start_header_hash": n.start_header_hash.hex(),
            "start_parent": n.start_parent.hex(), "end_block": n.end_block,
            "end_header_hash": n.end_header_hash.hex(),
            "state_root": n.state.hex(), "data_root": n.data.hex()}


def _node(v: dict) -> LeafOut:
    h = bytes.fromhex
    return LeafOut(v["num_blocks"], v["start_block"],
                   h(v["start_header_hash"]), h(v["start_parent"]),
                   v["end_block"], h(v["end_header_hash"]),
                   h(v["state_root"]), h(v["data_root"]))


@dataclass
class HeaderRangeJob:
    """Staged, resumable header_range proving job; Blake2b runs on
    `device`."""

    fetcher: object
    input_bytes: bytes
    max_num_headers: int
    max_header_size: int = 35840
    max_authority_set_size: int = 300
    store: CheckpointStore = field(default_factory=CheckpointStore)
    worker_id: int = 0
    n_workers: int = 1
    stats: SchedulerStats = field(default_factory=SchedulerStats)
    device: str = "cuda"

    def __post_init__(self):
        self.inp = HeaderRangeInput.decode(self.input_bytes)
        self.num_leaves = _next_pow2(self.max_num_headers // HEADERS_PER_MAP)
        # the slots a leaf commits over: all 8, or below tree 8 the first
        # max_num_headers (the port's subchain rule)
        self.committed = min(HEADERS_PER_MAP, self.max_num_headers)
        self.job_id = hashlib.sha256(
            b"header_range" + self.input_bytes
            + self.max_num_headers.to_bytes(4, "little")).hexdigest()[:16]

    # -- stage runners ------------------------------------------------------

    def _stage(self, name: str, compute):
        cached = self.store.get(self.job_id, name)
        if cached is not None:
            self.stats.cached += 1
            return cached
        value = compute()
        self.stats.computed += 1
        self.store.put(self.job_id, name, value)
        return value

    def _leaf(self, j: int) -> dict:
        def compute():
            base = self.inp.trusted_block + 1 + j * HEADERS_PER_MAP
            hashes, decoded = fetch_headers(
                self.fetcher, base, HEADERS_PER_MAP, self.inp.target_block,
                self.max_header_size, self.device)
            leaf = map_leaf(j, hashes, decoded, base, self.inp.target_block)
            leaf.state = _merkle8(leaf.state[:self.committed])
            leaf.data = _merkle8(leaf.data[:self.committed])
            return _node_json(leaf)

        return self._stage(f"leaf:{j}", compute)

    def _reduce(self, level: int, k: int, left: dict, right: dict) -> dict:
        def compute():
            return _node_json(reduce_pair(
                _node(left), _node(right), lambda a, b: sha256(a + b)))

        return self._stage(f"reduce:{level}:{k}", compute)

    # -- running the job ----------------------------------------------------

    def run_map_stage(self) -> list[int]:
        """Compute this worker's partition of leaves; returns leaf indices."""
        mine = [j for j in range(self.num_leaves)
                if j % self.n_workers == self.worker_id]
        for j in mine:
            self._leaf(j)
        return mine

    def run(self) -> bytes:
        """Drive the job to completion (with several workers, every worker
        runs `run_map_stage` first and worker 0 finishes with `run`)."""
        nodes = [self._leaf(j) for j in range(self.num_leaves)]
        level = 0
        while len(nodes) > 1:
            nodes = [self._reduce(level, k, nodes[2 * k], nodes[2 * k + 1])
                     for k in range(len(nodes) // 2)]
            level += 1
        root = nodes[0]

        if bytes.fromhex(root["start_parent"]) != self.inp.trusted_header_hash:
            raise SubchainError("start parent != trusted header hash")
        if root["end_block"] != self.inp.target_block:
            raise SubchainError("end block != target block")

        def justify():
            j = self.fetcher.get_justification(
                self.inp.target_block,
                max_authorities=self.max_authority_set_size)
            verify_simple_justification(
                j, self.inp.target_block,
                bytes.fromhex(root["end_header_hash"]),
                self.inp.authority_set_id, self.inp.authority_set_hash)
            return {"ok": True}

        self._stage("justify", justify)

        out = HeaderRangeOutput(
            target_header_hash=bytes.fromhex(root["end_header_hash"]),
            state_root_commitment=bytes.fromhex(root["state_root"]),
            data_root_commitment=bytes.fromhex(root["data_root"]),
        ).encode()
        self._stage("output", lambda: {"output": out.hex()})
        return out


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "gloo") -> None:
    """Join the process group of `num_processes` ranks as rank
    `process_id`, with `backend` ("gloo" or "nccl").  `coordinator` is a
    rendezvous URL (`tcp://host:port`, `file:///path`) or `host:port`.
    No-op when no coordinator is configured (one process)."""
    if coordinator is None:
        return
    import torch.distributed as dist

    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)

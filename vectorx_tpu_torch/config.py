"""Env-driven configuration (C22).

Mirrors the reference's dotenv contract (upstream .env.example:1-24):
AVAIL_URL, AVAIL_CHAIN_ID, REDIS_URL, CONTRACT_ADDRESS, CHAIN_ID, function
ids, LOOP_DELAY_MINS (default 15), UPDATE_DELAY_BLOCKS (default 180),
IS_DUMMY_OPERATOR — plus VECTORX_BACKEND selecting the chain data source
("fixture" for the hermetic synthetic chain, "rpc" for a live Avail node)
and VECTORX_DEVICE naming the torch device the provers run on ("cuda" by
default; the CPU only when asked for).

Registries: `deployments.json` (deployed contracts per chain — reference
deployments.json) and `prover.json` (circuit build/prove commands per
entrypoint — reference succinct.json).

Port of `vectorx_tpu.config`: the same fields and factories over the
port's fetchers and store, plus `device` and `require_device`.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path


def _load_dotenv(path: str = ".env") -> None:
    p = Path(path)
    if not p.exists():
        return
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, v = line.split("=", 1)
        os.environ.setdefault(k.strip(), v.strip())


@dataclass
class Config:
    avail_url: str = ""
    avail_chain_id: str = "fixture"
    redis_url: str = ""
    contract_address: str = "0xvectorx"
    chain_id: int = 11155111
    header_range_function_id: bytes = b"\x01" * 32
    rotate_function_id: bytes = b"\x02" * 32
    loop_delay_mins: int = 15        # vectorx.rs:496 default
    update_delay_blocks: int = 180   # vectorx.rs:510 default
    is_dummy_operator: bool = False  # vectorx.rs IS_DUMMY_OPERATOR
    backend: str = "fixture"         # fixture | rpc
    max_authority_set_size: int = 300
    max_header_size: int = 35840
    header_range_commitment_tree_size: int = 256
    device: str = "cuda"             # VECTORX_DEVICE: cuda | cpu | cuda:N

    @classmethod
    def from_env(cls) -> "Config":
        _load_dotenv()
        e = os.environ

        def fid(name, default):
            raw = e.get(name)
            return bytes.fromhex(raw.removeprefix("0x")) if raw else default

        return cls(
            avail_url=e.get("AVAIL_URL", ""),
            avail_chain_id=e.get("AVAIL_CHAIN_ID", "fixture"),
            redis_url=e.get("REDIS_URL", ""),
            contract_address=e.get("CONTRACT_ADDRESS", "0xvectorx"),
            chain_id=int(e.get("CHAIN_ID", "11155111")),
            header_range_function_id=fid("HEADER_RANGE_FUNCTION_ID",
                                         b"\x01" * 32),
            rotate_function_id=fid("ROTATE_FUNCTION_ID", b"\x02" * 32),
            loop_delay_mins=int(e.get("LOOP_DELAY_MINS", "15")),
            update_delay_blocks=int(e.get("UPDATE_DELAY_BLOCKS", "180")),
            is_dummy_operator=e.get("IS_DUMMY_OPERATOR", "false").lower()
            in ("1", "true"),
            backend=e.get("VECTORX_BACKEND", "fixture"),
            max_authority_set_size=int(e.get("MAX_AUTHORITY_SET_SIZE", "300")),
            max_header_size=int(e.get("MAX_HEADER_SIZE", "35840")),
            header_range_commitment_tree_size=int(
                e.get("HEADER_RANGE_COMMITMENT_TREE_SIZE", "256")),
            device=e.get("VECTORX_DEVICE", "cuda"),
        )


def require_device(config: Config):
    """The torch device the provers run on.  A CUDA device that this
    process cannot see ends the process with a message: nothing falls back
    to the CPU, which runs only when `VECTORX_DEVICE=cpu` asks for it."""
    import torch

    device = torch.device(config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"vectorx: VECTORX_DEVICE={config.device} but "
                         f"torch.cuda.is_available() is false; set "
                         f"VECTORX_DEVICE=cpu to run on the CPU")
    return device


def make_fetcher(config: Config):
    """Chain data source per config: fixture chain or live RPC."""
    if config.backend == "fixture":
        from vectorx_tpu_torch.io.fixtures import FixtureChain

        return FixtureChain(seed=0, num_blocks=256, epoch_length=64)
    if config.backend == "rpc":
        from vectorx_tpu_torch.io.avail_rpc import AvailRpcFetcher

        return AvailRpcFetcher(config.avail_url)
    raise ValueError(f"unknown backend {config.backend}")


def make_store(config: Config):
    from vectorx_tpu_torch.io.store import (JustificationStore, MemoryBackend,
                                      RespBackend)

    if config.redis_url:
        host = config.redis_url.split("//")[-1].split(":")[0]
        port = int(config.redis_url.rsplit(":", 1)[-1].split("/")[0]) \
            if ":" in config.redis_url.split("//")[-1] else 6379
        return JustificationStore(RespBackend(host, port))
    return JustificationStore(MemoryBackend())


def load_deployments(path: str = "deployments.json") -> list[dict]:
    p = Path(path)
    if not p.exists():
        return []
    return json.loads(p.read_text()).get("deployments", [])

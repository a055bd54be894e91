"""Genesis tool (C17).

Mirrors `bin/genesis.rs:24-50`: compute the contract-initialization values
for a given block (defaults to chain head): GENESIS_HEIGHT, GENESIS_HEADER,
GENESIS_AUTHORITY_SET_ID, GENESIS_AUTHORITY_SET_HASH.

Port of `vectorx_tpu.services.genesis` (host code).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class GenesisState:
    height: int
    header_hash: bytes
    authority_set_id: int
    authority_set_hash: bytes

    def display(self) -> str:
        return (f"GENESIS_HEIGHT={self.height}\n"
                f"GENESIS_HEADER=0x{self.header_hash.hex()}\n"
                f"GENESIS_AUTHORITY_SET_ID={self.authority_set_id}\n"
                f"GENESIS_AUTHORITY_SET_HASH=0x{self.authority_set_hash.hex()}")


def compute_genesis(fetcher, block_number: int | None = None) -> GenesisState:
    if block_number is None:
        block_number = fetcher.get_head().block_number
    # The authority set id/hash validating the block AFTER block_number
    # (genesis.rs uses get_authority_set_id(block) + compute_authority_set_hash)
    return GenesisState(
        height=block_number,
        header_hash=fetcher.get_block_hash(block_number),
        authority_set_id=fetcher.get_authority_set_id(block_number),
        authority_set_hash=fetcher.compute_authority_set_hash(block_number),
    )

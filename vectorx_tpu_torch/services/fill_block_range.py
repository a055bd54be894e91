"""Guardian recovery: fill_block_range (C18).

Mirrors `bin/fill_block_range.rs:48-165`: for a stalled contract, compute
header-range commitments off-circuit for each tree-size stride of
[start, end], and produce the `updateBlockRangeData` guardian call
(optionally applying it to the contract model directly).

Port of `vectorx_tpu.services.fill_block_range` (host code).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BlockRangeFill:
    start_blocks: list
    end_blocks: list
    header_hashes: list
    data_commitments: list
    state_commitments: list
    end_authority_set_id: int
    end_authority_set_hash: bytes


def compute_fill(fetcher, start_block: int, end_block: int,
                 tree_size: int) -> BlockRangeFill:
    starts, ends, hashes, datas, states = [], [], [], [], []
    cur = start_block
    while cur < end_block:
        step_end = min(cur + tree_size, end_block)
        state_c, data_c = fetcher.get_merkle_root_commitments(
            tree_size, cur, step_end)
        starts.append(cur)
        ends.append(step_end)
        hashes.append(fetcher.get_block_hash(step_end))
        datas.append(data_c)
        states.append(state_c)
        cur = step_end
    return BlockRangeFill(
        start_blocks=starts, end_blocks=ends, header_hashes=hashes,
        data_commitments=datas, state_commitments=states,
        end_authority_set_id=fetcher.get_authority_set_id(end_block),
        end_authority_set_hash=fetcher.compute_authority_set_hash(end_block),
    )


def apply_fill(contract, fill: BlockRangeFill) -> None:
    contract.update_block_range_data(
        fill.start_blocks, fill.end_blocks, fill.header_hashes,
        fill.data_commitments, fill.state_commitments,
        fill.end_authority_set_id, fill.end_authority_set_hash)

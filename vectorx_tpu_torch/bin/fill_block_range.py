"""Guardian recovery CLI (reference bin/fill_block_range.rs:27-165).

Computes per-stride commitments for [start, end] and prints the
updateBlockRangeData calldata fields as JSON.
"""

from __future__ import annotations

import argparse
import json

from vectorx_tpu_torch.config import Config, make_fetcher
from vectorx_tpu_torch.services import compute_fill


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--end", type=int, required=True)
    ap.add_argument("--tree-size", type=int, default=None)
    args = ap.parse_args()
    config = Config.from_env()
    fetcher = make_fetcher(config)
    tree = args.tree_size or config.header_range_commitment_tree_size
    fill = compute_fill(fetcher, args.start, args.end, tree)
    print(json.dumps({
        "startBlocks": fill.start_blocks,
        "endBlocks": fill.end_blocks,
        "headerHashes": ["0x" + h.hex() for h in fill.header_hashes],
        "dataCommitments": ["0x" + c.hex() for c in fill.data_commitments],
        "stateCommitments": ["0x" + c.hex() for c in fill.state_commitments],
        "endAuthoritySetId": fill.end_authority_set_id,
        "endAuthoritySetHash": "0x" + fill.end_authority_set_hash.hex(),
    }, indent=2))


if __name__ == "__main__":
    main()

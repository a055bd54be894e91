"""Genesis tool CLI (reference bin/genesis.rs:24-50)."""

from __future__ import annotations

import argparse

from vectorx_tpu_torch.config import Config, make_fetcher
from vectorx_tpu_torch.services import compute_genesis


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, default=None,
                    help="block number (default: finalized head)")
    args = ap.parse_args()
    config = Config.from_env()
    fetcher = make_fetcher(config)
    print(compute_genesis(fetcher, args.block).display())


if __name__ == "__main__":
    main()

"""Justification indexer CLI (reference bin/indexer.rs)."""

from __future__ import annotations

import argparse
import logging
import time

from vectorx_tpu_torch.config import Config, make_fetcher, make_store
from vectorx_tpu_torch.services import JustificationIndexer


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--once", action="store_true",
                    help="index up to the current head and exit")
    ap.add_argument("--poll-seconds", type=float, default=5.0)
    args = ap.parse_args()

    config = Config.from_env()
    fetcher = make_fetcher(config)
    store = make_store(config)
    indexer = JustificationIndexer(fetcher, store,
                                   chain_id=config.avail_chain_id)
    while True:
        n = indexer.run_follow()
        logging.info("indexed %d new justifications (head=%d)", n,
                     indexer.last_processed)
        if args.once:
            break
        time.sleep(args.poll_seconds)


if __name__ == "__main__":
    main()

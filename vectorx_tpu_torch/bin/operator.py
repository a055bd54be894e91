"""Operator service CLI (reference bin/vectorx.rs).

``python -m vectorx_tpu_torch.bin.operator [--iterations N]
[--genesis-block B] [--no-sleep]``

There is no deployed gateway to post to, so the operator drives an
in-process contract model whose gateway provers are this repo's circuits,
looping exactly like vectorx.rs:461-491.
The provers run on `VECTORX_DEVICE` (a dummy operator needs no device).
"""

from __future__ import annotations

import argparse
import logging

from vectorx_tpu_torch.config import Config, make_fetcher, require_device
from vectorx_tpu_torch.services import (OperatorConfig, VectorXContract,
                                  VectorXOperator, compute_genesis,
                                  make_gateway)


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=None,
                    help="loop iterations (default: forever)")
    ap.add_argument("--genesis-block", type=int, default=0)
    ap.add_argument("--no-sleep", action="store_true")
    args = ap.parse_args()

    config = Config.from_env()
    device = None if config.is_dummy_operator else require_device(config)
    fetcher = make_fetcher(config)
    gateway = make_gateway(
        fetcher,
        max_authority_set_size=config.max_authority_set_size,
        max_num_headers=config.header_range_commitment_tree_size,
        max_header_size=config.max_header_size,
        header_range_function_id=config.header_range_function_id,
        rotate_function_id=config.rotate_function_id,
        dummy=config.is_dummy_operator,
        device=device)
    g = compute_genesis(fetcher, args.genesis_block or None)
    contract = VectorXContract(
        gateway, g.height, g.header_hash, g.authority_set_id,
        g.authority_set_hash,
        header_range_function_id=config.header_range_function_id,
        rotate_function_id=config.rotate_function_id,
        header_range_commitment_tree_size=config.header_range_commitment_tree_size)
    operator = VectorXOperator(contract, fetcher, OperatorConfig(
        loop_delay_mins=config.loop_delay_mins,
        update_delay_blocks=config.update_delay_blocks,
        is_dummy_operator=config.is_dummy_operator))

    done = 0
    while args.iterations is None or done < args.iterations:
        operator.run_once()
        while gateway.pending:
            gateway.fulfill_next()
        logging.info("contract head=%d latest_set=%d",
                     contract.latest_block, contract.latest_authority_set_id)
        done += 1
        if args.iterations is not None and done >= args.iterations:
            break
        if not args.no_sleep:
            import time

            time.sleep(60 * config.loop_delay_mins)


if __name__ == "__main__":
    main()

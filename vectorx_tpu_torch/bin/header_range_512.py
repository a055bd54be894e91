"""Circuit entrypoint: header_range with a 512-header commitment tree
(reference bin/header_range_512.rs:14-17), on `VECTORX_DEVICE`."""

import functools

from vectorx_tpu_torch.bin._entrypoint import run_entrypoint
from vectorx_tpu_torch.circuits import HeaderRangeCircuit
from vectorx_tpu_torch.config import require_device


def _make(config):
    circuit = HeaderRangeCircuit(
        max_authority_set_size=config.max_authority_set_size,
        max_header_size=config.max_header_size,
        max_num_headers=512)
    return functools.partial(circuit.run, device=require_device(config))


if __name__ == "__main__":
    run_entrypoint("header_range_512", _make, "req_bytes")

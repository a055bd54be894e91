"""Circuit entrypoint: rotate (reference bin/rotate.rs:13-15).  The rotate
checks are host work (signatures, the epoch-end header's bytes)."""

from vectorx_tpu_torch.bin._entrypoint import run_entrypoint
from vectorx_tpu_torch.circuits import RotateCircuit


def _make(config):
    return RotateCircuit(
        max_authority_set_size=config.max_authority_set_size,
        max_header_size=config.max_header_size).run


if __name__ == "__main__":
    run_entrypoint("rotate", _make, "req_bytes")

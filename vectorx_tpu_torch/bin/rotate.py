"""Circuit entrypoint: rotate (reference bin/rotate.rs:13-15).  The rotate
checks are host work (signatures, the epoch-end header's bytes); `prove-zk`
proves the succinct rotate on `VECTORX_DEVICE`."""

from vectorx_tpu_torch.bin._entrypoint import run_entrypoint
from vectorx_tpu_torch.circuits import RotateCircuit
from vectorx_tpu_torch.circuits.succinct_rotate import prove_rotate_succinct
from vectorx_tpu_torch.config import require_device


def _make(config):
    return RotateCircuit(
        max_authority_set_size=config.max_authority_set_size,
        max_header_size=config.max_header_size).run


def _succinct(fetcher, input_bytes, config):
    return prove_rotate_succinct(
        fetcher, input_bytes, max_authorities=config.max_authority_set_size,
        device=require_device(config))


if __name__ == "__main__":
    run_entrypoint("rotate", _make, "req_bytes", succinct_prover=_succinct)

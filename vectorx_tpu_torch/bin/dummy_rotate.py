"""Dummy entrypoint (reference bin/dummy_rotate.rs)."""

from vectorx_tpu_torch.bin._entrypoint import run_entrypoint
from vectorx_tpu_torch.circuits import DummyRotate


def _make(config):
    return DummyRotate().run


if __name__ == "__main__":
    run_entrypoint("dummy_rotate", _make, "req_bytes")

"""Dummy entrypoint (reference bin/dummy_header_range_512.rs)."""

from vectorx_tpu_torch.bin._entrypoint import run_entrypoint
from vectorx_tpu_torch.circuits import DummyHeaderRange


def _make(config):
    return DummyHeaderRange(512).run


if __name__ == "__main__":
    run_entrypoint("dummy_header_range_512", _make, "req_bytes")

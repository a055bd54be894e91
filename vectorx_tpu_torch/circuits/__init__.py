from vectorx_tpu_torch.circuits.dummy import DummyHeaderRange, DummyRotate
from vectorx_tpu_torch.circuits.header_range import (HeaderRangeCircuit,
                                                     RotateCircuit)
from vectorx_tpu_torch.circuits.justification import (
    JustificationError, verify_simple_justification)
from vectorx_tpu_torch.circuits.rotate import RotateError
from vectorx_tpu_torch.circuits.subchain import (SubchainError,
                                                 SubchainOutput,
                                                 verify_subchain)

__all__ = [
    "DummyHeaderRange", "DummyRotate", "HeaderRangeCircuit", "RotateCircuit",
    "JustificationError", "verify_simple_justification", "RotateError",
    "SubchainError", "SubchainOutput", "verify_subchain",
]

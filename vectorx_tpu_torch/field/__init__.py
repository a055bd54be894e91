from vectorx_tpu_torch.field import goldilocks, reference
from vectorx_tpu_torch.field.goldilocks import P

__all__ = ["goldilocks", "reference", "P"]

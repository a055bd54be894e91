from vectorx_tpu_torch.ntt.ntt import (
    coset_intt,
    coset_ntt,
    intt,
    lde,
    ntt,
    power_table,
)

__all__ = ["ntt", "intt", "coset_ntt", "coset_intt", "lde", "power_table"]

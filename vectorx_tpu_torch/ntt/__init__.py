from vectorx_tpu_torch.ntt.ntt import (
    coset_intt,
    coset_lde,
    coset_ntt,
    intt,
    lde,
    ntt,
    power_table,
)

__all__ = ["ntt", "intt", "coset_ntt", "coset_intt", "coset_lde", "lde",
           "power_table"]

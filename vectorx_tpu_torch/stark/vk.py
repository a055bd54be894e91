"""Verification keys: a content-addressed cache of constants caps.

Port of the content path of `vectorx_tpu.stark.vk.constants_cap`.  The
verifier's trust anchor for an AIR's preprocessed (constant) columns is the
Merkle cap of their LDE commitment; deriving it costs a full iNTT + coset
NTT + Merkle build, so it is memoized in memory, keyed by a hash of the
constant columns themselves and the commitment parameters — a hit returns
exactly what re-derivation would.  The AIR-token fast path and the disk
layer are not ported (the token path comes with the machine AIR).
"""

from __future__ import annotations

import hashlib
import threading

_MEM: dict = {}
_LOCK = threading.Lock()


def cache_key(consts, config) -> str:
    h = hashlib.sha256()
    h.update(f"{consts.shape}:{config.fri.rate_bits}:"
             f"{config.fri.cap_height}:".encode())
    h.update(consts.tobytes())
    return h.hexdigest()


def constants_cap(air, config, *, device) -> list | None:
    """The AIR's verification key (cap of the preprocessed-columns
    commitment, derived on `device` once per content key), or None when
    the AIR has no constant columns."""
    consts = air.constant_columns()
    if consts.shape[0] == 0:
        return None
    key = cache_key(consts, config)
    with _LOCK:
        cap = _MEM.get(key)
    if cap is None:
        from vectorx_tpu_torch.stark.prover import preprocess

        cap = preprocess(air, config, consts, device=device)[0].cap_ints()
        with _LOCK:
            _MEM[key] = cap
    return cap


"""Verification keys: a cache of constants caps.

Port of `vectorx_tpu.stark.vk`.  The verifier's trust anchor for an AIR's
preprocessed (constant) columns is the Merkle cap of their LDE commitment;
deriving it costs a full iNTT + coset NTT + Merkle build, so it is
memoized, keyed by a hash of the constant columns themselves and the
commitment parameters — a hit returns exactly what re-derivation would.

For `bind="public"` hash AIRs the constant columns are a function of the
statement's shape alone (block counts, message lengths), so two statements
of one shape share one key and one cap: the deployment's verification key.
A `bind="consts"` statement's columns hold its messages and digests, so its
key changes with them, as before.

Token fast path: an AIR may expose `vk_token()`, a compact value that
uniquely determines its constant columns (MachineAir returns its program's
content-address key from `recursion.progcache`, salted with the machine
layout version).  A token hit returns the cap without materializing the
columns.  The prover seeds the token entry with the cap it derives
(`seed_token`).

Disk layer: the `torch/` subdirectory of VECTORX_VK_CACHE (default
~/.cache/vectorx/vk; "0" disables it), as small JSON cap lists.  The port
never reads the JAX package's entries beside it.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

from vectorx_tpu_torch import tracing

_MEM: dict = {}
_LOCK = threading.Lock()


def disk_dir() -> str | None:
    """The port's cache directory (shared with `recursion.progcache`), or
    None when the disk layer is off or cannot be created."""
    d = os.environ.get("VECTORX_VK_CACHE")
    if d == "0":
        return None
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache", "vectorx", "vk")
    d = os.path.join(d, "torch")
    try:
        os.makedirs(d, exist_ok=True)
        return d
    except OSError:
        return None


def cache_key(consts, config) -> str:
    h = hashlib.sha256()
    h.update(f"{consts.shape}:{config.fri.rate_bits}:"
             f"{config.fri.cap_height}:".encode())
    h.update(consts.tobytes())
    return h.hexdigest()


def token_key(tok, config) -> str:
    """Key for an AIR-provided derivation token (see `constants_cap`)."""
    h = hashlib.sha256()
    h.update(f"tok:{tok!r}:{config.fri.rate_bits}:"
             f"{config.fri.cap_height}".encode())
    return h.hexdigest()


def _lookup(key: str):
    with _LOCK:
        cap = _MEM.get(key)
    if cap is not None:
        return cap
    d = disk_dir()
    if d is None:
        return None
    try:
        with open(os.path.join(d, "cap_" + key + ".json")) as f:
            cap = json.load(f)
    except (OSError, ValueError):
        return None
    with _LOCK:
        _MEM[key] = cap
    return cap


def _store(key: str, cap) -> None:
    with _LOCK:
        _MEM[key] = cap
    d = disk_dir()
    if d is None:
        return
    path = os.path.join(d, "cap_" + key + ".json")
    try:
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(cap, f)
        os.replace(tmp, path)
    except OSError:
        pass


def constants_cap(air, config, *, device) -> list | None:
    """The AIR's verification key (cap of the preprocessed-columns
    commitment, derived on `device` on a miss), or None when the AIR has
    no constant columns.  A token hit never builds the columns."""
    tok = getattr(air, "vk_token", None)
    tok = tok() if callable(tok) else None
    tkey = token_key(tok, config) if tok is not None else None
    if tkey is not None:
        cap = _lookup(tkey)
        if cap is not None:
            return cap
    consts = air.constant_columns()
    if consts.shape[0] == 0:
        return None
    key = cache_key(consts, config)
    cap = _lookup(key)
    if cap is None:
        from vectorx_tpu_torch.stark.prover import preprocess

        with tracing.span("vk.derive", columns=consts.shape[0],
                          rows=consts.shape[1]):
            cap = preprocess(air, config, consts, device=device)[0].cap_ints()
        _store(key, cap)
    if tkey is not None:
        _store(tkey, cap)
    return cap


def seed_token(air, config, cap) -> None:
    """Store `cap`, the prover's own derivation of a token-carrying AIR's
    constants cap, under its token key, so that the verifier of the proof
    just made is served from the token path."""
    tok = getattr(air, "vk_token", None)
    tok = tok() if callable(tok) else None
    if tok is not None:
        _store(token_key(tok, config), cap)


def clear_memory_cache() -> None:
    with _LOCK:
        _MEM.clear()

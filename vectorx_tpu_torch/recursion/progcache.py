"""Content-addressed cache of statement-mode machine programs.

Port of `vectorx_tpu.recursion.progcache`.  A verifier re-derives the
verifier-VM program from the claimed statement (aggregate.py) — a pure
host-Python tape walk.  The program is a pure function of the statement,
the FRI config and the machine layout, so it is content-addressed here: a
hit returns exactly what re-derivation would, and the prove side seeds the
cache with its own (witness-stripped) program.

Soundness: the key hashes the verifier's own derivation inputs, so a hit
cannot accept anything the rebuild would not.  Stripping the witness is
sound because the tape structure is witness-independent by construction
(shadow.py builds identical tapes with or without a proof).

Every key is salted with `machine.MACHINE_FORMAT_VERSION`.  The disk layer
is `stark.vk.disk_dir()` (the port's own subdirectory of
VECTORX_VK_CACHE, "0" disables it); an entry is served only if it
unpickles to a (Program, meta) pair.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
from dataclasses import replace

from vectorx_tpu_torch.recursion import machine
from vectorx_tpu_torch.recursion.machine import Program
from vectorx_tpu_torch.stark.vk import disk_dir

_MEM: dict = {}
_LOCK = threading.Lock()


def digest_key(*parts) -> str:
    """Stable hex key from statement parts (bytes/str/int/list nestings;
    order-sensitive), salted with the machine layout version."""
    h = hashlib.sha256()

    def feed(p):
        if isinstance(p, bytes):
            h.update(b"b" + len(p).to_bytes(8, "little") + p)
        elif isinstance(p, str):
            feed(p.encode())
        elif isinstance(p, bool):
            h.update(b"o" + bytes([p]))
        elif isinstance(p, int):
            h.update(b"i" + repr(p).encode())
        elif p is None:
            h.update(b"n")
        elif isinstance(p, (list, tuple)):
            h.update(b"l" + len(p).to_bytes(8, "little"))
            for x in p:
                feed(x)
        else:
            raise TypeError(f"unhashable statement part: {type(p)}")

    feed(["machine", machine.MACHINE_FORMAT_VERSION, list(parts)])
    return h.hexdigest()


def strip_witness(prog: Program) -> Program:
    """The statement-mode view of a witness-mode program (drop the value
    assignment; structure is witness-independent, see module docstring)."""
    return replace(prog, values=None, witness=False)


def _path(d: str, key: str) -> str:
    return os.path.join(d, "mprog_" + key + ".pkl")


def get(key: str):
    """Cached (program, meta) for `key`, or None.  The returned program
    carries `_stmt_key = key` — its own content address — which
    stark/vk.py uses as a VK-cache token (MachineAir.vk_token)."""
    with _LOCK:
        hit = _MEM.get(key)
    if hit is None:
        d = disk_dir()
        if d is None:
            return None
        try:
            with open(_path(d, key), "rb") as f:
                hit = pickle.load(f)
        except (OSError, pickle.PickleError, EOFError, AttributeError,
                TypeError, ValueError, ImportError):
            return None
        if not (isinstance(hit, tuple) and len(hit) == 2
                and isinstance(hit[0], Program)):
            return None
        with _LOCK:
            _MEM[key] = hit
    hit[0]._stmt_key = key
    return hit


def put(key: str, prog: Program, meta=None) -> None:
    """Store the statement-mode view of `prog` under `key`.  The caller's
    program gets the same token: its constant columns are
    witness-independent, so a prove-side MachineAir over it hits the same
    VK-cache entry as the verifier's."""
    prog._stmt_key = key
    # a fresh dataclass copy drops ad-hoc attributes (the constant-column
    # memo) from the pickle and from the shared in-memory entry
    prog = strip_witness(prog) if prog.witness else replace(prog)
    prog._stmt_key = key
    entry = (prog, meta)
    with _LOCK:
        _MEM[key] = entry
    d = disk_dir()
    if d is None:
        return
    path = _path(d, key)
    try:
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(entry, f)
        os.replace(tmp, path)
    except (OSError, pickle.PickleError):
        pass


def clear_memory_cache() -> None:
    with _LOCK:
        _MEM.clear()

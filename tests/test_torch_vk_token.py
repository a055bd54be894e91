"""The port's verification-key token path and its disk caches
(`vectorx_tpu_torch.stark.vk`, `vectorx_tpu_torch.recursion.progcache`),
with the three places where the port departs from the reference's caches:

* the token and the program keys carry `MACHINE_FORMAT_VERSION`, so an
  entry written under another machine layout is never served;
* `aggregate_prove` keys the caller's own program, so the prove-side
  MachineAir carries the VK token;
* a progcache disk entry is served (and kept in memory) only if it
  unpickles to a (Program, meta) pair;
* the port keeps its disk entries in a subdirectory of its own, so a JAX
  package entry in the same cache directory is never read.

Every test runs with both caches in a temporary directory.
"""

import pickle
from dataclasses import replace

import pytest
import torch

from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.fri.fri import FriConfig
from vectorx_tpu_torch.hash import poseidon_py
from vectorx_tpu_torch.recursion import aggregate, machine, progcache
from vectorx_tpu_torch.recursion.machine import MachineAir, compile_tape
from vectorx_tpu_torch.recursion.ssa import Builder
from vectorx_tpu_torch.stark import FibonacciAir, StarkConfig, prove, verify
from vectorx_tpu_torch.stark import vk

torch.set_num_threads(1)

# the config of tests/test_vk_token.py
CFG = StarkConfig(fri=FriConfig(rate_bits=3, cap_height=1, num_queries=2,
                                final_poly_len=2, pow_bits=1))


@pytest.fixture()
def isolated_caches(tmp_path, monkeypatch):
    monkeypatch.setenv("VECTORX_VK_CACHE", str(tmp_path))
    vk.clear_memory_cache()
    progcache.clear_memory_cache()
    yield tmp_path
    vk.clear_memory_cache()
    progcache.clear_memory_cache()


def _toy_tape(witness: bool, x=5, y=7) -> Builder:
    """`tests/test_recursion_machine.py::_toy_tape` on the port: every op
    kind (fresh, fma, multi-term affine, assert, duplex, bitdec, public)."""
    b = Builder(witness=witness)
    xv = b.fresh((x, 0) if witness else None, "x")
    yv = b.fresh((y, 0) if witness else None, "y")
    p = b.public(5, 0)
    b.assert_eq(p, xv, where="x_is_public")
    z = b.mul(xv, yv)
    w = b.add(z, (3, 0))
    b.assert_zero(b.sub(w, ((x * y + 3) % P, 0)), where="w")
    d1, outs = b.duplex([xv, yv], keep_state=False, prev=-1)
    h0 = poseidon_py.permute([5, 7] + [0] * 10)[0]
    b.assert_eq(outs[0], (h0, 0), where="hash")
    b.duplex([w], keep_state=True, prev=d1)
    bits = b.bitdec(yv, 8, canonical=False)
    b.assert_eq(b.add(bits[0], bits[1]), (2, 0), where="bits")
    return b


def _keyed_program():
    prog = compile_tape(_toy_tape(witness=True))
    key = progcache.digest_key("vk-token-test", prog.n_rows)
    progcache.put(key, prog)   # sets _stmt_key on the caller's program
    return prog, key


def test_token_cap_matches_content_cap(isolated_caches):
    prog, _ = _keyed_program()
    air = MachineAir(prog)
    assert air.vk_token() == ("mprog", machine.MACHINE_FORMAT_VERSION,
                              prog._stmt_key, air.log_n)
    cap_via_token_seed = vk.constants_cap(air, CFG, device="cpu")
    # an unkeyed copy of the same program goes through the content key
    bare = replace(prog)
    air2 = MachineAir(bare)
    assert air2.vk_token() is None
    assert vk.constants_cap(air2, CFG, device="cpu") == cap_via_token_seed


def test_warm_verify_never_builds_constant_columns(isolated_caches):
    prog, key = _keyed_program()
    air = MachineAir(prog)
    proof = prove(air, air.build_trace(), CFG, device="cpu")  # seeds token

    def boom():
        raise AssertionError("constant_columns materialized on warm verify")

    for drop_memory in (False, True):
        if drop_memory:      # the disk layer alone serves both entries
            vk.clear_memory_cache()
            progcache.clear_memory_cache()
        cold_air = MachineAir(progcache.get(key)[0])
        cold_air.constant_columns = boom
        assert cold_air.num_constants() == machine.N_CONSTS
        assert verify(cold_air, proof, CFG, device="cpu")


def test_stale_format_version_not_served(isolated_caches, monkeypatch):
    prog, _ = _keyed_program()
    air = MachineAir(prog)
    true_cap = vk.constants_cap(air, CFG, device="cpu")
    vk.clear_memory_cache()
    for f in isolated_caches.joinpath("torch").glob("cap_*.json"):
        f.unlink()
    # a cap stored under another layout version, for the same program key
    monkeypatch.setattr(machine, "MACHINE_FORMAT_VERSION", 0)
    stale_token = air.vk_token()
    vk._store(vk.token_key(stale_token, CFG), [[1, 2, 3, 4], [5, 6, 7, 8]])
    stale_key = progcache.digest_key("vk-token-test", prog.n_rows)
    monkeypatch.undo()
    assert air.vk_token() != stale_token
    assert vk.constants_cap(air, CFG, device="cpu") == true_cap
    assert progcache.digest_key("vk-token-test", prog.n_rows) != stale_key


@pytest.mark.parametrize("payload", [b"not a pickle", pickle.dumps({"x": 1}),
                                     pickle.dumps(("program", None))],
                         ids=["garbage", "wrong_type", "wrong_program"])
def test_corrupt_progcache_entry_neither_served_nor_cached(isolated_caches,
                                                           payload):
    key = progcache.digest_key("corrupt", 1)
    isolated_caches.joinpath("torch").mkdir(exist_ok=True)
    isolated_caches.joinpath("torch", f"mprog_{key}.pkl").write_bytes(payload)
    assert progcache.get(key) is None
    assert key not in progcache._MEM


def test_jax_written_entries_never_read(isolated_caches):
    """The reference's entries (`mprog_<key>.pkl`, `<key>.json`) in the
    same VECTORX_VK_CACHE directory are outside the port's subdirectory."""
    from test_recursion_machine import _toy_tape as jax_toy_tape
    from vectorx_tpu.recursion import progcache as jprogcache
    from vectorx_tpu.recursion.machine import compile_tape as jcompile
    from vectorx_tpu.stark import vk as jvk

    key = progcache.digest_key("shared", 1)
    jprogcache.put(key, jcompile(jax_toy_tape(witness=False)))
    jvk._store(key, [[1, 2, 3, 4]])
    jprogcache.clear_memory_cache()
    jvk.clear_memory_cache()
    assert isolated_caches.joinpath(f"mprog_{key}.pkl").exists()
    assert isolated_caches.joinpath(f"{key}.json").exists()
    assert progcache.get(key) is None
    assert vk._lookup(key) is None
    assert vk.disk_dir() == str(isolated_caches.joinpath("torch"))


def test_aggregate_prove_keys_the_callers_program(isolated_caches,
                                                  monkeypatch):
    """The prove-side MachineAir carries the statement key as its VK token
    (the reference puts the key on a stripped copy only).  The machine
    proof itself is stubbed out: this checks the keying alone."""
    child = FibonacciAir(log_n=3)
    child_proof = prove(child, child.build_trace(), CFG, device="cpu")
    monkeypatch.setattr(aggregate, "prove",
                        lambda air, trace, config, *, device: "proof")
    agg = aggregate.aggregate_prove([child], [child_proof], CFG,
                                    device="cpu")
    key = aggregate._stmt_key([child], CFG)
    assert agg.proof == "proof"
    assert agg.machine_air.vk_token() == (
        "mprog", machine.MACHINE_FORMAT_VERSION, key, agg.machine_air.log_n)
    cached = progcache.get(key)[0]
    assert cached is not agg.machine_air.program and not cached.witness
    assert MachineAir(cached).vk_token() == agg.machine_air.vk_token()

"""Succinct composition: child proofs wired together INSIDE the machine,
so intermediate values never reach the final verifier.

Port of `vectorx_tpu.recursion.succinct`.  First instance: a SHA-256
Merkle tree (the reference circuits' data/state-root commitment shape,
upstream circuits/input/mod.rs:464-489 and
subchain_verification.rs:212-274) proven as ONE machine proof whose public
surface is ONLY the leaves and the root — every interior digest is a
fresh internal tape value, bound by the level-childrens' transcripts on
both its producing and consuming side.  Second instance: a Blake2b hash
chain whose verifier sees only (trusted_hash, final_hash).  Every proof
and verification runs on the `device` the caller names.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from vectorx_tpu_torch.recursion import progcache
from vectorx_tpu_torch.recursion.machine import MachineAir, compile_tape
from vectorx_tpu_torch.recursion.shadow import verifier_tape
from vectorx_tpu_torch.recursion.ssa import Affine, Builder
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir, blake2b_pad
from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.sha256_air import Sha256Air
from vectorx_tpu_torch.stark.verifier import verify

# padding block of a 64-byte message: 0x80, zeros, 512-bit length
_PAD64_WORDS = [0x80000000] + [0] * 14 + [512]


def _words(digest: bytes) -> list[int]:
    return [int.from_bytes(digest[4 * i:4 * i + 4], "big") for i in range(8)]


@dataclass
class ShaTreeProof:
    proof: object          # ONE machine StarkProof
    n_leaves: int


def _tree_levels(leaves: list[bytes]) -> list[list[bytes]]:
    levels = []
    cur = list(leaves)
    while len(cur) > 1:
        cur = [hashlib.sha256(cur[2 * i] + cur[2 * i + 1]).digest()
               for i in range(len(cur) // 2)]
        levels.append(cur)
    return levels


def _tree_tape(b: Builder, n_leaves: int, leaves, root, child_config,
               proofs, levels, *, device):
    """Shared tape: leaves + root are machine publics; interior digests
    are internal fresh values.  `leaves`/`root` are bytes (known to both
    sides — they are the statement); `levels`/`proofs` are prover-side
    (None for the verifier)."""
    assert n_leaves & (n_leaves - 1) == 0 and n_leaves >= 2
    pub_i = 0
    cur = []
    for leaf in leaves:
        hs = []
        for w in _words(leaf):
            hs.append(b.public(w, pub_i))
            pub_i += 1
        cur.append(hs)
    root_h = []
    for w in _words(root):
        root_h.append(b.public(w, pub_i))
        pub_i += 1

    lvl = 0
    while len(cur) > 1:
        n_nodes = len(cur) // 2
        air = Sha256Air.public_shape([2] * n_nodes)
        ph = [Affine(const=(n_nodes, 0))]
        outs = []
        for i in range(n_nodes):
            ph += cur[2 * i] + cur[2 * i + 1]           # block 1: the pair
            ph += [Affine(const=(w, 0)) for w in _PAD64_WORDS]
            if n_nodes == 1:
                dig = root_h                             # top binds the root
            else:
                vals = _words(levels[lvl][i]) if levels else [None] * 8
                dig = [b.fresh((v, 0) if v is not None else None,
                               f"t{lvl}.{i}.{j}") for j, v in enumerate(vals)]
            ph += dig
            outs.append(dig)
        verifier_tape(b, air, child_config,
                      proof=proofs[lvl] if proofs else None,
                      public_handles=ph, device=device)
        cur = outs
        lvl += 1


def _tree_key(leaves, root, cfg) -> str:
    f = cfg.fri
    return progcache.digest_key("sha_tree", f.rate_bits, f.cap_height,
                                f.num_queries, f.final_poly_len, f.pow_bits,
                                list(leaves), root)


def _chain_key(header_lens, trusted, final, cfg) -> str:
    f = cfg.fri
    return progcache.digest_key("hash_chain", f.rate_bits, f.cap_height,
                                f.num_queries, f.final_poly_len, f.pow_bits,
                                list(header_lens), trusted, final)


def prove_sha_tree(leaves: list[bytes],
                   child_config: StarkConfig,
                   outer_config: StarkConfig | None = None, *,
                   device) -> ShaTreeProof:
    """One machine proof that the SHA-256 Merkle tree over `leaves` has
    root `sha_tree_root(leaves)` — interior digests stay internal."""
    outer_config = outer_config or child_config
    levels = _tree_levels(leaves)
    root = levels[-1][0]
    # one public-bind child per level, all nodes of the level in one trace
    proofs = []
    cur = list(leaves)
    for lvl_digests in levels:
        msgs = [cur[2 * i] + cur[2 * i + 1] for i in range(len(cur) // 2)]
        air = Sha256Air(msgs, bind="public")
        assert air.digest_bytes_list() == lvl_digests
        proofs.append(prove(air, air.build_trace(), child_config,
                            device=device))
        cur = lvl_digests
    bld = Builder(witness=True)
    _tree_tape(bld, len(leaves), leaves, root, child_config, proofs, levels,
               device=device)
    prog = compile_tape(bld)
    mair = MachineAir(prog)
    out = ShaTreeProof(proof=prove(mair, mair.build_trace(), outer_config,
                                   device=device),
                       n_leaves=len(leaves))
    progcache.put(_tree_key(leaves, root, child_config), prog)
    return out


def verify_sha_tree(leaves: list[bytes], root: bytes, tree: ShaTreeProof,
                    child_config: StarkConfig,
                    outer_config: StarkConfig | None = None, *,
                    device) -> bool:
    """Check ONE machine proof against (leaves, root).  Interior digests
    are never seen — only their existence is proven.  Any failure is a
    rejection."""
    outer_config = outer_config or child_config
    if tree.n_leaves != len(leaves):
        return False
    try:
        def _rebuild():
            bld = Builder(witness=False)
            _tree_tape(bld, len(leaves), leaves, root, child_config,
                       None, None, device=device)
            return compile_tape(bld)

        mair = MachineAir(progcache.cached_program(
            _tree_key(leaves, root, child_config), _rebuild))
        return verify(mair, tree.proof, outer_config, device=device)
    except Exception:
        return False


def sha_tree_root(leaves: list[bytes]) -> bytes:
    return _tree_levels(leaves)[-1][0]


# ---------------------------------------------------------------------------
# Succinct Blake2b hash chain: the core of header_range succinctness.
# Verifier sees ONLY (trusted_hash, final_hash); the header bytes and all
# intermediate hashes are witness values inside ONE machine proof.
# Hash-linking needs no data-dependent decode: parent_hash is bytes 0..32
# of the encoded header (upstream circuits/builder/decoder.rs:104 —
# static offset), i.e. message words M0..M3 of section 0.
# ---------------------------------------------------------------------------

def _limbs32(data: bytes) -> list[int]:
    """Little-endian u64 words as (lo, hi) u32 limb pairs, flattened."""
    out = []
    for w in range(0, len(data), 8):
        v = int.from_bytes(data[w:w + 8], "little")
        out += [v & 0xFFFFFFFF, v >> 32]
    return out


@dataclass
class HashChainProof:
    proof: object          # ONE machine StarkProof
    header_lens: list      # statement: the encoded header sizes


def _chain_tape(b: Builder, header_lens, trusted: bytes, final: bytes,
                child_config, proof, headers, *, device):
    """Machine publics: 8 trusted-hash limbs + 8 final-hash limbs.
    Everything else — header bytes, intermediate hashes — is witness."""
    trusted_h = [b.public(v, i) for i, v in enumerate(_limbs32(trusted))]
    final_h = [b.public(v, 8 + i) for i, v in enumerate(_limbs32(final))]

    air = Blake2bAir.public_shape(list(header_lens))
    ph = [Affine(const=(len(header_lens), 0))]
    prev_digest = trusted_h
    for mi, length in enumerate(header_lens):
        padded = blake2b_pad(headers[mi]) if headers else None
        limbs = _limbs32(b"".join(padded)) if padded else None
        n_sections = max(1, (length + 127) // 128)
        for s in range(n_sections):
            for li in range(32):
                if s == 0 and li < 8:
                    # parent-hash field == previous header's digest
                    ph.append(prev_digest[li])
                elif 128 * s + 4 * li >= length:
                    # zero-pad region (blake2b_pad): pinned constants, so
                    # the statement is Blake2b of a length-`length` message
                    # (a limb straddling the boundary stays witness; its
                    # ≤3 pad bytes are determined by the pinned digest)
                    ph.append(Affine(const=(0, 0)))
                else:
                    v = limbs[32 * s + li] if limbs is not None else None
                    ph.append(b.fresh((v, 0) if v is not None else None,
                                      f"hdr{mi}.{s}.{li}"))
        if mi == len(header_lens) - 1:
            dig = final_h
        else:
            dv = _limbs32(hashlib.blake2b(headers[mi],
                                          digest_size=32).digest()) \
                if headers else [None] * 8
            dig = [b.fresh((v, 0) if v is not None else None,
                           f"dig{mi}.{j}") for j, v in enumerate(dv)]
        ph += dig
        prev_digest = dig
    verifier_tape(b, air, child_config, proof=proof,
                  public_handles=ph, device=device)


def prove_hash_chain(headers: list[bytes], child_config: StarkConfig,
                     outer_config: StarkConfig | None = None, *,
                     device) -> HashChainProof:
    """ONE machine proof of: header_0.parent == trusted, header_i.parent ==
    Blake2b(header_{i-1}), Blake2b(header_last) == final — with every
    header byte hidden.  `trusted` is read from header_0's first 32 bytes;
    `final` is the last header's hash."""
    outer_config = outer_config or child_config
    for i in range(1, len(headers)):
        assert headers[i][:32] == hashlib.blake2b(
            headers[i - 1], digest_size=32).digest(), "headers do not link"
    trusted = headers[0][:32]
    final = hashlib.blake2b(headers[-1], digest_size=32).digest()
    air = Blake2bAir(headers, bind="public")
    child = prove(air, air.build_trace(), child_config, device=device)
    bld = Builder(witness=True)
    _chain_tape(bld, [len(h) for h in headers], trusted, final,
                child_config, child, headers, device=device)
    prog = compile_tape(bld)
    mair = MachineAir(prog)
    out = HashChainProof(
        proof=prove(mair, mair.build_trace(), outer_config, device=device),
        header_lens=[len(h) for h in headers])
    progcache.put(_chain_key(out.header_lens, trusted, final,
                             child_config), prog)
    return out


def verify_hash_chain(trusted: bytes, final: bytes, chain: HashChainProof,
                      child_config: StarkConfig,
                      outer_config: StarkConfig | None = None, *,
                      device) -> bool:
    """Checks ONE machine proof against (trusted_hash, final_hash) and the
    statement header sizes — no header bytes are ever seen.  Any failure
    is a rejection."""
    outer_config = outer_config or child_config
    try:
        def _rebuild():
            bld = Builder(witness=False)
            _chain_tape(bld, chain.header_lens, trusted, final,
                        child_config, None, None, device=device)
            return compile_tape(bld)

        mair = MachineAir(progcache.cached_program(
            _chain_key(chain.header_lens, trusted, final, child_config),
            _rebuild))
        return verify(mair, chain.proof, outer_config, device=device)
    except Exception:
        return False

"""Succinct header_range: ONE machine proof, verifier sees ONLY the ABI.

Port of `vectorx_tpu.circuits.succinct_header_range`.  This is the
product statement of the upstream header_range circuit
(circuits/header_range.rs:32-58): the verifier receives the 80-byte
packed input, the 96-byte packed output, and a proof — no header bytes,
no per-header hashes, no commitment-tree interiors.  Upstream reaches this
shape through plonky2x map-reduce recursion plus a gateway wrap
(circuits/builder/subchain_verification.rs:78-296); here every
sub-statement is a child STARK verified inside ONE verifier-VM machine
trace (recursion/machine.py), with hidden values flowing between children
as wired tape handles (shadow.verifier_tape public_handles):

* a Blake2b hash-chain child over the WITNESS header limbs — parent-hash
  linking by wiring each header's first 8 limbs to the previous digest,
  trusted/target hashes as machine publics;
* witness-mode field extraction: the block-number bytes are pinned to the
  SCALE compact encoding of the statement-known number, and the
  state/data roots are carved out of the hidden limbs by in-tape bit
  decomposition (the role plonky2x's RLC `get_fixed_subarray` plays
  upstream, circuits/builder/decoder.rs:141-148; the mode-dependent
  offset is statement-computable because the block number is public);
* SHA-256 commitment-tree children whose leaves are the extracted root
  words and whose interiors are hidden fresh values, roots pinned to the
  output commitments;
* the GRANDPA justification folded into the SAME machine proof: the
  authority-set commitment chain (hidden intermediate digests, final
  digest pinned to the input's authority_set_hash), the SHA-512
  challenge-hash children, and the ed25519 ladder children
  ([S]B = R + [h]A, upstream circuits/builder/justification.rs:237-243).

Public surface of the machine proof (boundary-pinned machine publics):
trusted hash, target hash, state/data root commitments, authority set
hash — exactly the ABI values.  The justification's signature data
(pubkeys, R, S, challenge digests) remains public metadata inside the
proof object: GRANDPA votes are public chain data, and it costs
O(authorities), not O(headers·header_size).  Header lengths are statement
metadata (they parameterize trace shapes).

Every child proof, every child verification key the tape derives and the
machine proof run on the `device` the caller names; the statement's
machine program is cached by content (recursion/progcache.py).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.circuits.zk_commitment import chunk_by_rows
from vectorx_tpu_torch.circuits.zk_justification import (
    LADDER_ROWS_PER_SIG, _ladder_sigs, _sha512_rows, challenge_messages,
    ladder_chunk_sizes)
from vectorx_tpu_torch.curves.ed25519 import L as ED_L
from vectorx_tpu_torch.io.abi import HeaderRangeInput, HeaderRangeOutput
from vectorx_tpu_torch.recursion import progcache
from vectorx_tpu_torch.recursion.machine import MachineAir, compile_tape
from vectorx_tpu_torch.recursion.shadow import verifier_tape
from vectorx_tpu_torch.recursion.ssa import Affine, Builder
from vectorx_tpu_torch.stark.blake2b_air import SECTION as B2_SECTION
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir, blake2b_pad
from vectorx_tpu_torch.stark.ed25519_ladder_air import Ed25519LadderAir
from vectorx_tpu_torch.stark.prover import StarkConfig, prove
from vectorx_tpu_torch.stark.sha256_air import SECTION as SHA_SECTION
from vectorx_tpu_torch.stark.sha256_air import Sha256Air, sha256_pad
from vectorx_tpu_torch.stark.sha512_air import Sha512Air
from vectorx_tpu_torch.stark.verifier import verify

# trace-row budget per child proof (memory knob, not soundness-relevant;
# the tape builder chunks deterministically so prover and verifier agree)
MAX_CHILD_ROWS = 1 << 14

# rows of one signature in a ladder chunk (zk_justification.MAX_LADDER_ROWS
# // this = 16 signatures a chunk)
_LADDER_ROWS_PER_SIG = LADDER_ROWS_PER_SIG


def _blake_rows(length: int) -> int:
    return B2_SECTION * max(1, (length + 127) // 128) + 1


def _sha_msg_rows(msg_len: int) -> int:
    return SHA_SECTION * (len(sha256_pad(bytes(msg_len))) // 64) + 1


def _limbs32(data: bytes) -> list[int]:
    """Little-endian u32 limbs (Blake2b word convention)."""
    return [int.from_bytes(data[i:i + 4], "little")
            for i in range(0, len(data), 4)]


def _words_be(data: bytes) -> list[int]:
    """Big-endian u32 words (SHA-256 convention)."""
    return [int.from_bytes(data[i:i + 4], "big")
            for i in range(0, len(data), 4)]


def _sha_pad_words(msg_len: int) -> list[int]:
    """SHA-256 pad words beyond the message for an msg_len-byte message
    (msg_len % 4 == 0): independent of message content."""
    assert msg_len % 4 == 0
    padded = sha256_pad(bytes(msg_len))
    return [int.from_bytes(padded[i:i + 4], "big")
            for i in range(msg_len, len(padded), 4)]


@dataclass
class SuccinctHeaderRangeProof:
    """Everything the verifier needs beyond (input_bytes, output_bytes).

    `header_lens` is shape metadata; the justification fields are public
    GRANDPA vote data (see module docstring); `machine_proof` is the ONE
    STARK covering every sub-statement."""

    input_bytes: bytes
    output_bytes: bytes
    header_lens: list
    tree_size: int
    # justification public data (upstream JustificationVariable,
    # circuits/vars.rs:16-44)
    signed_message: bytes
    pubkeys: list
    signatures: list
    validator_signed: list
    num_authorities: int
    challenge_digests: list
    machine_proof: object


class _ProofCursor:
    """Child proofs in tape order (prover side); None for the verifier."""

    def __init__(self, proofs):
        self.proofs = proofs
        self.i = 0

    def next(self):
        if self.proofs is None:
            return None
        p = self.proofs[self.i]
        self.i += 1
        return p


def _byte_affine(bits: list, lo: int) -> Affine:
    """The byte starting at bit `lo` of a 32-bit decomposition."""
    return Affine(bits={bits[lo + t]: 1 << t for t in range(8)})


def _wired(b: Builder, value, tag: str) -> Affine:
    """A hidden tape value: its witness `value` (an int) or None."""
    return b.fresh((value, 0) if value is not None else None, tag)


def _chain_section(b: Builder, stmt, cfg, cursor, headers,
                   trusted_h, final_h, *, device):
    """Blake2b hash-chain children over witness header limbs, plus
    in-tape extraction.  Returns (state_words, data_words): per header,
    8 big-endian u32 word affines for each root."""
    inp = stmt["inp"]
    lens = stmt["header_lens"]
    chunk_sizes = chunk_by_rows(lens, _blake_rows, MAX_CHILD_ROWS)
    state_words, data_words = [], []
    prev_digest = trusted_h
    mi = 0
    for csz in chunk_sizes:
        chunk_lens = lens[mi:mi + csz]
        air = Blake2bAir.public_shape(list(chunk_lens))
        ph = [Affine(const=(csz, 0))]
        for length in chunk_lens:
            header = headers[mi] if headers is not None else None
            limbs = _limbs32(b"".join(blake2b_pad(header))) \
                if header is not None else None
            n_sections = max(1, (length + 127) // 128)
            handles = {}
            for s in range(n_sections):
                for li in range(32):
                    pos = 32 * s + li
                    if s == 0 and li < 8:
                        h = prev_digest[li]
                    elif 4 * pos >= length:
                        # zero-pad region: pinned constants (the straddle
                        # limb below stays witness; its pad bits are
                        # zero-asserted when it is bit-decomposed)
                        h = Affine(const=(0, 0))
                    else:
                        h = _wired(b, limbs[pos] if limbs is not None
                                   else None, f"hdr{mi}.{pos}")
                    ph.append(h)
                    handles[pos] = h
            # ---- extraction: block number pin + state/data roots -------
            number = inp.trusted_block + 1 + mi
            enc_num = scale.compact_encode(number)
            c = len(enc_num)
            if length < 64 + c or length < 96:
                raise ValueError(f"header {mi} too short ({length} B) for "
                                 "field extraction")
            need = set(range(8, (64 + c + 3) // 4)) \
                | set(range((length - 32) // 4, (length + 3) // 4))
            bits = {}
            for j in sorted(need):
                bits[j] = b.bitdec(handles[j], 32, canonical=False)
                # tighten the straddle limb: pad bytes past `length` are 0
                for o in range(4 * j, 4 * j + 4):
                    if o >= length:
                        b.assert_zero(_byte_affine(bits[j], 8 * (o % 4)),
                                      where=f"hdr{mi}.pad{o}")

            def byte(o):
                return _byte_affine(bits[o // 4], 8 * (o % 4))

            for k, bv in enumerate(enc_num):
                b.assert_eq(byte(32 + k), Affine(const=(bv, 0)),
                            where=f"hdr{mi}.num{k}")

            def word_be(off):
                w = Affine(const=(0, 0))
                for jj in range(4):
                    w = w.plus(byte(off + jj).scaled(1 << (8 * (3 - jj))))
                return w

            state_words.append([word_be(32 + c + 4 * k) for k in range(8)])
            data_words.append([word_be(length - 32 + 4 * k)
                               for k in range(8)])
            # ---- digest handles ----------------------------------------
            if mi == len(lens) - 1:
                dig = final_h
            else:
                dv = _limbs32(hashlib.blake2b(
                    header, digest_size=32).digest()) \
                    if header is not None else [None] * 8
                dig = [_wired(b, v, f"dig{mi}.{j}") for j, v in enumerate(dv)]
            ph += dig
            prev_digest = dig
            mi += 1
        verifier_tape(b, air, cfg, proof=cursor.next(), public_handles=ph,
                      device=device)
    return state_words, data_words


def _tree_section(b: Builder, leaf_words, tree_size, root_h, cfg, cursor,
                  leaf_values, tag, *, device):
    """SHA-256 commitment tree over `leaf_words` (per-leaf 8 word
    handles), zero-padded to `tree_size`; interiors hidden, root pinned
    to `root_h`.  `leaf_values` (witness mode): the actual 32-byte leaf
    roots, used to compute interior digests."""
    zero_leaf = [Affine(const=(0, 0))] * 8
    cur = list(leaf_words) + [zero_leaf] * (tree_size - len(leaf_words))
    vals = None
    if leaf_values is not None:
        vals = list(leaf_values) + \
            [b"\x00" * 32] * (tree_size - len(leaf_values))
    pad64 = [Affine(const=(w, 0)) for w in _sha_pad_words(64)]
    lvl = 0
    while len(cur) > 1:
        n_nodes = len(cur) // 2
        next_vals = None
        if vals is not None:
            next_vals = [hashlib.sha256(vals[2 * i] + vals[2 * i + 1])
                         .digest() for i in range(n_nodes)]
        chunk_sizes = chunk_by_rows([64] * n_nodes, _sha_msg_rows,
                                    MAX_CHILD_ROWS)
        outs = []
        ni = 0
        for csz in chunk_sizes:
            air = Sha256Air.public_shape([2] * csz)
            ph = [Affine(const=(csz, 0))]
            for _ in range(csz):
                ph += cur[2 * ni] + cur[2 * ni + 1] + pad64
                if n_nodes == 1:
                    dig = root_h
                else:
                    dv = _words_be(next_vals[ni]) if next_vals is not None \
                        else [None] * 8
                    dig = [_wired(b, v, f"{tag}{lvl}.{ni}.{j}")
                           for j, v in enumerate(dv)]
                ph += dig
                outs.append(dig)
                ni += 1
            verifier_tape(b, air, cfg, proof=cursor.next(),
                          public_handles=ph, device=device)
        cur = outs
        vals = next_vals
        lvl += 1


def _commitment_section(b: Builder, pubkeys, auth_h, cfg, cursor, witness,
                        *, device):
    """Chained-SHA256 authority-set commitment (upstream
    circuits/builder/justification.rs:127-162): step digests hidden, final
    digest pinned to the input's authority set hash.  Pubkeys are tape
    constants (binding them into the program)."""
    digests = None
    if witness:
        digests, acc = [], b""
        for pk in pubkeys:
            acc = hashlib.sha256(acc + pk).digest()
            digests.append(acc)
    msg_lens = [32] + [64] * (len(pubkeys) - 1)
    chunk_sizes = chunk_by_rows(msg_lens, _sha_msg_rows, MAX_CHILD_ROWS)
    prev = None
    si = 0
    for csz in chunk_sizes:
        air = Sha256Air.public_shape(
            [len(sha256_pad(bytes(n))) // 64 for n in
             msg_lens[si:si + csz]])
        ph = [Affine(const=(csz, 0))]
        for _ in range(csz):
            pk_words = [Affine(const=(w, 0))
                        for w in _words_be(pubkeys[si])]
            if si == 0:
                ph += pk_words
                ph += [Affine(const=(w, 0)) for w in _sha_pad_words(32)]
            else:
                ph += prev + pk_words
                ph += [Affine(const=(w, 0)) for w in _sha_pad_words(64)]
            if si == len(pubkeys) - 1:
                dig = auth_h
            else:
                dv = _words_be(digests[si]) if digests is not None \
                    else [None] * 8
                dig = [_wired(b, v, f"auth{si}.{j}")
                       for j, v in enumerate(dv)]
            ph += dig
            prev = dig
            si += 1
        verifier_tape(b, air, cfg, proof=cursor.next(), public_handles=ph,
                      device=device)


def _justification_children(stmt):
    """The SHA-512 challenge and ed25519 ladder child statements, derived
    from the proof's public justification data.  Raises on non-canonical
    S (as zk_justification does)."""
    enabled = [i for i in range(stmt["num_authorities"])
               if stmt["validator_signed"][i]]
    msgs = challenge_messages(stmt["pubkeys"], stmt["signatures"],
                              stmt["signed_message"], enabled)
    digests = stmt["challenge_digests"]
    sigs = _ladder_sigs(stmt["pubkeys"], stmt["signatures"],
                        stmt["signed_message"], enabled, digests)
    sha_airs, pos = [], 0
    for sz in chunk_by_rows(msgs, _sha512_rows, MAX_CHILD_ROWS):
        sha_airs.append(Sha512Air.statement(msgs[pos:pos + sz],
                                            digests[pos:pos + sz]))
        pos += sz
    ladder_airs, pos = [], 0
    for sz in ladder_chunk_sizes(len(sigs)):
        ladder_airs.append(Ed25519LadderAir.statement(sigs[pos:pos + sz]))
        pos += sz
    return msgs, sha_airs, ladder_airs


def _justification_section(b: Builder, stmt, cfg, cursor, *, device):
    """The SHA-512 and ladder children, their statements as tape
    constants."""
    _, sha_airs, ladder_airs = _justification_children(stmt)
    for air in sha_airs + ladder_airs:
        verifier_tape(b, air, cfg, proof=cursor.next(),
                      public_handles=[Affine(const=(v, 0))
                                      for v in air.public_inputs()],
                      device=device)


def _prove_justification_children(stmt, config, proofs, *, device):
    """Append the live SHA-512 and ladder children's proofs to `proofs`,
    in tape order."""
    msgs, sha_airs, ladder_airs = _justification_children(stmt)
    pos = 0
    for s_air in sha_airs:
        live = Sha512Air(msgs[pos:pos + len(s_air.messages)])
        proofs.append(prove(live, live.build_trace(), config, device=device))
        pos += len(s_air.messages)
    for l_air in ladder_airs:
        live = Ed25519LadderAir(l_air.sigs)
        proofs.append(prove(live, live.build_trace(), config, device=device))


def _range_tape(b: Builder, stmt, cfg, cursor, headers, *, device):
    """The full succinct header_range tape.  Statement mode when
    `headers is None` (cursor yields None); witness mode otherwise.
    Machine publics: [0..8) trusted hash limbs, [8..16) target hash
    limbs, [16..24) state commitment words, [24..32) data commitment
    words, [32..40) authority set hash words."""
    inp: HeaderRangeInput = stmt["inp"]
    out: HeaderRangeOutput = stmt["out"]
    trusted_h = [b.public(v, i)
                 for i, v in enumerate(_limbs32(inp.trusted_header_hash))]
    final_h = [b.public(v, 8 + i)
               for i, v in enumerate(_limbs32(out.target_header_hash))]
    state_root_h = [b.public(v, 16 + i) for i, v in
                    enumerate(_words_be(out.state_root_commitment))]
    data_root_h = [b.public(v, 24 + i) for i, v in
                   enumerate(_words_be(out.data_root_commitment))]
    auth_h = [b.public(v, 32 + i) for i, v in
              enumerate(_words_be(inp.authority_set_hash))]

    state_words, data_words = _chain_section(
        b, stmt, cfg, cursor, headers, trusted_h, final_h, device=device)

    leaf_vals = None
    if headers is not None:
        leaf_vals = ([], [])
        for mi, header in enumerate(headers):
            enc_num = scale.compact_encode(inp.trusted_block + 1 + mi)
            off = 32 + len(enc_num)
            leaf_vals[0].append(header[off:off + 32])
            leaf_vals[1].append(header[len(header) - 32:])
    _tree_section(b, state_words, stmt["tree_size"], state_root_h, cfg,
                  cursor, leaf_vals[0] if leaf_vals else None, "st",
                  device=device)
    _tree_section(b, data_words, stmt["tree_size"], data_root_h, cfg,
                  cursor, leaf_vals[1] if leaf_vals else None, "dt",
                  device=device)

    _commitment_section(b, stmt["pubkeys"][:stmt["num_authorities"]],
                        auth_h, cfg, cursor, witness=headers is not None,
                        device=device)
    _justification_section(b, stmt, cfg, cursor, device=device)


def _stmt_prog_key(stmt, config: StarkConfig) -> str:
    """Content address of the statement-mode machine program: every input
    the verifier's own tape derivation reads (recursion/progcache.py)."""
    f = config.fri
    return progcache.digest_key(
        "succinct_header_range",
        f.rate_bits, f.cap_height, f.num_queries, f.final_poly_len,
        f.pow_bits,
        stmt["inp"].encode(), stmt["out"].encode(),
        stmt["header_lens"], stmt["tree_size"],
        stmt["signed_message"], list(stmt["pubkeys"]),
        list(stmt["signatures"]),
        [bool(x) for x in stmt["validator_signed"]],
        stmt["num_authorities"], list(stmt["challenge_digests"]))


def _statement(input_bytes, output_bytes, header_lens, tree_size,
               justification_fields) -> dict:
    inp = HeaderRangeInput.decode(input_bytes)
    out = HeaderRangeOutput.decode(output_bytes)
    n = inp.target_block - inp.trusted_block
    if n < 1 or len(header_lens) != n:
        raise ValueError("header count does not match the block range")
    if tree_size < 2 or tree_size & (tree_size - 1) or n > tree_size:
        raise ValueError("bad tree size")
    return {"inp": inp, "out": out, "header_lens": list(header_lens),
            "tree_size": tree_size, **justification_fields}


def _justification_fields(j) -> dict:
    """The proof's public justification data for justification `j`."""
    enabled = [i for i in range(j.num_authorities) if j.validator_signed[i]]
    msgs = challenge_messages(j.pubkeys, j.signatures, j.signed_message,
                              enabled)
    return {
        "signed_message": j.signed_message, "pubkeys": list(j.pubkeys),
        "signatures": list(j.signatures),
        "validator_signed": list(j.validator_signed),
        "num_authorities": j.num_authorities,
        "challenge_digests": [hashlib.sha512(m).digest() for m in msgs],
    }


def _prove_chain(pubkeys, config, proofs, *, device) -> bytes:
    """Append the proofs of the commitment chain's steps (digest so far ‖
    pubkey) to `proofs`; returns the chain's final digest."""
    acc, msgs = b"", []
    for pk in pubkeys:
        msgs.append(acc + pk)
        acc = hashlib.sha256(acc + pk).digest()
    si = 0
    for csz in chunk_by_rows([len(m) for m in msgs], _sha_msg_rows,
                             MAX_CHILD_ROWS):
        air = Sha256Air(msgs[si:si + csz], bind="public")
        proofs.append(prove(air, air.build_trace(), config, device=device))
        si += csz
    return acc


def _machine_prove(build_tape, key, outer_config, *, device):
    """Compile the witness tape, key its program (so the prover's machine
    and the verifier's share one verification key) and prove it."""
    b = Builder(witness=True)
    build_tape(b)
    prog = compile_tape(b)
    progcache.put(key, prog)
    mair = MachineAir(prog)
    return prove(mair, mair.build_trace(), outer_config, device=device)


def _machine_verify(build_tape, key, proof, outer_config, *, device) -> bool:
    """Check `proof` against the statement program (from the cache, or
    derived by `build_tape` in statement mode); any failure is a
    rejection."""
    def rebuild():
        b = Builder(witness=False)
        build_tape(b)
        return compile_tape(b)

    try:
        mair = MachineAir(progcache.cached_program(key, rebuild))
        return verify(mair, proof, outer_config, device=device)
    except Exception:
        return False


def _justification_ok(p, block_hash: bytes, block_number: int,
                      set_id: int, n_auth: int) -> bool:
    """The host checks on the proof's public justification data
    (zk_justification's): shape, tail entries, precommit, threshold,
    digest count and canonical S."""
    if not (len(p.validator_signed) == len(p.pubkeys)
            == len(p.signatures)):
        return False
    if n_auth <= 0 or n_auth > len(p.pubkeys):
        return False
    if any(p.validator_signed[i] for i in range(n_auth,
                                                len(p.validator_signed))):
        return False
    try:
        bh, bn, _round, sid = scale.decode_precommit(p.signed_message)
    except Exception:
        return False
    if (block_hash is not None and bh != block_hash) or bn != block_number \
            or sid != set_id:
        return False
    num_signed = sum(bool(x) for x in p.validator_signed)
    if not num_signed * 3 > n_auth * 2:
        return False
    enabled = [i for i in range(n_auth) if p.validator_signed[i]]
    if len(p.challenge_digests) != len(enabled) or \
            any(len(d) != 64 for d in p.challenge_digests):
        return False
    return all(int.from_bytes(p.signatures[i][32:], "little") < ED_L
               for i in enabled)


def prove_header_range_succinct(fetcher, input_bytes: bytes,
                                tree_size: int,
                                config: StarkConfig = StarkConfig(),
                                outer_config: StarkConfig | None = None, *,
                                device) -> SuccinctHeaderRangeProof:
    """Prove the full header_range statement as ONE machine STARK on
    `device`."""
    outer_config = outer_config or config
    inp = HeaderRangeInput.decode(input_bytes)
    headers = [fetcher.get_encoded_header(bn)
               for bn in range(inp.trusted_block + 1, inp.target_block + 1)]
    hashes = [hashlib.blake2b(h, digest_size=32).digest() for h in headers]
    assert headers[0][:32] == inp.trusted_header_hash, \
        "trusted hash does not match header 0's parent"

    state_leaves, data_leaves = [], []
    for mi, h in enumerate(headers):
        enc_num = scale.compact_encode(inp.trusted_block + 1 + mi)
        off = 32 + len(enc_num)
        state_leaves.append(h[off:off + 32])
        data_leaves.append(h[len(h) - 32:])
    pad = tree_size - len(headers)

    def levels(leaves):
        """(messages, digests) of each tree level, leaves first."""
        level = list(leaves) + [b"\x00" * 32] * pad
        while len(level) > 1:
            msgs = [level[2 * i] + level[2 * i + 1]
                    for i in range(len(level) // 2)]
            level = [hashlib.sha256(m).digest() for m in msgs]
            yield msgs, level

    def tree_root(leaves):
        return list(levels(leaves))[-1][1][0]

    out = HeaderRangeOutput(
        target_header_hash=hashes[-1],
        state_root_commitment=tree_root(state_leaves),
        data_root_commitment=tree_root(data_leaves))
    output_bytes = out.encode()

    j = fetcher.get_justification(inp.target_block)
    assert j.authority_set_id == inp.authority_set_id
    jfields = _justification_fields(j)
    stmt = _statement(input_bytes, output_bytes,
                      [len(h) for h in headers], tree_size, jfields)

    # ---- child proofs, in tape order --------------------------------------
    proofs = []
    pos = 0
    for csz in chunk_by_rows(stmt["header_lens"], _blake_rows,
                             MAX_CHILD_ROWS):
        air = Blake2bAir(headers[pos:pos + csz], bind="public")
        proofs.append(prove(air, air.build_trace(), config, device=device))
        pos += csz
    for leaves in (state_leaves, data_leaves):
        for msgs, _ in levels(leaves):
            ni = 0
            for csz in chunk_by_rows([64] * len(msgs), _sha_msg_rows,
                                     MAX_CHILD_ROWS):
                air = Sha256Air(msgs[ni:ni + csz], bind="public")
                proofs.append(prove(air, air.build_trace(), config,
                                    device=device))
                ni += csz
    final = _prove_chain(stmt["pubkeys"][:stmt["num_authorities"]], config,
                         proofs, device=device)
    assert final == inp.authority_set_hash, "authority set hash mismatch"
    _prove_justification_children(stmt, config, proofs, device=device)

    # ---- the ONE machine proof --------------------------------------------
    cursor = _ProofCursor(proofs)
    machine_proof = _machine_prove(
        lambda b: _range_tape(b, stmt, config, cursor, headers,
                              device=device),
        _stmt_prog_key(stmt, config), outer_config, device=device)
    return SuccinctHeaderRangeProof(
        input_bytes=input_bytes, output_bytes=output_bytes,
        header_lens=stmt["header_lens"], tree_size=tree_size,
        machine_proof=machine_proof, **jfields)


def verify_header_range_succinct(
        proof: SuccinctHeaderRangeProof,
        config: StarkConfig = StarkConfig(),
        outer_config: StarkConfig | None = None, *, device) -> bool:
    """Verify ONE machine proof against (input_bytes, output_bytes).

    Host-side work: cheap bookkeeping over the proof's public
    justification data (threshold, precommit decode, scalar ranges), all
    before any tape or STARK work, and ONE STARK verification on `device`
    — never a hash, a signature, or a header byte."""
    outer_config = outer_config or config
    p = proof
    try:
        inp = HeaderRangeInput.decode(p.input_bytes)
        out = HeaderRangeOutput.decode(p.output_bytes)
    except Exception:
        return False
    if not _justification_ok(p, out.target_header_hash, inp.target_block,
                             inp.authority_set_id, p.num_authorities):
        return False
    try:
        stmt = _statement(
            p.input_bytes, p.output_bytes, p.header_lens, p.tree_size,
            {"signed_message": p.signed_message, "pubkeys": p.pubkeys,
             "signatures": p.signatures,
             "validator_signed": p.validator_signed,
             "num_authorities": p.num_authorities,
             "challenge_digests": p.challenge_digests})
        key = _stmt_prog_key(stmt, config)
    except Exception:
        return False
    return _machine_verify(
        lambda b: _range_tape(b, stmt, config, _ProofCursor(None), None,
                              device=device),
        key, p.machine_proof, outer_config, device=device)

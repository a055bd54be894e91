"""Succinct rotate: ONE machine proof, witness-mode epoch-end byte walk.

Port of `vectorx_tpu.circuits.succinct_rotate`.  The product statement of
the upstream Rotate circuit (circuits/rotate.rs:67-121): for input
(authority_set_id, authority_set_hash) the verifier learns ONLY the new
authority set hash — the epoch-end header bytes never reach it.  Upstream
proves the consensus-log walk and validator scan in-circuit over
witnessed header bytes (circuits/builder/rotate.rs:169-276, hinted
positions from input/mod.rs:835-968); here the same checks are tape
constraints over hidden Blake2b witness limbs:

* ONE Blake2b child over the witness header limbs (`bind="public"`
  wiring), digest pinned to the header hash the justification signs;
* the byte walk as in-tape constraints: consensus flag 0x04 + FRNK
  engine id, the ScheduledChange 0x01 flag, the compact-mode bits of the
  message-length prefix, the encoded authority count pinned to
  `compact_encode(num_authorities)`, and the full validator window
  (pubkey ‖ weight=1u64 LE ‖ … ‖ delay=0) pinned limb-wise — positions
  are statement metadata (upstream hints them too, rotate.rs:27-65), so
  every offset is statement-computable and fully-pinned limbs enter as
  constants, with bit decomposition only at window edges;
* the CURRENT set's commitment chain pinned to the input hash, the NEW
  set's chain pinned to the output hash, and the GRANDPA justification
  (SHA-512 challenge + ed25519 ladder children) — all inside the SAME
  machine proof (succinct_header_range sections).

Disclosure model as in succinct_header_range: justification data and the
new validator set are public chain data carried as proof metadata; the
header BYTES are hidden.  Every proof runs on the `device` the caller
names.
"""

from __future__ import annotations

from dataclasses import dataclass

from vectorx_tpu_torch import scale
from vectorx_tpu_torch.circuits.rotate import (DELAY_BYTES, VALIDATOR_LENGTH,
                                               WEIGHT_BYTES)
from vectorx_tpu_torch.circuits.succinct_header_range import (
    _byte_affine, _commitment_section, _justification_fields,
    _justification_ok, _justification_section, _limbs32, _machine_prove,
    _machine_verify, _ProofCursor, _prove_chain,
    _prove_justification_children, _wired, _words_be)
from vectorx_tpu_torch.io.abi import RotateInput, RotateOutput
from vectorx_tpu_torch.recursion import progcache
from vectorx_tpu_torch.recursion.shadow import verifier_tape
from vectorx_tpu_torch.recursion.ssa import Affine, Builder
from vectorx_tpu_torch.stark.blake2b_air import Blake2bAir, blake2b_pad
from vectorx_tpu_torch.stark.prover import StarkConfig, prove


@dataclass
class SuccinctRotateProof:
    """Verifier surface: (input_bytes, output_bytes, machine_proof) plus
    public metadata — walk positions (shape), the new validator set
    (commits to the output), and the justification's public vote data."""

    input_bytes: bytes
    output_bytes: bytes
    epoch_end_block: int
    header_len: int
    start_position: int
    len_prefix_consumed: int     # compact byte-length of the msg-len prefix
    num_authorities: int         # NEW set size
    new_pubkeys: list
    # justification public data (CURRENT set)
    signed_message: bytes
    pubkeys: list
    signatures: list
    validator_signed: list
    just_num_authorities: int
    challenge_digests: list
    machine_proof: object


def _pinned_bytes(stmt) -> dict:
    """offset -> expected byte, for every statement-pinned position of the
    epoch-end byte walk (upstream rotate.rs:74-276 semantics)."""
    start = stmt["start_position"]
    pins = {start + 1: 4}
    for k, ev in enumerate(scale.CONSENSUS_ENGINE_ID):
        pins[start + 2 + k] = ev
    cursor = start + 6 + stmt["len_prefix_consumed"]
    pins[cursor] = 1                       # ScheduledChange flag
    cursor += 1
    for k, ev in enumerate(scale.compact_encode(stmt["num_authorities"])):
        pins[cursor + k] = ev
    cursor += len(scale.compact_encode(stmt["num_authorities"]))
    for i in range(stmt["num_authorities"]):
        off = cursor + i * VALIDATOR_LENGTH
        for k, pv in enumerate(stmt["new_pubkeys"][i]):
            pins[off + k] = pv
        for k, wv in enumerate(WEIGHT_BYTES):
            pins[off + 32 + k] = wv
    doff = cursor + stmt["num_authorities"] * VALIDATOR_LENGTH
    for k, dv in enumerate(DELAY_BYTES):
        pins[doff + k] = dv
    return pins


def _header_section(b: Builder, stmt, cfg, cursor, header, bh: bytes, *,
                    device):
    """ONE Blake2b child over witness header limbs with the walk pinned.

    Fully-pinned limbs (and pad limbs) enter the child wiring as Affine
    constants — zero extra constraints; partially-pinned limbs stay
    witness and get bit-decomposed byte pins.  The digest is pinned to
    `bh` (public: it is bytes 1..33 of the signed precommit message)."""
    length = stmt["header_len"]
    pins = _pinned_bytes(stmt)
    air = Blake2bAir.public_shape([length])
    limbs = _limbs32(b"".join(blake2b_pad(header))) \
        if header is not None else None
    n_sections = max(1, (length + 127) // 128)
    ph = [Affine(const=(1, 0))]
    handles = {}
    partial = []                     # limbs needing byte-level treatment
    for pos in range(32 * n_sections):
        span = range(4 * pos, 4 * pos + 4)
        known = [pins.get(o, 0 if o >= length else None) for o in span]
        if all(k is not None for k in known):
            v = int.from_bytes(bytes(known), "little")
            h = Affine(const=(v, 0))
        else:
            h = _wired(b, limbs[pos] if limbs is not None else None,
                       f"rot.{pos}")
            if any(k is not None for k in known):
                partial.append(pos)
        ph.append(h)
        handles[pos] = h
    bits = {}
    for pos in partial:
        bits[pos] = b.bitdec(handles[pos], 32, canonical=False)
        for o in range(4 * pos, 4 * pos + 4):
            exp = pins.get(o, 0 if o >= length else None)
            if exp is not None:
                b.assert_eq(_byte_affine(bits[pos], 8 * (o % 4)),
                            Affine(const=(exp, 0)), where=f"rot.b{o}")
    # compact-mode bits of the msg-len prefix (value itself stays hidden)
    mo = stmt["start_position"] + 6
    consumed = stmt["len_prefix_consumed"]
    pos = mo // 4
    if pos not in bits:
        bits[pos] = b.bitdec(handles[pos], 32, canonical=False)
    if consumed == 5:
        # big-int mode for a u32: the prefix byte is exactly 0b11
        b.assert_eq(_byte_affine(bits[pos], 8 * (mo % 4)),
                    Affine(const=(3, 0)), where="rot.lenmode")
    else:
        m = {1: (0, 0), 2: (1, 0), 4: (0, 1)}[consumed]
        lo = 8 * (mo % 4)
        b.assert_eq(Affine(bits={bits[pos][lo]: 1}),
                    Affine(const=(m[0], 0)), where="rot.lenmode0")
        b.assert_eq(Affine(bits={bits[pos][lo + 1]: 1}),
                    Affine(const=(m[1], 0)), where="rot.lenmode1")
    ph += [Affine(const=(v, 0)) for v in _limbs32(bh)]
    verifier_tape(b, air, cfg, proof=cursor.next(), public_handles=ph,
                  device=device)


def _justification_stmt(stmt) -> dict:
    """The CURRENT set's justification fields, as the header_range
    sections name them."""
    return {"num_authorities": stmt["just_num_authorities"],
            "validator_signed": stmt["validator_signed"],
            "signatures": stmt["signatures"], "pubkeys": stmt["pubkeys"],
            "signed_message": stmt["signed_message"],
            "challenge_digests": stmt["challenge_digests"]}


def _rotate_tape(b: Builder, stmt, cfg, cursor, header, *, device):
    """Machine publics: [0..8) current set hash words, [8..16) new set
    hash words."""
    inp: RotateInput = stmt["inp"]
    out: RotateOutput = stmt["out"]
    auth_h = [b.public(v, i)
              for i, v in enumerate(_words_be(inp.authority_set_hash))]
    new_h = [b.public(v, 8 + i) for i, v in
             enumerate(_words_be(out.new_authority_set_hash))]
    bh = scale.decode_precommit(stmt["signed_message"])[0]

    _header_section(b, stmt, cfg, cursor, header, bh, device=device)
    _commitment_section(b, stmt["pubkeys"][:stmt["just_num_authorities"]],
                        auth_h, cfg, cursor, witness=header is not None,
                        device=device)
    _commitment_section(b, stmt["new_pubkeys"][:stmt["num_authorities"]],
                        new_h, cfg, cursor, witness=header is not None,
                        device=device)
    _justification_section(b, _justification_stmt(stmt), cfg, cursor,
                           device=device)


def _stmt_prog_key(stmt, config: StarkConfig) -> str:
    """Content address of the statement-mode machine program: every input
    the verifier's own tape derivation reads (recursion/progcache.py)."""
    f = config.fri
    return progcache.digest_key(
        "succinct_rotate",
        f.rate_bits, f.cap_height, f.num_queries, f.final_poly_len,
        f.pow_bits,
        stmt["inp"].encode(), stmt["out"].encode(),
        stmt["epoch_end_block"], stmt["header_len"],
        stmt["start_position"], stmt["len_prefix_consumed"],
        stmt["num_authorities"], list(stmt["new_pubkeys"]),
        stmt["signed_message"], list(stmt["pubkeys"]),
        list(stmt["signatures"]),
        [bool(x) for x in stmt["validator_signed"]],
        stmt["just_num_authorities"], list(stmt["challenge_digests"]))


def _statement(input_bytes, output_bytes, meta: dict) -> dict:
    inp = RotateInput.decode(input_bytes)
    out = RotateOutput.decode(output_bytes)
    stmt = {"inp": inp, "out": out, **meta}
    n = stmt["num_authorities"]
    length = stmt["header_len"]
    start = stmt["start_position"]
    consumed = stmt["len_prefix_consumed"]
    if n < 1 or len(stmt["new_pubkeys"]) != n or \
            any(len(pk) != 32 for pk in stmt["new_pubkeys"]):
        raise ValueError("bad new validator set")
    if consumed not in (1, 2, 4, 5):
        raise ValueError("bad compact length prefix")
    end = start + 6 + consumed + 1 + len(scale.compact_encode(n)) \
        + n * VALIDATOR_LENGTH + 4
    if start < 0 or start + 8 > length:
        raise ValueError("scan window outside the hashed header")
    if end > length:
        raise ValueError("validator list extends past the hashed region")
    return stmt


_META = ("epoch_end_block", "header_len", "start_position",
         "len_prefix_consumed", "num_authorities", "new_pubkeys",
         "signed_message", "pubkeys", "signatures", "validator_signed",
         "just_num_authorities", "challenge_digests")


def prove_rotate_succinct(fetcher, input_bytes: bytes,
                          max_authorities: int = 300,
                          config: StarkConfig = StarkConfig(),
                          outer_config: StarkConfig | None = None, *,
                          device) -> SuccinctRotateProof:
    """Prove the full rotate statement as ONE machine STARK on `device`."""
    outer_config = outer_config or config
    inp = RotateInput.decode(input_bytes)
    epoch_end = fetcher.last_justified_block(inp.authority_set_id)
    rd = fetcher.get_header_rotate(epoch_end)
    header = rd.header_bytes[:rd.header_size]
    assert rd.num_authorities <= max_authorities
    new_pubkeys = list(rd.padded_pubkeys[:rd.num_authorities])
    sub = header[rd.start_position:]
    consumed = scale.compact_decode(sub[6:11])[2]

    j = fetcher.get_justification(epoch_end,
                                  max_authorities=max_authorities)
    assert j.authority_set_id == inp.authority_set_id
    jf = _justification_fields(j)
    jf["just_num_authorities"] = jf.pop("num_authorities")
    out = RotateOutput(new_authority_set_hash=rd.new_authority_set_hash)
    meta = {
        "epoch_end_block": epoch_end, "header_len": len(header),
        "start_position": rd.start_position, "len_prefix_consumed": consumed,
        "num_authorities": rd.num_authorities, "new_pubkeys": new_pubkeys,
        **jf}
    stmt = _statement(input_bytes, out.encode(), meta)

    # ---- child proofs, in tape order --------------------------------------
    proofs = []
    air = Blake2bAir([header], bind="public")
    assert air.digest_bytes_list()[0] == \
        scale.decode_precommit(j.signed_message)[0]
    proofs.append(prove(air, air.build_trace(), config, device=device))
    for pks in (list(j.pubkeys[:j.num_authorities]), new_pubkeys):
        _prove_chain(pks, config, proofs, device=device)
    _prove_justification_children(_justification_stmt(stmt), config, proofs,
                                  device=device)

    # ---- the ONE machine proof --------------------------------------------
    cursor = _ProofCursor(proofs)
    machine_proof = _machine_prove(
        lambda b: _rotate_tape(b, stmt, config, cursor, header,
                               device=device),
        _stmt_prog_key(stmt, config), outer_config, device=device)
    return SuccinctRotateProof(
        input_bytes=input_bytes, output_bytes=out.encode(),
        machine_proof=machine_proof, **{k: meta[k] for k in _META})


def verify_rotate_succinct(proof: SuccinctRotateProof,
                           max_authorities: int = 300,
                           config: StarkConfig = StarkConfig(),
                           outer_config: StarkConfig | None = None, *,
                           device) -> bool:
    """ONE STARK verification on `device` against (input, output) — the
    verifier never sees a header byte, hashes a message, or checks a
    signature."""
    outer_config = outer_config or config
    p = proof
    try:
        inp = RotateInput.decode(p.input_bytes)
        RotateOutput.decode(p.output_bytes)
    except Exception:
        return False
    if p.num_authorities > max_authorities:
        return False
    if not _justification_ok(p, None, p.epoch_end_block,
                             inp.authority_set_id, p.just_num_authorities):
        return False
    try:
        stmt = _statement(p.input_bytes, p.output_bytes,
                          {k: getattr(p, k) for k in _META})
        key = _stmt_prog_key(stmt, config)
    except Exception:
        return False
    return _machine_verify(
        lambda b: _rotate_tape(b, stmt, config, _ProofCursor(None), None,
                               device=device),
        key, p.machine_proof, outer_config, device=device)

"""FRI low-degree proofs over the Goldilocks quadratic extension.

Port of `vectorx_tpu.fri.fri`: the prover's fold and commit layers run on
the device of the codeword (one fold, one batched Poseidon tree per
layer); the verifier is host-side scalar math (queries x layers is tiny).
`fold_and_commit` is the one fold-and-commit loop: the standalone
`fri_prove` and the STARK prover (`stark.prover`, with a `domain` that
lays the codeword out over one device or over ranks) both run it.

Protocol (arity-2 folds):
* codeword = evaluations of a degree < n polynomial on the coset g·K,
  |K| = n << rate_bits, natural order (position i <-> g·w^i).
* Commit: Merkle-cap tree over pair-leaves (v[i], v[i + N/2]).
* Fold with challenge β:  v'[i] = (v[i]+v[i+N/2])/2 + β·(v[i]−v[i+N/2])/(2·x_i).
* Stop at `final_poly_len` coefficients, sent in the clear.
* Queries: indices derived from the transcript; each round opens every fold
  layer and checks fold consistency down to the final polynomial.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from vectorx_tpu_torch import merkle, tracing
from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import extension as ge
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.transcript import Challenger
from vectorx_tpu_torch.hash import poseidon
from vectorx_tpu_torch.merkle import DeviceTree, PoseidonMerkleTree
from vectorx_tpu_torch.ntt import coset_intt
from vectorx_tpu_torch.ntt.ntt import _root_of_unity, device_powers

P = gl.P


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 3
    cap_height: int = 1
    num_queries: int = 28
    final_poly_len: int = 8  # coefficients of the last polynomial
    # 16 grinding bits + 28 queries at rate 1/8 ≈ plonky2's standard-config
    # ~100-bit conjectured security (the reference default).
    pow_bits: int = 16

    def num_fold_layers(self, log_len: int) -> int:
        """Fold-layer count implied by the codeword length: halve until
        `final_poly_len << rate_bits` values remain."""
        assert self.final_poly_len & (self.final_poly_len - 1) == 0
        return log_len - self.rate_bits - self.final_poly_len.bit_length() + 1


@dataclass
class FriQueryStep:
    """Opening of one fold layer at one query: the sibling pair + path."""

    pair: list  # [4 ints] = (c0,c1) at i and i+N/2
    path: list


@dataclass
class FriQueryRound:
    steps: list  # list[FriQueryStep], one per fold layer


@dataclass
class FriProof:
    caps: list           # per fold layer: list of digests (each 4 ints)
    final_coeffs: list   # list of (c0, c1) int pairs
    pow_witness: int
    query_rounds: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# Prover: fold + commit per layer, final coefficients, grind
# ---------------------------------------------------------------------------

def fri_commit_layer(c, cur_log: int, cap_height: int) -> DeviceTree:
    """Commit to an extension codeword's pair-leaves (v[i], v[i+N/2])."""
    c0, c1 = c
    h = c0.shape[0] // 2
    with tracing.span("fri.commit_layer"):
        leaves = torch.stack([c0[:h], c1[:h], c0[h:], c1[h:]], dim=1)
        return DeviceTree(merkle.build_layers(leaves, cap_height), cap_height)


def fri_fold(c, beta, cur_log: int, cur_shift: int):
    """One arity-2 fold: v'[i] = (v[i]+v[i+H])/2 + β·(v[i]−v[i+H])/(2·x_i)."""
    c0, c1 = c
    h = c0.shape[0] // 2
    with tracing.span("fri.fold"):
        return fri_fold_pairs((c0[:h], c1[:h]), (c0[h:], c1[h:]), beta,
                              cur_log, cur_shift, 0)


def fri_fold_pairs(a, b, beta, cur_log: int, cur_shift: int, i0: int):
    """`fri_fold` of the pairs (a, b) = (v[i], v[i+H]) for the leaves
    i = i0, i0 + 1, ...: the next codeword's entries at those i."""
    dev = a[0].device
    w_inv = pow(_root_of_unity(cur_log, inverse=False), P - 2, P)
    inv2x = gl.mul(device_powers(w_inv, a[0].shape[0], dev),
                   pow(w_inv, i0, P) * pow(2 * cur_shift, P - 2, P) % P)
    fo = ge.mul_base(ge.sub(a, b), inv2x)
    fe = ge.mul_base(ge.add(a, b), pow(2, P - 2, P))
    return ge.add(fe, ge.mul(fo, ge.from_pair_u64(*beta, dev)))


def fri_final_coeffs(c, cur_shift: int, final_len: int):
    """Interpolate the last codeword; returns (ok, [(c0, c1)] coeffs) with
    `ok` saying everything above final_len vanishes."""
    with tracing.span("fri.final"):
        f0 = gl.canonicalize(coset_intt(c[0], shift=cur_shift))
        f1 = gl.canonicalize(coset_intt(c[1], shift=cur_shift))
        ok = bool((f0[final_len:] == 0).all()) and \
            bool((f1[final_len:] == 0).all())
        a = gl.to_u64(f0[:final_len])
        b = gl.to_u64(f1[:final_len])
        return ok, [(int(x), int(y)) for x, y in zip(a, b)]


def grind(challenger: Challenger, pow_bits: int, device) -> int:
    """Find a nonce whose transcript response has pow_bits leading zeros,
    2^17 candidates per batched permutation on `device`.  Consumes
    (observe nonce + one challenge) exactly as the verifier replays."""
    with tracing.span("fri.grind"):
        return _grind(challenger, pow_bits, device)


def _grind(challenger: Challenger, pow_bits: int, device) -> int:
    if pow_bits == 0:
        challenger.observe(0)
        challenger.get_challenge()
        return 0
    assert pow_bits <= 32
    k = len(challenger.input_buf)
    base = list(challenger.state)
    base[:k] = challenger.input_buf
    batch = 1 << min(pow_bits + 2, 17)
    st = gl.from_u64(np.array(base, dtype=np.uint64), device)
    start = 0
    while True:
        nonces = torch.arange(start, start + batch, dtype=torch.int64,
                              device=device)
        states = st.expand(batch, poseidon.WIDTH).clone()
        states[:, k] = nonces
        out = gl.canonicalize(poseidon.permute(states)[:, poseidon.RATE - 1])
        hit = ((out >> (64 - pow_bits)) & ((1 << pow_bits) - 1)) == 0
        if bool(hit.any()):
            nonce = start + int(torch.argmax(hit.to(torch.int32)))
            challenger.observe(nonce)
            response = challenger.get_challenge()
            assert (response >> (64 - pow_bits)) == 0
            return nonce
        start += batch
        assert start < (1 << 32), "grind exhausted 32-bit nonce space"


def spill_codeword(c) -> tuple:
    """FRI codeword (c0, c1) device tensors -> canonical host (c0, c1)
    uint64 numpy arrays."""
    return gl.to_u64(c[0]), gl.to_u64(c[1])


class LocalFri:
    """The hooks of `fold_and_commit` with the whole codeword on one
    device.  `stark.stages.LocalDomain` extends them with the STARK
    prover's other stages; `parallel.sharded_prove.ShardedDomain` splits
    the codeword's points over ranks behind the same hooks."""

    def fri_commit(self, c, cur_log: int, cap_height: int):
        """(layer, tree) of an FRI codeword over this layout's points:
        `layer` is what `fri_fold` and the openings read."""
        return c, fri_commit_layer(c, cur_log, cap_height)

    def fri_fold(self, layer, beta, cur_log: int, cur_shift: int):
        return fri_fold(layer, beta, cur_log, cur_shift)

    def fri_final(self, c, cur_log: int, cur_shift: int, final_len: int):
        return fri_final_coeffs(c, cur_shift, final_len)

    def grind(self, challenger, pow_bits: int, device) -> int:
        return grind(challenger, pow_bits, device)


LOCAL = LocalFri()


def fold_and_commit(c, log_len: int, shift: int, config: FriConfig,
                    challenger: Challenger, *, spill: bool = False,
                    domain: LocalFri = LOCAL):
    """Commit, observe and fold layer by layer down to the final
    polynomial, then interpolate it and grind.  Returns (FriProof without
    query rounds, [(codeword, tree)] per fold layer): `domain`'s layers and
    trees (device codewords and DeviceTrees on one device), or with
    `spill` host uint64 codewords and PoseidonMerkleTrees, each moved off
    the device once, as its layer is committed.

    A codeword over the degree bound raises AssertionError."""
    layers = []
    caps = []
    n = 1 << log_len
    cur_shift = shift
    cur_log = log_len
    device = c[0].device
    while n > config.final_poly_len << config.rate_bits:
        layer, tree = domain.fri_commit(
            c, cur_log, min(config.cap_height, cur_log - 1))
        if spill:
            tree = PoseidonMerkleTree.from_device(tree)
        cap = tree.cap_ints()
        caps.append(cap)
        challenger.observe_cap(cap)
        beta = challenger.get_extension_challenge()
        c = domain.fri_fold(layer, beta, cur_log, cur_shift)
        layers.append((spill_codeword(layer) if spill else layer, tree))
        cur_shift = (cur_shift * cur_shift) % P
        cur_log -= 1
        n >>= 1
    ok, final_coeffs = domain.fri_final(c, cur_log, cur_shift,
                                        config.final_poly_len)
    assert ok, "FRI input codeword exceeds the claimed degree bound"
    for (a, b) in final_coeffs:
        challenger.observe(a)
        challenger.observe(b)
    pow_witness = domain.grind(challenger, config.pow_bits, device)
    proof = FriProof(caps=caps, final_coeffs=final_coeffs,
                     pow_witness=pow_witness)
    return proof, layers


def fri_prove(codeword, log_len: int, shift: int, config: FriConfig,
              challenger: Challenger):
    """Prove low degree of an extension codeword (c0, c1) of length
    2^log_len on the coset shift·K, on the codeword's device.  Returns
    (FriProof without query rounds, fold layer trees, fold codewords as
    host (c0, c1) uint64 arrays, the input's first): the caller assembles
    the query rounds after deriving the indices."""
    proof, layers = fold_and_commit(codeword, log_len, shift, config,
                                    challenger, spill=True)
    return proof, [t for _, t in layers], [c for c, _ in layers]


def prove_low_degree(codeword, log_len: int, shift: int, config: FriConfig,
                     challenger: Challenger) -> FriProof:
    """Standalone prove: fold layers + self-contained query rounds."""
    proof, layers, codewords = fri_prove(codeword, log_len, shift, config,
                                         challenger)
    indices = derive_query_indices(challenger, log_len, config.num_queries)
    proof.query_rounds = [open_query(layers, codewords, i) for i in indices]
    return proof


def open_query(layers, codewords, index: int) -> FriQueryRound:
    """Assemble one query round: per fold layer, the committed pair + path.
    `codewords` holds host (c0, c1) uint64 arrays per layer."""
    steps = []
    idx = index
    for tree, (c0, c1) in zip(layers, codewords):
        h = len(c0) // 2
        i = idx % h
        # leaf layout: [c0(i), c1(i), c0(i+h), c1(i+h)]
        leaf = [int(c0[i]), int(c1[i]), int(c0[i + h]), int(c1[i + h])]
        steps.append(FriQueryStep(pair=leaf, path=tree.open(i)))
        idx = i
    return FriQueryRound(steps=steps)


# ---------------------------------------------------------------------------
# Verifier: transcript replay and query checks (host)
# ---------------------------------------------------------------------------

def derive_query_indices(challenger: Challenger, log_len: int, num: int):
    return [challenger.get_challenge() % (1 << log_len) for _ in range(num)]


def fri_replay(proof: FriProof, log_len: int, config: FriConfig,
               challenger: Challenger):
    """Replay the FRI transcript.  Returns (betas, indices) or None if the
    proof shape mismatches the config or the proof-of-work response fails.

    The shape checks are soundness-critical: without them a prover could
    send zero fold layers and the full interpolation of an arbitrary
    high-degree codeword as `final_coeffs`, voiding the low-degree bound
    (plonky2's verifier performs the same validation)."""
    if len(proof.final_coeffs) != config.final_poly_len:
        return None
    if len(proof.caps) != config.num_fold_layers(log_len):
        return None
    for layer_i, cap in enumerate(proof.caps):
        # fold layer i commits pair-leaves of the 2^(log_len-i) codeword:
        # a tree over 2^(log_len-i-1) leaves with the configured cap
        if len(cap) != 1 << min(config.cap_height, log_len - layer_i - 1):
            return None
    betas = []
    for cap in proof.caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    for (a, b) in proof.final_coeffs:
        challenger.observe(a)
        challenger.observe(b)
    challenger.observe(proof.pow_witness)
    pow_response = challenger.get_challenge()
    if config.pow_bits > 0 and (pow_response >> (64 - config.pow_bits)) != 0:
        return None
    indices = derive_query_indices(challenger, log_len, config.num_queries)
    return betas, indices


def fri_check_queries(proof: FriProof, betas, indices, log_len: int,
                      shift: int, config: FriConfig,
                      query_values=None) -> bool:
    """Check all query rounds against the fold layers and final polynomial.

    `query_values`: optional list (one per query) of the claimed codeword
    value (ext pair) at the query position in the *input* codeword; when the
    caller derives those from its own commitment openings (the STARK batch
    opening), pass them to bind FRI to the outer protocol.  If None, the
    value committed in the first fold layer is used as-is.
    """
    if len(proof.query_rounds) != config.num_queries:
        return False
    if len(indices) != len(proof.query_rounds):
        return False
    for round_ in proof.query_rounds:
        if len(round_.steps) != len(proof.caps):
            return False

    # ---- Merkle paths: ALL fold layers' walks fused into one batched
    # diagonal pass (fold arithmetic stays scalar)
    groups = []
    layer_idx = list(indices)
    cur_log = log_len
    for layer_i in range(len(proof.caps)):
        h = 1 << (cur_log - 1)
        layer_idx = [ix % h for ix in layer_idx]
        groups.append((
            [r.steps[layer_i].pair for r in proof.query_rounds],
            list(layer_idx),
            [r.steps[layer_i].path for r in proof.query_rounds],
            proof.caps[layer_i], h))
        cur_log -= 1
    if not merkle.verify_paths_jagged(groups):
        return False

    w0 = _root_of_unity(log_len, inverse=False)
    for qi, (index, round_) in enumerate(zip(indices, proof.query_rounds)):
        idx = index
        cur_log = log_len
        cur_shift = shift
        w = w0
        value = None  # expected value at position idx of current layer
        if query_values is not None:
            value = query_values[qi]
        for layer_i, step in enumerate(round_.steps):
            h = 1 << (cur_log - 1)
            i = idx % h
            leaf = step.pair
            v_lo = (leaf[0], leaf[1])
            v_hi = (leaf[2], leaf[3])
            committed = v_lo if idx < h else v_hi
            if value is not None and committed != tuple(
                    x % P for x in value):
                return False
            # fold
            beta = betas[layer_i]
            x_i = (cur_shift * pow(w, i, P)) % P
            s = ext_py.add(v_lo, v_hi)
            d = ext_py.sub(v_lo, v_hi)
            inv2x = pow(2 * x_i, P - 2, P)
            fo = ext_py.mul(d, ext_py.from_base(inv2x))
            fe = ext_py.mul(s, ext_py.from_base(pow(2, P - 2, P)))
            value = ext_py.add(fe, ext_py.mul(beta, fo))
            idx = i
            cur_log -= 1
            cur_shift = (cur_shift * cur_shift) % P
            w = (w * w) % P
        # check against final polynomial
        x = (cur_shift * pow(w, idx, P)) % P
        final_val = ext_py.horner(proof.final_coeffs, ext_py.from_base(x))
        if final_val != value:
            return False
    return True



def fri_verify(proof: FriProof, log_len: int, shift: int, config: FriConfig,
               challenger: Challenger, query_values=None) -> bool:
    """Verify a standalone FRI proof (replay + query checks)."""
    replay = fri_replay(proof, log_len, config, challenger)
    if replay is None:
        return False
    betas, indices = replay
    return fri_check_queries(proof, betas, indices, log_len, shift, config,
                             query_values)

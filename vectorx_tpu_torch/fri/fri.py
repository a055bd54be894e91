"""FRI low-degree proofs over the Goldilocks quadratic extension — the
configuration, the proof objects, and the verifier's side (transcript replay
and query checks).  Port of `vectorx_tpu.fri.fri`; the prover's fold and
commit layers are `vectorx_tpu_torch.stark.stages.fri_fold` /
`fri_commit_layer`.

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

from vectorx_tpu_torch import merkle
from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.transcript import Challenger
from vectorx_tpu_torch.ntt.ntt import _root_of_unity

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


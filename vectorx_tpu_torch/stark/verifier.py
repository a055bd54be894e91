"""STARK verifier — host-side scalar math (transcript replay, one
constraint check at ζ, and per-query Merkle + DEEP + FRI consistency).

Port of `vectorx_tpu.stark.verifier`: everything the prover observed is
re-derived and every committed value the proof relies on is opened and
checked.  The only device work is deriving the verification key (the cap
of the constant columns' commitment, `stark.vk.constants_cap`) on the
`device` the caller names; the rest is host code.
"""

from __future__ import annotations

from vectorx_tpu_torch import merkle, tracing
from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import fri_check_queries, fri_replay
from vectorx_tpu_torch.fri.transcript import Challenger
from vectorx_tpu_torch.ntt.ntt import _root_of_unity
from vectorx_tpu_torch.stark.air import (NUM_LOOKUP_SETS, Air, ExtAlgebra,
                                         bus_aux_layout, bus_transitions,
                                         lookup_boundaries, lookup_transitions)
from vectorx_tpu_torch.stark.prover import (StarkConfig, StarkProof,
                                            _num_quotient_chunks)

P = gl.P


def verify(air: Air, proof: StarkProof,
           config: StarkConfig = StarkConfig(),
           preprocessed=None, *, device) -> bool:
    """Accept or reject `proof`.  `device` is where the verification key is
    derived when `preprocessed` is not given."""
    with tracing.span("stark.verify", rows=air.n, width=air.width) as sp:
        return _verify(air, proof, config, preprocessed, device, sp)


def _verify(air: Air, proof: StarkProof, config: StarkConfig, preprocessed,
            device, sp) -> bool:
    """`verify`'s body; `sp` is its span, which opens a stage span for the
    FRI transcript's replay and one for the query checks."""
    from vectorx_tpu_torch.stark.vk import constants_cap

    n = air.n
    W = air.width
    chunks = _num_quotient_chunks(air)
    blowup = 1 << config.rate_bits
    N = n * blowup
    log_N = air.log_n + config.rate_bits
    public = air.public_inputs()
    K = air.num_constants()

    challenger = Challenger()
    challenger.observe_many(public)
    const_cap = None
    if K:
        # the preprocessed commitment is the verifier's own "verification
        # key" — derived from the AIR, never taken from the proof.  Only
        # the CAP is needed (openings carry their own paths); it comes
        # from the content-addressed VK cache (stark/vk.py).
        const_cap = preprocessed[0].cap_ints() if preprocessed else \
            constants_cap(air, config, device=device)
        challenger.observe_cap(const_cap)
    challenger.observe_cap(proof.trace_cap)
    lookups = air.lookups()
    ports = air.bus_ports()
    _, _, A = bus_aux_layout(air)
    betas: list[int] = []
    deltas: list[int] = []
    if lookups or ports:
        betas = challenger.get_n_challenges(NUM_LOOKUP_SETS)
        if ports:
            deltas = challenger.get_n_challenges(NUM_LOOKUP_SETS)
        challenger.observe_cap(proof.aux_cap)
    alpha = challenger.get_extension_challenge()
    challenger.observe_cap(proof.quotient_cap)
    zeta = challenger.get_extension_challenge()
    if len(proof.trace_at_zeta) != W or len(proof.trace_at_zeta_next) != W \
            or len(proof.quotient_at_zeta) != chunks \
            or len(proof.constants_at_zeta) != K \
            or len(proof.aux_at_zeta) != A \
            or len(proof.aux_at_zeta_next) != A:
        return False
    for pair in (*proof.trace_at_zeta, *proof.trace_at_zeta_next,
                 *proof.aux_at_zeta, *proof.aux_at_zeta_next,
                 *proof.constants_at_zeta, *proof.quotient_at_zeta):
        challenger.observe(pair[0])
        challenger.observe(pair[1])
    gamma = challenger.get_extension_challenge()

    # ---- constraint identity at ζ ----------------------------------------
    w = _root_of_unity(air.log_n, inverse=False)
    x_last = pow(w, n - 1, P)
    zh_zeta = ext_py.sub(ext_py.exp(zeta, n), ext_py.ONE)
    if zh_zeta == ext_py.ZERO:
        return False  # ζ degenerately landed in the subgroup

    local = list(proof.trace_at_zeta)
    nxt = list(proof.trace_at_zeta_next)
    consts = list(proof.constants_at_zeta) if K else None
    transition_vals = list(air.transition(ExtAlgebra, local, nxt, public,
                                          consts))
    if lookups:
        transition_vals += lookup_transitions(
            ExtAlgebra, local, nxt, list(proof.aux_at_zeta),
            list(proof.aux_at_zeta_next), consts, betas, lookups)
    if ports:
        transition_vals += bus_transitions(
            ExtAlgebra, local, nxt, list(proof.aux_at_zeta),
            list(proof.aux_at_zeta_next), consts, betas, deltas, air)

    acc = ext_py.ZERO
    a_pow = ext_py.ONE
    mask = ext_py.sub(zeta, ext_py.from_base(x_last))
    for t in transition_vals:
        acc = ext_py.add(acc, ext_py.mul(a_pow, ext_py.mul(t, mask)))
        a_pow = ext_py.mul(a_pow, alpha)
    all_at_zeta = local + list(proof.aux_at_zeta)
    boundaries = list(air.boundaries(public)) + \
        (lookup_boundaries(air) if (lookups or ports) else [])
    for (row, col, value) in boundaries:
        x_r = pow(w, row, P)
        diff = ext_py.sub(all_at_zeta[col], ext_py.from_base(value))
        den_inv = ext_py.inv(ext_py.sub(zeta, ext_py.from_base(x_r)))
        term = ext_py.mul(ext_py.mul(diff, zh_zeta), den_inv)
        acc = ext_py.add(acc, ext_py.mul(a_pow, term))
        a_pow = ext_py.mul(a_pow, alpha)

    # Q(ζ) = Σ ζ^{k·n} Q_k(ζ)
    q_zeta = ext_py.ZERO
    z_n = ext_py.exp(zeta, n)
    z_pow = ext_py.ONE
    for k in range(chunks):
        q_zeta = ext_py.add(q_zeta, ext_py.mul(z_pow, proof.quotient_at_zeta[k]))
        z_pow = ext_py.mul(z_pow, z_n)
    if acc != ext_py.mul(q_zeta, zh_zeta):
        return False

    # ---- FRI replay + DEEP query checks ----------------------------------
    sp.stage("verify.fri_replay")
    replay = fri_replay(proof.fri_proof, log_N, config.fri, challenger)
    if replay is None:
        return False
    sp.stage("verify.queries")
    betas, indices = replay
    if len(proof.trace_openings) != len(indices) or \
            len(proof.quotient_openings) != len(indices):
        return False

    if K and len(proof.constants_openings) != len(indices):
        return False
    if (lookups or ports) and len(proof.aux_openings) != len(indices):
        return False
    w8 = _root_of_unity(log_N, inverse=False)
    w_zeta = ext_py.mul(zeta, ext_py.from_base(w))
    # ---- Merkle openings, batched per tree across all queries ------------
    for t_open in proof.trace_openings:
        if len(t_open.leaf) != W:
            return False
    for q_open in proof.quotient_openings:
        if len(q_open.leaf) != 2 * chunks:
            return False
    groups = [(proof.trace_openings, proof.trace_cap),
              (proof.quotient_openings, proof.quotient_cap)]
    if K:
        for c_open in proof.constants_openings:
            if len(c_open.leaf) != K:
                return False
        groups.append((proof.constants_openings, const_cap))
    if lookups or ports:
        for a_open in proof.aux_openings:
            if len(a_open.leaf) != A:
                return False
        groups.append((proof.aux_openings, proof.aux_cap))
    if not merkle.verify_paths_multi(
            [([o.leaf for o in opens], [o.path for o in opens], cap)
             for opens, cap in groups], list(indices), num_leaves=N):
        return False
    query_values = []
    for qi, (q, t_open, q_open) in enumerate(zip(
            indices, proof.trace_openings, proof.quotient_openings)):
        c_open = proof.constants_openings[qi] if K else None
        a_open = proof.aux_openings[qi] if (lookups or ports) else None
        x_q = (gl.GENERATOR * pow(w8, q, P)) % P
        inv_xz = ext_py.inv(ext_py.sub(ext_py.from_base(x_q), zeta))
        inv_xwz = ext_py.inv(ext_py.sub(ext_py.from_base(x_q), w_zeta))
        val = ext_py.ZERO
        g_pow = ext_py.ONE
        for j in range(W):
            diff = ext_py.sub(ext_py.from_base(t_open.leaf[j]),
                              proof.trace_at_zeta[j])
            val = ext_py.add(val, ext_py.mul(g_pow,
                                             ext_py.mul(diff, inv_xz)))
            g_pow = ext_py.mul(g_pow, gamma)
        for j in range(W):
            diff = ext_py.sub(ext_py.from_base(t_open.leaf[j]),
                              proof.trace_at_zeta_next[j])
            val = ext_py.add(val, ext_py.mul(g_pow,
                                             ext_py.mul(diff, inv_xwz)))
            g_pow = ext_py.mul(g_pow, gamma)
        for a in range(A):
            diff = ext_py.sub(ext_py.from_base(a_open.leaf[a]),
                              proof.aux_at_zeta[a])
            val = ext_py.add(val, ext_py.mul(g_pow,
                                             ext_py.mul(diff, inv_xz)))
            g_pow = ext_py.mul(g_pow, gamma)
        for a in range(A):
            diff = ext_py.sub(ext_py.from_base(a_open.leaf[a]),
                              proof.aux_at_zeta_next[a])
            val = ext_py.add(val, ext_py.mul(g_pow,
                                             ext_py.mul(diff, inv_xwz)))
            g_pow = ext_py.mul(g_pow, gamma)
        for k in range(K):
            diff = ext_py.sub(ext_py.from_base(c_open.leaf[k]),
                              proof.constants_at_zeta[k])
            val = ext_py.add(val, ext_py.mul(g_pow,
                                             ext_py.mul(diff, inv_xz)))
            g_pow = ext_py.mul(g_pow, gamma)
        for k in range(chunks):
            qk = (q_open.leaf[2 * k], q_open.leaf[2 * k + 1])
            diff = ext_py.sub(qk, proof.quotient_at_zeta[k])
            val = ext_py.add(val, ext_py.mul(g_pow,
                                             ext_py.mul(diff, inv_xz)))
            g_pow = ext_py.mul(g_pow, gamma)
        query_values.append(val)

    return fri_check_queries(proof.fri_proof, betas, indices, log_N,
                             gl.GENERATOR, config.fri, query_values)

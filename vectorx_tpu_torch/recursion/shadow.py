"""Shadow verifier: replays `stark.verifier.verify` onto an ssa.Builder
tape — the program the verifier-VM AIR (machine.py) executes.  Port of
`vectorx_tpu.recursion.shadow`: host Python, apart from deriving a child's
verification key (`stark.vk.constants_cap`) on the caller's `device`.

The tape structure is a pure function of (child AIR statement, config):
prover and verifier build identical tapes; a concrete StarkProof binds the
FRESH values (witness mode) and every host-verifier rejection surfaces as
a TapeCheckFailed at the matching assertion.  Mirrors
stark/verifier.py line-for-line in program order — transcript
replay, constraint identity at ζ (running the child's own `transition`
against the tape algebra), FRI replay, and per-query Merkle + DEEP + fold
checks (fri.py:258-314).

This is the role plonky2x's recursive proof verification plays inside
reduce circuits (/root/reference/circuits/builder/subchain_verification.rs:233-289),
re-architected so many child verifications batch into one wide trace."""

from __future__ import annotations

from vectorx_tpu_torch.field import ext_py
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.hash.poseidon import DIGEST, RATE
from vectorx_tpu_torch.ntt.ntt import _root_of_unity
from vectorx_tpu_torch.stark.air import (NUM_LOOKUP_SETS, bus_aux_layout,
                                   bus_transitions, lookup_boundaries,
                                   lookup_transitions)
from vectorx_tpu_torch.stark.prover import _num_quotient_chunks, preprocess
from vectorx_tpu_torch.recursion.ssa import Affine, BitRef, Builder

P = gl.P
EXT_X = (0, 1)           # the extension generator: pair (a, b) = a + b·x


class TapeAlgebra:
    """`Air.transition`-compatible algebra over tape handles.  Challenges
    arrive as Affine handles; plain ints are statement constants."""

    def __init__(self, b: Builder):
        self.b = b

    def add(self, x, y):
        return self.b.add(x, y)

    def sub(self, x, y):
        return self.b.sub(x, y)

    def mul(self, x, y):
        return self.b.mul(x, y)

    def constant(self, v):
        if isinstance(v, Affine):
            return v
        return Affine(const=(v % P, 0))


class TapeChallenger:
    """Mirror of fri.transcript.Challenger over tape handles."""

    def __init__(self, b: Builder):
        self.b = b
        self.input_buf: list = []
        self.output_buf: list = []
        self.prev = -1
        self.started = False

    def observe(self, h):
        self.output_buf = []
        self.input_buf.append(Affine.of(h))
        if len(self.input_buf) == RATE:
            self._duplex()

    def observe_int(self, v: int):
        self.observe(self.b.const_value(v))

    def observe_fresh(self, value, tag):
        h = self.b.fresh(value, tag)
        self.observe(h)
        return h

    def _duplex(self):
        self.prev, outs = self.b.duplex(self.input_buf,
                                        keep_state=self.started,
                                        prev=self.prev)
        self.started = True
        self.input_buf = []
        self.output_buf = outs[:RATE]

    def get_challenge(self):
        if self.input_buf or not self.output_buf:
            self._duplex()
        return self.output_buf.pop()

    def get_n(self, n):
        return [self.get_challenge() for _ in range(n)]

    def get_ext(self):
        c0 = self.get_challenge()
        c1 = self.get_challenge()
        return self.b.fma(c1, Affine(const=EXT_X), c0)


def _pair(b: Builder, c0, c1):
    """Assemble an extension value from two base handles."""
    return b.fma(c1, Affine(const=EXT_X), c0)


def _hash_leaf(b: Builder, ch_prev, leaf_handles):
    """hash_or_noop: ≤4 elements pass through (zero-padded); longer leaves
    run the rate-8 sponge (poseidon_py.hash_no_pad)."""
    if len(leaf_handles) <= DIGEST:
        zero = Affine(const=ext_py.ZERO)
        return list(leaf_handles) + [zero] * (DIGEST - len(leaf_handles))
    prev = -1
    outs = None
    for start in range(0, len(leaf_handles), RATE):
        chunk = leaf_handles[start:start + RATE]
        prev, outs = b.duplex(chunk, keep_state=prev >= 0, prev=prev)
    return outs[:DIGEST]


def _merkle_walk(b: Builder, digest, bits, levels, sib_values, tag):
    """Chain `levels` two_to_one steps; direction at level l is bits[l].
    sib_values: per level the 4 sibling ints (witness mode) or None."""
    for lvl in range(levels):
        sibs = [b.fresh(sib_values[lvl][j] if sib_values else None,
                        f"{tag}:sib{lvl}.{j}") for j in range(DIGEST)]
        bit = Affine.of(bits[lvl])
        left, right = [], []
        for j in range(DIGEST):
            d, s = digest[j], sibs[j]
            sd = b.materialize(b.sub(s, d))           # shared s−d slot
            l_ = b.fma(bit, sd, d)                    # bit ? sib : dig
            r_ = b.fma(bit, sd.scaled(P - 1), s)      # the other one
            left.append(l_)
            right.append(r_)
        _, outs = b.duplex(left + right, keep_state=False, prev=-1)
        digest = outs[:DIGEST]
    return digest


def _select_cap(b: Builder, cap_handles, bits_hi):
    """Mux a cap entry (list of 4 handles per entry) by the high index
    bits — a log-depth mux tree."""
    entries = list(cap_handles)
    for bit in bits_hi:
        bit = Affine.of(bit)
        nxt = []
        for k in range(0, len(entries), 2):
            lo, hi = entries[k], entries[k + 1]
            nxt.append([b.fma(bit, b.sub(h, l), l)
                        for l, h in zip(lo, hi)])
        entries = nxt
    assert len(entries) == 1
    return entries[0]


def _tape_pow(b: Builder, base, e: int):
    """base^e on the tape by square-and-multiply (≈2·log e rows)."""
    if e == 0:
        return Affine(const=ext_py.ONE)
    acc = None
    sq = base
    while e:
        if e & 1:
            acc = sq if acc is None else b.mul(acc, sq)
        e >>= 1
        if e:
            sq = b.mul(sq, sq)
    return acc


def _horner(b: Builder, terms, x):
    """Σ x^i·terms[i] with ONE fma row per term (vs mul+mul+add)."""
    if not terms:
        return Affine(const=ext_py.ZERO)
    acc = terms[-1]
    for t in reversed(terms[:-1]):
        acc = b.fma(acc, x, t)
    return acc


def _pow_chain(b: Builder, base_pows, bits, start_const):
    """shift·w^(Σ bits·2^i) = start · Π (1 + b_i·(w^{2^i} − 1)) as a chain
    of bit-gated muls.  base_pows[i] = w^(2^i) as ints."""
    acc = Affine(const=(start_const % P, 0))
    for i, bit in enumerate(bits):
        f = b.fma(Affine.of(bit),
                  Affine(const=((base_pows[i] - 1) % P, 0)),
                  Affine(const=ext_py.ONE))
        acc = b.mul(acc, f)
    return acc


def verifier_tape(b: Builder, air, config, proof=None, public_offset=0,
                  preprocessed=None, public_handles=None, *, device):
    """Replay the verification of `proof` (of child `air` under `config`)
    onto tape `b`.  Statement mode when proof is None.  Returns the number
    of public inputs consumed (child publics are exposed as tape publics
    starting at `public_offset`).

    `public_handles`: optional list parallel to the child's publics; a
    non-None entry is an existing tape handle WIRED in place of that
    public — it is absorbed into the child transcript and drives the
    child's boundary constraints, but never surfaces as a machine public.
    This is how aggregation hides intermediate values (e.g. one child's
    output feeding another's input) while the child proofs still bind to
    them: a proof for different values diverges at the transcript.
    Wired entries do not consume machine public indices.  `device` is
    where a child's verification key is derived on a cache miss."""
    n = air.n
    W = air.width
    chunks = _num_quotient_chunks(air)
    blowup = 1 << config.rate_bits
    N = n * blowup
    log_N = air.log_n + config.rate_bits
    public = air.public_inputs()
    K = air.num_constants()
    lookups = air.lookups()
    ports = air.bus_ports()
    _, _, A = bus_aux_layout(air)
    cap_h = config.fri.cap_height
    cap_len = 1 << cap_h
    fri = config.fri

    def fresh(value_fn, tag):
        return b.fresh(value_fn() if proof is not None else None, tag)

    ch = TapeChallenger(b)

    # ---- transcript: publics + caps --------------------------------------
    pub_handles = []
    n_exposed = 0
    for i, v in enumerate(public):
        wired = public_handles[i] if public_handles else None
        if wired is not None:
            h = b.materialize(Affine.of(wired))
        else:
            h = b.public(int(v) % P, public_offset + n_exposed)
            n_exposed += 1
        pub_handles.append(h)
        ch.observe(h)
    const_cap = None
    if K:
        # the preprocessed commitment is derived from the AIR — program
        # constants, never proof data (verifier.py:39-46).  Only the cap
        # is needed; it comes from the content-addressed VK cache unless
        # the caller passes a preprocess() result.
        if preprocessed is not None:
            const_cap = preprocessed[0].cap_ints()
        else:
            from vectorx_tpu_torch.stark.vk import constants_cap

            const_cap = constants_cap(air, config, device=device)
        for d in const_cap:
            for v in d:
                ch.observe_int(int(v))
    trace_cap = [[ch.observe_fresh(
        int(proof.trace_cap[i][j]) if proof else None, f"tcap{i}.{j}")
        for j in range(DIGEST)] for i in range(cap_len)]
    betas = []
    deltas = []
    aux_cap = []
    if lookups or ports:
        betas = ch.get_n(NUM_LOOKUP_SETS)
        if ports:
            deltas = ch.get_n(NUM_LOOKUP_SETS)
        aux_cap = [[ch.observe_fresh(
            int(proof.aux_cap[i][j]) if proof else None, f"acap{i}.{j}")
            for j in range(DIGEST)] for i in range(cap_len)]
    alpha = ch.get_ext()
    quot_cap = [[ch.observe_fresh(
        int(proof.quotient_cap[i][j]) if proof else None, f"qcap{i}.{j}")
        for j in range(DIGEST)] for i in range(cap_len)]
    zeta = ch.get_ext()

    # ---- openings at ζ ----------------------------------------------------
    def open_block(count, get, tag):
        comps = []
        for i in range(count):
            c0 = fresh((lambda i=i: int(get(i)[0])), f"{tag}{i}.0")
            c1 = fresh((lambda i=i: int(get(i)[1])), f"{tag}{i}.1")
            comps.append((c0, c1))
        return comps

    tz_c = open_block(W, lambda i: proof.trace_at_zeta[i], "tz")
    tzn_c = open_block(W, lambda i: proof.trace_at_zeta_next[i], "tzn")
    az_c = open_block(A, lambda i: proof.aux_at_zeta[i], "az")
    azn_c = open_block(A, lambda i: proof.aux_at_zeta_next[i], "azn")
    kz_c = open_block(K, lambda i: proof.constants_at_zeta[i], "kz")
    qz_c = open_block(chunks, lambda i: proof.quotient_at_zeta[i], "qz")
    for block in (tz_c, tzn_c, az_c, azn_c, kz_c, qz_c):
        for (c0, c1) in block:
            ch.observe(c0)
            ch.observe(c1)
    gamma = ch.get_ext()
    tz = [_pair(b, c0, c1) for (c0, c1) in tz_c]
    tzn = [_pair(b, c0, c1) for (c0, c1) in tzn_c]
    az = [_pair(b, c0, c1) for (c0, c1) in az_c]
    azn = [_pair(b, c0, c1) for (c0, c1) in azn_c]
    kz = [_pair(b, c0, c1) for (c0, c1) in kz_c]
    qz = [_pair(b, c0, c1) for (c0, c1) in qz_c]

    # ---- constraint identity at ζ (verifier.py:70-112) -------------------
    ret_publics = n_exposed
    w = _root_of_unity(air.log_n, inverse=False)
    x_last = pow(w, n - 1, P)
    z_n = zeta
    for _ in range(air.log_n):           # ζ^n by squaring
        z_n = b.mul(z_n, z_n)
    zh_zeta = b.sub(z_n, Affine(const=ext_py.ONE))
    # ζ must not land in the subgroup: witnessed inverse proves zh ≠ 0
    b.inverse(zh_zeta, where="zh_nonzero")

    alg = TapeAlgebra(b)
    consts_arg = kz if K else None
    tvals = list(air.transition(alg, list(tz), list(tzn), pub_handles,
                                consts_arg))
    if lookups:
        tvals += lookup_transitions(alg, list(tz), list(tzn), list(az),
                                    list(azn), consts_arg, betas, lookups)
    if ports:
        tvals += bus_transitions(alg, list(tz), list(tzn), list(az),
                                 list(azn), consts_arg, betas, deltas, air)

    mask = b.sub(zeta, Affine(const=(x_last, 0)))
    terms = [b.mul(t, mask) for t in tvals]
    all_at_zeta = tz + az
    boundaries = list(air.boundaries(pub_handles)) + \
        (lookup_boundaries(air) if (lookups or ports) else [])
    for (row, col, value) in boundaries:
        x_r = pow(w, row, P)
        v = value if isinstance(value, (Affine, BitRef)) \
            else Affine(const=(int(value) % P, 0))
        diff = b.sub(all_at_zeta[col], v)
        den_inv = b.inverse(b.sub(zeta, Affine(const=(x_r, 0))),
                            where=f"bnd{row}.{col}")
        terms.append(b.mul(b.mul(diff, zh_zeta), den_inv))
    acc = _horner(b, terms, alpha)

    q_zeta = _horner(b, qz, z_n)
    b.assert_zero(q_zeta, zh_zeta, acc.scaled(P - 1), where="zeta_identity")

    # ---- FRI replay (fri.py:225-255) -------------------------------------
    n_layers = fri.num_fold_layers(log_N)
    layer_caps = []
    fri_betas = []
    for li in range(n_layers):
        cl = 1 << min(fri.cap_height, log_N - li - 1)
        cap = [[ch.observe_fresh(
            int(proof.fri_proof.caps[li][i][j]) if proof else None,
            f"fcap{li}.{i}.{j}") for j in range(DIGEST)]
            for i in range(cl)]
        layer_caps.append(cap)
        fri_betas.append(ch.get_ext())
    final_coeffs = []
    for i in range(fri.final_poly_len):
        c0 = ch.observe_fresh(
            int(proof.fri_proof.final_coeffs[i][0]) if proof else None,
            f"fc{i}.0")
        c1 = ch.observe_fresh(
            int(proof.fri_proof.final_coeffs[i][1]) if proof else None,
            f"fc{i}.1")
        final_coeffs.append(_pair(b, c0, c1))
    ch.observe_fresh(int(proof.fri_proof.pow_witness) if proof else None,
                     "pow_witness")
    pow_resp = ch.get_challenge()
    if fri.pow_bits > 0:
        # decomposing into 64−pow_bits bits asserts the top bits are zero
        b.bitdec(pow_resp, 64 - fri.pow_bits, canonical=False)
    idx_challenges = ch.get_n(fri.num_queries)

    # ---- per-query checks (verifier.py:127-193 + fri.py:258-314) ---------
    w_zeta = b.mul(zeta, Affine(const=(w, 0)))
    w_pows = [pow(_root_of_unity(log_N, inverse=False), 1 << i, P)
              for i in range(log_N)]
    # γ^offset for each contiguous DEEP block, hoisted out of the queries
    block_offs = [0, W, 2 * W, 2 * W + A, 2 * W + 2 * A, 2 * W + 2 * A + K]
    g_offs = [_tape_pow(b, gamma, e) for e in block_offs]

    for qi in range(fri.num_queries):
        bits = b.bitdec(idx_challenges[qi], 64, canonical=True)
        ibits = bits[:log_N]

        def tree_open(count, cap, get_leaf, get_path, levels_height, tag):
            """Open + walk one committed tree at this query; returns leaf
            handles."""
            leaf = [fresh((lambda j=j: int(get_leaf(j))), f"{tag}.l{j}")
                    for j in range(count)]
            digest = _hash_leaf(b, -1, leaf)
            levels = levels_height - min(fri.cap_height, levels_height)
            sibs = None
            if proof is not None:
                path = get_path()
                sibs = [[int(x) for x in path[lvl]]
                        for lvl in range(levels)]
            digest = _merkle_walk(b, digest, ibits, levels, sibs, tag)
            want = _select_cap(b, cap, ibits[levels:levels_height])
            for j in range(DIGEST):
                b.assert_eq(digest[j], want[j], where=f"{tag}.cap{j}")
            return leaf

        t_leaf = tree_open(
            W, trace_cap, lambda j: proof.trace_openings[qi].leaf[j],
            lambda: proof.trace_openings[qi].path, log_N, f"q{qi}.t")
        q_leaf = tree_open(
            2 * chunks, quot_cap,
            lambda j: proof.quotient_openings[qi].leaf[j],
            lambda: proof.quotient_openings[qi].path, log_N, f"q{qi}.q")
        k_leaf = []
        if K:
            cap_consts = [[Affine(const=(int(v) % P, 0)) for v in d]
                          for d in const_cap]
            k_leaf = tree_open(
                K, cap_consts,
                lambda j: proof.constants_openings[qi].leaf[j],
                lambda: proof.constants_openings[qi].path, log_N,
                f"q{qi}.k")
        a_leaf = []
        if lookups or ports:
            a_leaf = tree_open(
                A, aux_cap, lambda j: proof.aux_openings[qi].leaf[j],
                lambda: proof.aux_openings[qi].path, log_N, f"q{qi}.a")

        # DEEP combination (verifier.py:152-193): contiguous γ-blocks, each
        # folded by Horner (one fma/term), then scaled by γ^offset·inv_den
        x_q = _pow_chain(b, w_pows, ibits, gl.GENERATOR)
        inv_xz = b.inverse(b.sub(x_q, zeta), where=f"q{qi}.invxz")
        inv_xwz = b.inverse(b.sub(x_q, w_zeta), where=f"q{qi}.invxwz")
        groups = [(t_leaf, tz, inv_xz), (t_leaf, tzn, inv_xwz),
                  (a_leaf, az, inv_xz), (a_leaf, azn, inv_xwz),
                  (k_leaf, kz, inv_xz),
                  ([_pair(b, q_leaf[2 * k], q_leaf[2 * k + 1])
                    for k in range(chunks)], qz, inv_xz)]
        val = Affine(const=ext_py.ZERO)
        for (leaf, opened, invd), g_off in zip(groups, g_offs):
            if not opened:
                continue
            diffs = [b.sub(leaf[j], opened[j]) for j in range(len(opened))]
            h = _horner(b, diffs, gamma)
            val = b.add(val, b.mul(b.mul(h, invd), g_off))

        # FRI fold walk (fri.py:283-313)
        cur_log = log_N
        cur_shift = gl.GENERATOR
        layer_w_pows = list(w_pows)
        value = val
        for li in range(n_layers):
            h_leaves = 1 << (cur_log - 1)
            step = proof.fri_proof.query_rounds[qi].steps[li] \
                if proof is not None else None
            pair_leaf = [fresh((lambda j=j: int(step.pair[j])),
                               f"q{qi}.f{li}.p{j}") for j in range(4)]
            pbits = ibits[:cur_log - 1]
            digest = _hash_leaf(b, -1, pair_leaf)
            caph_l = min(fri.cap_height, cur_log - 1)
            levels = (cur_log - 1) - caph_l
            sibs = None
            if proof is not None:
                sibs = [[int(x) for x in step.path[lvl]]
                        for lvl in range(levels)]
            digest = _merkle_walk(b, digest, pbits, levels, sibs,
                                  f"q{qi}.f{li}")
            want = _select_cap(b, layer_caps[li],
                               pbits[levels:cur_log - 1])
            for j in range(DIGEST):
                b.assert_eq(digest[j], want[j], where=f"q{qi}.f{li}.cap{j}")
            v_lo = _pair(b, pair_leaf[0], pair_leaf[1])
            v_hi = _pair(b, pair_leaf[2], pair_leaf[3])
            top = Affine.of(ibits[cur_log - 1])
            committed = b.fma(top, b.sub(v_hi, v_lo), v_lo)
            b.assert_eq(committed, value, where=f"q{qi}.f{li}.bind")
            # fold: v' = (v_lo+v_hi)/2 + β·(v_lo−v_hi)/(2·x_i)
            x_i = _pow_chain(b, layer_w_pows, pbits, cur_shift)
            inv2x = b.inverse(b.mul(x_i, Affine(const=(2, 0))),
                              where=f"q{qi}.f{li}.inv2x")
            s = b.add(v_lo, v_hi)
            d = b.sub(v_lo, v_hi)
            fo = b.mul(d, inv2x)
            fe = s.scaled(pow(2, P - 2, P))
            value = b.add(fe, b.mul(fri_betas[li], fo))
            cur_log -= 1
            cur_shift = (cur_shift * cur_shift) % P
            layer_w_pows = [(x * x) % P for x in layer_w_pows]

        # final polynomial check (fri.py:309-313)
        x_fin = _pow_chain(b, layer_w_pows, ibits[:cur_log], cur_shift)
        horner = Affine(const=ext_py.ZERO)
        for c in reversed(final_coeffs):
            horner = b.add(b.mul(horner, x_fin), c)
        b.assert_eq(horner, value, where=f"q{qi}.final")

    return ret_publics

"""Poseidon-permutation AIR: proves y = PoseidonPermute(x) in zero knowledge.

The same arithmetization pattern curta's hash AIRs use, applied to the
exact sponge this repo's FRI Merkle caps use.

Shape: 32 rows × 12 state columns; row r holds the state entering round r
(rounds 0..29), row 30 the final state, row 31 a noop copy.  Preprocessed
columns: 12 round-constant columns + 3 round-type selectors (full /
partial / noop).  One degree-8 constraint per lane:

  sel_full·(s'ᵢ − Σⱼ Mᵢⱼ·(sⱼ+rcⱼ)⁷)
+ sel_partial·(s'ᵢ − Σⱼ Mᵢⱼ·vⱼ),  v₀=(s₀+rc₀)⁷, vⱼ=sⱼ+rcⱼ
+ sel_noop·(s'ᵢ − sᵢ)

Boundaries pin row 0 to the public input state and row 30 to the public
output.

Port of `vectorx_tpu.stark.poseidon_air`; the device constraints are
stacked torch ops, emitted in the scalar path's order.
"""

from __future__ import annotations

import numpy as np
import torch

from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.field.goldilocks import P
from vectorx_tpu_torch.hash import poseidon as pv
from vectorx_tpu_torch.hash import poseidon_py
from vectorx_tpu_torch.stark.air import Air, DeviceAlgebra

WIDTH = pv.WIDTH
ROWS = 32
HALF = pv.FULL_ROUNDS // 2


class PoseidonAir(Air):
    """One or many independent permutations in a single trace.

    Each permutation occupies a 32-row slot; row 31 of a slot has all
    selectors zero, so the transition into the next slot is unconstrained
    ("free" row) and slots stay independent.  Batching k permutations
    amortizes the proof over 32k rows — the building block for proving
    whole Merkle levels / sponge absorptions in one proof.
    """

    def __init__(self, input_state: list[int] | list[list[int]]):
        if input_state and isinstance(input_state[0], (list, tuple)):
            inputs = [list(s) for s in input_state]
        else:
            inputs = [list(input_state)]
        k = len(inputs)
        log_n = max(5, (ROWS * k - 1).bit_length())
        super().__init__(width=WIDTH, log_n=log_n, constraint_degree=8)
        assert all(len(s) == WIDTH for s in inputs)
        self.inputs = [[x % P for x in s] for s in inputs]
        self.outputs = [poseidon_py.permute(s) for s in self.inputs]
        # backwards-compatible single-permutation accessors
        self.input_state = self.inputs[0]
        self.output_state = self.outputs[0]
        self._rc, self._mds = pv.int_params()

    @property
    def num_perms(self) -> int:
        return len(self.inputs)

    # -- public interface ---------------------------------------------------

    def public_inputs(self):
        out = []
        for s in self.inputs:
            out.extend(s)
        for s in self.outputs:
            out.extend(s)
        return out

    def constant_columns(self):
        cols = np.zeros((WIDTH + 3, self.n), dtype=np.uint64)
        for slot in range(self.num_perms):
            base = slot * ROWS
            for r in range(pv.N_ROUNDS):
                for j in range(WIDTH):
                    cols[j, base + r] = self._rc[r * WIDTH + j]
            for r in range(ROWS):
                if r < HALF or pv.N_ROUNDS - HALF <= r < pv.N_ROUNDS:
                    cols[WIDTH + 0, base + r] = 1      # sel_full
                elif r < pv.N_ROUNDS:
                    cols[WIDTH + 1, base + r] = 1      # sel_partial
                elif r == pv.N_ROUNDS:
                    cols[WIDTH + 2, base + r] = 1      # sel_noop (row 30)
                # row 31: all selectors zero — free transition to next slot
        # padding rows past the last slot: free (all-zero selectors)
        return cols

    def boundaries(self, public):
        out = []
        for slot in range(self.num_perms):
            base = slot * ROWS
            inp_off = slot * WIDTH
            out_off = (self.num_perms + slot) * WIDTH
            out += [(base, j, public[inp_off + j]) for j in range(WIDTH)]
            out += [(base + pv.N_ROUNDS, j, public[out_off + j])
                    for j in range(WIDTH)]
        return out

    def transition(self, alg, local, nxt, public, consts=None):
        if alg is DeviceAlgebra:
            return self._transition_device(local, nxt, consts)
        rc = consts[:WIDTH]
        sel_full, sel_partial, sel_noop = consts[WIDTH:WIDTH + 3]

        u = [alg.add(local[j], rc[j]) for j in range(WIDTH)]

        def pow7(x):
            x2 = alg.mul(x, x)
            x4 = alg.mul(x2, x2)
            return alg.mul(alg.mul(x4, x2), x)

        u7 = [pow7(x) for x in u]
        v = [u7[0]] + u[1:]

        def mds_row(i, vals):
            acc = None
            for j in range(WIDTH):
                term = alg.mul(alg.constant(self._mds[i][j]), vals[j])
                acc = term if acc is None else alg.add(acc, term)
            return acc

        out = []
        for i in range(WIDTH):
            full_err = alg.sub(nxt[i], mds_row(i, u7))
            part_err = alg.sub(nxt[i], mds_row(i, v))
            noop_err = alg.sub(nxt[i], local[i])
            c = alg.mul(sel_full, full_err)
            c = alg.add(c, alg.mul(sel_partial, part_err))
            c = alg.add(c, alg.mul(sel_noop, noop_err))
            out.append(c)
        return out

    def _transition_device(self, local, nxt, consts):
        """Same constraints as the scalar path, but stacked over (12, N)
        lane tensors; the MDS matvec accumulates one input lane at a time
        (O(12·N) live memory)."""
        S = torch.stack(local)                        # (12, N)
        Sn = torch.stack(nxt)
        sel_full, sel_partial, sel_noop = consts[WIDTH:WIDTH + 3]
        mds = gl.from_u64(np.array(self._mds, dtype=np.uint64), S.device)
        u = gl.add(S, torch.stack(consts[:WIDTH]))
        u2 = gl.mul(u, u)
        u4 = gl.mul(u2, u2)
        u7 = gl.mul(gl.mul(u4, u2), u)
        v = torch.cat([u7[:1], u[1:]])

        def mds_mat(a):
            # out[i] = Σ_j M[i][j]·a[j]
            acc = gl.mul(a[0][None], mds[:, :1])
            for j in range(1, WIDTH):
                acc = gl.add(acc, gl.mul(a[j][None], mds[:, j:j + 1]))
            return acc

        t = gl.mul(gl.sub(Sn, mds_mat(u7)), sel_full[None])
        t = gl.add(t, gl.mul(gl.sub(Sn, mds_mat(v)), sel_partial[None]))
        t = gl.add(t, gl.mul(gl.sub(Sn, S), sel_noop[None]))
        return list(t.unbind(0))

    # -- witness ------------------------------------------------------------

    def build_trace(self) -> np.ndarray:
        """(12, n) states entering each round, slot per permutation, with
        the scalar-oracle round structure (hash/poseidon_py.py)."""
        rc, mds = self._rc, self._mds

        def mds_layer(s):
            return [sum(mds[i][j] * s[j] for j in range(WIDTH)) % P
                    for i in range(WIDTH)]

        all_states = []
        for slot, inp in enumerate(self.inputs):
            s = list(inp)
            states = [list(s)]
            for r in range(pv.N_ROUNDS):
                s = [(x + rc[r * WIDTH + i]) % P for i, x in enumerate(s)]
                if HALF <= r < pv.N_ROUNDS - HALF:
                    s[0] = pow(s[0], pv.ALPHA, P)
                else:
                    s = [pow(x, pv.ALPHA, P) for x in s]
                s = mds_layer(s)
                states.append(list(s))
            assert s == self.outputs[slot]
            states.append(list(s))  # noop row 31
            all_states.extend(states)
        while len(all_states) < self.n:
            all_states.append([0] * WIDTH)  # free padding rows
        trace = np.array(all_states, dtype=np.uint64).T
        assert trace.shape == (WIDTH, self.n)
        return trace

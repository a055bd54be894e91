"""A STARK proof with its LDE domain split over ranks, with checkpointing.
Port of `vectorx_tpu.parallel.sharded_prove`.

The reference places the trace with a `NamedSharding` over the domain axis
and lets GSPMD partition every stage.  Torch has no GSPMD, so the split is
written out here, as a layout (`ShardedDomain`) that the port's `prove`
runs behind (`stark.stages.LocalDomain` is the one-device layout).  Every
rank is given the whole trace; of the N = n·blowup points of the LDE
domain rank r owns the block [r·N/p, (r+1)·N/p), and of each committed
group of R polynomials the share of ceil(R/p) rows from r·ceil(R/p)
(`PolyShare`).  Stage by stage, what a rank holds and computes, and the
collectives:

* commitment (constants, trace, aux, quotient): its polynomial share's
  iNTT and coset LDE on K1, K3 and K4, then ONE all_to_all to its block
  of the domain; it hashes its leaves and its block's subtree (the leaves
  are in domain order, so a block is a subtree), and one all_gather of the
  subtree roots gives every rank the top of the tree and the cap; one
  all_gather of each rank's first `blowup` points gives the composition
  its next rows past the block.  The coefficients stay shares.
* aux witness: each rank builds the aux rows of its share.  The LogUp
  sums Z_{l,s} and the bus helpers h_{p,s} read only the trace and the
  constants, so the owner builds each whole.  The bus sums Z_s add the
  helpers over every port, so they go by block of trace rows: each rank
  sums and scans its n/p rows, one all_gather of the p block totals per
  set gives each block its offset, and one all_to_all hands the blocks
  to the ranks that commit Z_s.
* composition and DEEP codewords: pointwise, on the rank's block.
* quotient: Z_H^-1 on the block, then `ntt_sharded.coset_intt_blocks`
  (two all_to_alls) and one more all_to_all that deals the coefficient
  combs out as whole chunks to the ranks that commit them; the degree
  check is one all_reduce of the ranks' flags, so all ranks fail it
  together.
* evaluations at ζ and w·ζ: each rank evaluates its shares; one
  all_gather of the (R, 4) values puts them in the unsharded order.
* FRI: per layer of 2h points, one uneven all_to_all moves the blocks to
  the pair layout (v[i], v[i+h]) for the rank's h/p leaves i; it hashes
  them into a `ShardedTree` and folds them into its block of the next
  layer.  A layer of fewer leaves than ranks, and the final codeword, is
  gathered (at most 2p points, or final_poly_len·blowup, whatever N) and
  the rest runs on every rank.
* `grind` runs on rank 0, its witness summed to the others.
* the queried rows, FRI pairs and the lower levels of their Merkle paths
  come from the rank that holds them (one all_reduce of zero-filled
  openings).

So no all_gather carries an (N,)-long codeword or a coefficient row: the
elements gathered per proof do not grow with N.  Every rank observes the
same caps and values in the unsharded order, so the transcript — and the
proof — is bit-identical to the one-device `prove`, also for statements
past the streaming bound, which the one-device prover streams.  A
finished proof is kept in a `scheduler.CheckpointStore` under its job
key, in the reference's generic dataclass JSON (`proof_to_json`), and a
resumed job returns it without proving.
"""

from __future__ import annotations

import dataclasses

import torch

from typing import NamedTuple

from vectorx_tpu_torch import merkle
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriProof, FriQueryRound, FriQueryStep
from vectorx_tpu_torch.hash import poseidon
from vectorx_tpu_torch.parallel import ntt_sharded
from vectorx_tpu_torch.parallel.mesh import Mesh
from vectorx_tpu_torch.stark import stages
from vectorx_tpu_torch.stark.air import NUM_LOOKUP_SETS, bus_aux_layout
from vectorx_tpu_torch.stark.prover import (StarkConfig, StarkProof,
                                            TreeOpening, bus_helpers,
                                            lookup_sums, prove)

_CLASSES = {c.__name__: c for c in
            (StarkProof, TreeOpening, FriProof, FriQueryRound, FriQueryStep)}


def proof_to_json(obj):
    """StarkProof -> JSON-able dict (ints/lists/tuples/dataclasses only),
    the reference's generic form: {"__class__", "fields"}, {"__tuple__"}."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__class__": type(obj).__name__,
                "fields": {f.name: proof_to_json(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return {"__tuple__": [proof_to_json(v) for v in obj]}
    if isinstance(obj, list):
        return [proof_to_json(v) for v in obj]
    if isinstance(obj, (int, str, type(None))):
        return obj
    return int(obj)          # numpy scalar


def proof_from_json(data):
    if isinstance(data, dict) and "__class__" in data:
        cls = _CLASSES[data["__class__"]]
        return cls(**{k: proof_from_json(v)
                      for k, v in data["fields"].items()})
    if isinstance(data, dict) and "__tuple__" in data:
        return tuple(proof_from_json(v) for v in data["__tuple__"])
    if isinstance(data, list):
        return [proof_from_json(v) for v in data]
    return data


def _siblings(layers, cur: torch.Tensor) -> list:
    """The sibling digests of a whole tree's levels below its cap."""
    out = []
    for layer in layers[:-1]:
        out.append(layer[cur ^ 1])
        cur = cur >> 1
    return out


class ShardedTree:
    """A Merkle tree whose leaves lie in contiguous equal blocks over the
    ranks: this rank's subtree levels (`local`, from its leaf digests up
    to where the ranks' nodes meet) and the top levels every rank holds
    (`top`, from the gathered subtree roots to the cap)."""

    __slots__ = ("mesh", "local", "top", "cap_height", "_cap")

    def __init__(self, mesh: Mesh, leaf_digests: torch.Tensor,
                 cap_height: int):
        self.mesh = mesh
        self.cap_height = cap_height
        self._cap = None
        # the ranks' nodes meet at the cap, or at one root per rank when
        # the cap has fewer nodes than there are ranks
        meet = max(1, (1 << cap_height) // mesh.world)
        d = leaf_digests
        self.local = [d]
        while d.shape[0] > meet:
            d = merkle._rows_blocked(poseidon.two_to_one, d[0::2], d[1::2])
            self.local.append(d)
        self.top = merkle.layers_from_digests(mesh.all_gather(d, dim=0),
                                              cap_height)

    def cap_ints(self) -> list[list[int]]:
        if self._cap is None:
            self._cap = [[int(x) for x in row]
                         for row in gl.to_u64(self.top[-1])]
        return self._cap

    def served_paths(self, idx: torch.Tensor):
        """(served, upper) for query leaf indices `idx`: the sibling
        digests of the subtree levels that this rank holds (zeros where
        another rank holds them, to be summed over the ranks) and those of
        the top levels below the cap."""
        served = []
        cur = idx
        for layer in self.local[:-1]:
            m = layer.shape[0]
            sib = (cur ^ 1) - self.mesh.rank * m
            mine = (sib >= 0) & (sib < m)
            served.append(torch.where(mine[:, None],
                                      layer[sib.clamp(0, m - 1)], 0))
            cur = cur >> 1
        return served, _siblings(self.top, cur)


class PolyShare(NamedTuple):
    """This rank's share of a group of `total` polynomial rows: rows
    [rank·per, (rank+1)·per), zero rows padding the last share."""

    rows: torch.Tensor          # (per, n)
    total: int


def _held(values: torch.Tensor, i: torch.Tensor, rank: int) -> torch.Tensor:
    """values[i - rank·m] for the global indices `i` into this rank's block
    of m rows `values`, zeros where another rank holds them."""
    m = values.shape[0]
    loc = i - rank * m
    mine = ((loc >= 0) & (loc < m)).reshape(-1, *[1] * (values.dim() - 1))
    return torch.where(mine, values[loc.clamp(0, m - 1)], 0)


class ShardedDomain(stages.LocalDomain):
    """The LDE domain split into `mesh.world` equal blocks of points, one
    per rank (the hooks of `stages.LocalDomain`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _block(self, N: int) -> slice:
        m = N // self.mesh.world
        return slice(self.mesh.rank * m, (self.mesh.rank + 1) * m)

    def _share(self, rows: torch.Tensor) -> PolyShare:
        R, n = rows.shape
        per = -(-R // self.mesh.world)
        mine = rows[self.mesh.rank * per:(self.mesh.rank + 1) * per]
        if mine.shape[0] < per:
            mine = torch.cat([mine, mine.new_zeros(
                (per - mine.shape[0], n))])
        return PolyShare(mine, R)

    def _gather(self, c):
        """An ext codeword (c0, c1) in blocks -> the whole codeword."""
        both = self.mesh.all_gather(torch.stack(c)[None], dim=0)  # (p, 2, m)
        return tuple(both.transpose(0, 1).reshape(2, -1).unbind(0))

    def commit_rows(self, rows, *, rate_bits: int, cap_height: int,
                    do_intt: bool = True):
        """`rows` whole, or already this rank's `PolyShare`; returns the
        share's coefficients, the LDE of this rank's block and the tree."""
        mesh = self.mesh
        p = mesh.world
        share = rows if isinstance(rows, PolyShare) else self._share(rows)
        n = share.rows.shape[-1]
        N = n << rate_bits
        blowup = 1 << rate_bits
        if N % p or N // p < blowup:
            raise ValueError(f"an LDE of {N} points does not split over "
                             f"{p} ranks")
        c = stages.intt_rows(share.rows) if do_intt else share.rows
        lde = stages.coset_lde_rows(c, N)                     # (per, N)
        # the one exchange: polynomial shares -> row blocks of the domain
        block = mesh.all_to_all(lde, split_dim=1, concat_dim=0)[:share.total]
        del lde
        tree = ShardedTree(mesh, merkle.hash_leaves(block.T), cap_height)
        # the next rank's first `blowup` points: the composition's next row
        nxt = mesh.all_gather(block[None, :, :blowup].contiguous(), dim=0)
        lde = torch.cat([block, nxt[(mesh.rank + 1) % p]], dim=1)
        return PolyShare(c, share.total), lde, tree

    def points(self, t):
        return t[..., self._block(t.shape[-1])]

    def aux_rows(self, air, tr, consts, betas, deltas):
        """This rank's share of `prover.aux_witness`'s rows."""
        mesh = self.mesh
        S = NUM_LOOKUP_SETS
        n = tr.shape[-1]
        helper_base, z_base, A = bus_aux_layout(air)
        per = -(-A // mesh.world)
        lo, hi = mesh.rank * per, min((mesh.rank + 1) * per, A)
        parts = []
        # Z_{l,s} and h_{p,s} read only the trace and the constants: the
        # owner of a row builds all of it
        for base, end, items, build in (
                (0, helper_base, air.lookups(),
                 lambda its: lookup_sums(its, tr, consts, betas)),
                (helper_base, z_base, air.bus_ports(),
                 lambda its: bus_helpers(its, tr, consts, betas,
                                         deltas).reshape(-1, n))):
            a, b = max(lo, base) - base, min(hi, end) - base
            if a < b:
                i0 = a // S
                parts.append(build(items[i0:-(-b // S)])[a - i0 * S:
                                                         b - i0 * S])
        if air.bus_ports():
            z = self._bus_sums(air, tr, consts, betas, deltas, z_base, per)
            if max(lo, z_base) < hi:
                parts.append(z[max(lo, z_base) - lo:hi - lo])
        rows = torch.cat(parts) if parts else tr.new_zeros((0, n))
        if rows.shape[0] < per:
            rows = torch.cat([rows, rows.new_zeros((per - rows.shape[0], n))])
        return PolyShare(rows, A)

    def _bus_sums(self, air, tr, consts, betas, deltas, z_base: int,
                  per: int) -> torch.Tensor:
        """The bus sums Z_s by block of trace rows: this rank's n/p rows of
        Σ_p h_{p,s} scanned, offset by the ranks before it (one all_gather
        of the block totals), and handed to the ranks that commit Z_s (one
        all_to_all).  Returns the rows of this rank's share, zero where
        the share holds no Z_s."""
        mesh = self.mesh
        n = tr.shape[-1]
        m = n // mesh.world
        h = bus_helpers(air.bus_ports(), tr, consts, betas, deltas,
                        self._block(n))                       # (Pp, S, m)
        inc = gl.field_cumsum(gl.field_sum(h, 0), -1)         # (S, m)
        del h
        tots = mesh.all_gather(gl.canonicalize(inc[:, -1])[None], dim=0)
        off = gl.field_cumsum(tots, 0)[mesh.rank - 1] if mesh.rank \
            else torch.zeros_like(tots[0])
        z = gl.add(torch.cat([torch.zeros_like(inc[:, :1]), inc[:, :-1]], 1),
                   off[:, None])
        # aux row g sits at row g of the ranks' shares stacked
        send = tr.new_zeros((mesh.world * per, m))
        send[z_base:z_base + z.shape[0]] = gl.canonicalize(z)
        return mesh.all_to_all(send, split_dim=0, concat_dim=1)  # (per, n)

    def quotient(self, acc, zhinv, chunks: int, rate_bits: int):
        """The quotient chunks' coefficients as this rank's `PolyShare`
        of the (2·chunks, n) rows [Q0.c0, Q0.c1, Q1.c0, ...]."""
        mesh = self.mesh
        p = mesh.world
        m = acc[0].shape[0]
        N = m * p
        n = N >> rate_bits
        R = min(1 << ((N.bit_length() - 1) // 2), n)
        v = torch.stack([gl.mul(acc[0], zhinv), gl.mul(acc[1], zhinv)])
        y = gl.canonicalize(ntt_sharded.coset_intt_blocks(
            v, mesh, gl.GENERATOR, R))                    # (2, R/p, N/R)
        # coefficient k1 + R·k2: chunk k2 // (n/R), index k1 + R·(k2 % (n/R))
        y = y.reshape(2, R // p, N // n, n // R)
        bad = bool((y[:, :, chunks:] != 0).any())
        ok = int(mesh.all_reduce_sum(torch.tensor(
            [bad], dtype=torch.int64, device=mesh.device))[0]) == 0
        rows = 2 * chunks
        per = -(-rows // p)
        z = y[:, :, :chunks].permute(2, 0, 1, 3).reshape(rows, R // p,
                                                         n // R)
        if rows < p * per:
            z = torch.cat([z, z.new_zeros((p * per - rows, R // p, n // R))])
        # the combs of each chunk row -> the rank that commits it
        z = mesh.all_to_all(z, split_dim=0, concat_dim=1)     # (per, R, n/R)
        return ok, PolyShare(z.transpose(1, 2).reshape(per, n), rows)

    def deep_evals(self, groups, zeta, w_zeta, log_n: int):
        dev = self.mesh.device
        n = groups[0].rows.shape[-1]
        tz = stages.ext_power_table(zeta, n, dev)
        twz = stages.ext_power_table(w_zeta, n, dev)
        mine = torch.cat([torch.cat([stages.dot_rows(g.rows, tz),
                                     stages.dot_rows(g.rows, twz)], dim=1)
                          for g in groups])
        every = self.mesh.all_gather(mine[None], dim=0)     # (p, rows, 4)
        out, at = [], 0
        for g in groups:
            k = g.rows.shape[0]
            v = every[:, at:at + k].reshape(-1, 4)[:g.total]
            out.append((stages.ext_pairs(v[:, :2]),
                        stages.ext_pairs(v[:, 2:])))
            at += k
        return out

    def _pair_layout(self, c, h: int) -> torch.Tensor:
        """This rank's block of a 2h-point codeword -> the pair-leaves
        (c0[i], c1[i], c0[i+h], c1[i+h]) of its h/p leaves i, (h/p, 4),
        in one uneven all_to_all: a block covers the leaves of at most two
        ranks, in one half of the codeword."""
        mesh = self.mesh
        p = mesh.world
        L, m = 2 * h // p, h // p

        def sends(r):
            # rank r's points [r·L, (r+1)·L) in runs of m, point j -> leaf
            # j mod h, held by rank (j mod h) // m
            out = [0] * p
            for j in range(r * L, (r + 1) * L, m):
                out[(j % h) // m] += m
            return out

        y = mesh.all_to_all_v(torch.stack(c, dim=1), sends(mesh.rank),
                              [sends(r)[mesh.rank] for r in range(p)])
        return torch.cat([y[:m], y[m:]], dim=1)

    def fri_commit(self, c, cur_log: int, cap_height: int):
        """A layer in blocks stays sharded while it has a leaf per rank:
        (pair-leaves, ShardedTree); otherwise it is gathered and committed
        on every rank."""
        h = 1 << (cur_log - 1)
        if c[0].shape[0] < 2 * h:
            if h % self.mesh.world == 0:
                leaves = self._pair_layout(c, h)
                return leaves, ShardedTree(self.mesh,
                                           merkle.hash_leaves(leaves),
                                           cap_height)
            c = self._gather(c)
        return super().fri_commit(c, cur_log, cap_height)

    def fri_fold(self, layer, beta, cur_log: int, cur_shift: int):
        if isinstance(layer, tuple):
            return super().fri_fold(layer, beta, cur_log, cur_shift)
        return stages.fri_fold_pairs(
            (layer[:, 0], layer[:, 1]), (layer[:, 2], layer[:, 3]), beta,
            cur_log, cur_shift, self.mesh.rank * layer.shape[0])

    def fri_final(self, c, cur_log: int, cur_shift: int, final_len: int):
        if c[0].shape[0] < 1 << cur_log:
            c = self._gather(c)
        return super().fri_final(c, cur_log, cur_shift, final_len)

    def grind(self, challenger, pow_bits: int, device) -> int:
        if pow_bits == 0:
            return stages.grind(challenger, 0, device)
        mine = stages.grind(challenger, pow_bits, device) \
            if self.mesh.rank == 0 else 0
        nonce = int(self.mesh.all_reduce_sum(torch.tensor(
            [mine], dtype=torch.int64, device=self.mesh.device))[0])
        if self.mesh.rank != 0:
            challenger.observe(nonce)
            challenger.get_challenge()
        return nonce

    def open_positions(self, indices, leaf_groups, trees, fri_layers):
        """`stages.open_positions` over the row blocks: the queried leaves,
        the sharded FRI layers' pairs and the subtree levels of every path
        are served by their holder, all in one all_reduce of zero-filled
        tensors; the gathered FRI layers' pairs and paths every rank
        reads itself."""
        mesh = self.mesh
        idx = torch.tensor(list(indices), dtype=torch.int64,
                           device=mesh.device)
        served = []
        for g, t in zip(leaf_groups, trees):
            m = t.local[0].shape[0]             # the points of each block
            served.append(_held(g[:, :m].T, idx, mesh.rank).T)
        tops = []
        for t in trees:
            s, u = t.served_paths(idx)
            served += s
            tops.append((len(s), u))
        fri = []
        cur = idx
        for layer, tree in fri_layers:
            if isinstance(tree, ShardedTree):
                cur = cur % (layer.shape[0] * mesh.world)
                served.append(_held(layer, cur, mesh.rank))
                s, u = tree.served_paths(cur)
                served += s
                fri.append((None, len(s), u))
            else:
                c0, c1 = layer
                h = c0.shape[0] // 2
                cur = cur % h
                fri.append(((gl.to_u64(c0[cur]), gl.to_u64(c1[cur]),
                             gl.to_u64(c0[cur + h]), gl.to_u64(c1[cur + h])),
                            0, _siblings(tree.layers, cur)))
        # canonical values, so that the holder's value plus zeros is exact
        flat = torch.cat([gl.canonicalize(t).reshape(-1) for t in served])
        flat = mesh.all_reduce_sum(flat)
        out, at = [], 0
        for t in served:
            out.append(gl.to_u64(flat[at:at + t.numel()].reshape(t.shape)))
            at += t.numel()
        out = iter(out)
        group_leaves = [next(out) for _ in leaf_groups]

        def paths(k, upper):
            return [next(out) for _ in range(k)] + \
                [gl.to_u64(u) for u in upper]

        group_paths = [paths(k, u) for k, u in tops]
        fri_pairs, fri_paths = [], []
        for pair, k, u in fri:
            if pair is None:
                v = next(out)
                pair = (v[:, 0], v[:, 1], v[:, 2], v[:, 3])
            fri_pairs.append(pair)
            fri_paths.append(paths(k, u))
        return group_leaves, group_paths, fri_pairs, fri_paths


def prove_sharded(air, trace_u64, config: StarkConfig, mesh: Mesh,
                  store=None, job: str = "sharded-prove"):
    """Prove `air` with its LDE domain split over `mesh`'s ranks, every
    rank on `mesh.device`; every rank returns the same proof.

    Returns (proof, from_checkpoint).  With a `CheckpointStore`, a
    completed proof is persisted under (`job`, "proof") and reused when
    every rank finds it."""
    cached = store.get(job, "proof") if store is not None else None
    hits = int(mesh.all_reduce_sum(torch.tensor(
        [cached is not None], dtype=torch.int64, device=mesh.device))[0])
    if hits == mesh.world:
        return proof_from_json(cached["proof"]), True
    proof = prove(air, trace_u64, config, device=mesh.device,
                  domain=ShardedDomain(mesh))
    if store is not None:
        store.put(job, "proof", {"proof": proof_to_json(proof)})
    return proof, False

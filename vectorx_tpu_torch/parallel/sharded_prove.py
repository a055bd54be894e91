"""A STARK proof with its LDE domain split over ranks, with checkpointing.
Port of `vectorx_tpu.parallel.sharded_prove`.

The reference places the trace with a `NamedSharding` over the domain axis
and lets GSPMD partition every stage.  Torch has no GSPMD, so the split is
written out here, as a layout (`ShardedDomain`) that the port's `prove`
runs behind (`stark.stages.LocalDomain` is the one-device layout):

* a commitment (trace, aux, constants, quotient): each rank takes its
  share of the polynomials — iNTT and coset LDE on K1/K2, no exchange —
  then ONE all_to_all moves the LDE to row blocks of the domain (rank r
  holds points [r·N/p, (r+1)·N/p)).  Each rank hashes its leaves and its
  block's subtree (the tree's leaves are in domain order, so a block is a
  subtree); the subtree roots are gathered and every rank builds the top
  of the tree and the cap.  The coefficients are gathered too, for the
  evaluations at ζ.
* the constraint composition and the DEEP codeword are pointwise: each
  rank computes them on its block, the composition with the `blowup`
  next-row points of the following rank's block (gathered with it), and
  the two (N,) codewords are gathered.
* the quotient's interpolation and the FRI folds run on every rank on the
  gathered codewords; each FRI layer's tree is sharded like a commitment.
* `grind` runs on rank 0, its witness summed to the others.
* the queried rows and the lower levels of their Merkle paths come from
  the rank that holds them (one all_reduce of zero-filled openings).

Every rank observes the same caps and values, so the transcript — and the
proof — is bit-identical to the one-device `prove`.  A finished proof is
kept in a `scheduler.CheckpointStore` under its job key, in the
reference's generic dataclass JSON (`proof_to_json`), and a resumed job
returns it without proving.
"""

from __future__ import annotations

import dataclasses

import torch

from vectorx_tpu_torch import merkle
from vectorx_tpu_torch.field import goldilocks as gl
from vectorx_tpu_torch.fri.fri import FriProof, FriQueryRound, FriQueryStep
from vectorx_tpu_torch.hash import poseidon
from vectorx_tpu_torch.parallel.mesh import Mesh
from vectorx_tpu_torch.stark import stages
from vectorx_tpu_torch.stark.prover import (StarkConfig, StarkProof,
                                            TreeOpening, prove)

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
        served, upper = [], []
        cur = idx
        for layer in self.local[:-1]:
            m = layer.shape[0]
            sib = (cur ^ 1) - self.mesh.rank * m
            mine = (sib >= 0) & (sib < m)
            served.append(torch.where(mine[:, None],
                                      layer[sib.clamp(0, m - 1)], 0))
            cur = cur >> 1
        for layer in self.top[:-1]:
            upper.append(layer[cur ^ 1])
            cur = cur >> 1
        return served, upper


class ShardedDomain(stages.LocalDomain):
    """The LDE domain split into `mesh.world` equal blocks of points, one
    per rank (the hooks of `stages.LocalDomain`)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def _block(self, N: int) -> slice:
        m = N // self.mesh.world
        return slice(self.mesh.rank * m, (self.mesh.rank + 1) * m)

    def commit_rows(self, rows, *, rate_bits: int, cap_height: int,
                    do_intt: bool = True):
        mesh = self.mesh
        p = mesh.world
        R, n = rows.shape
        N = n << rate_bits
        blowup = 1 << rate_bits
        if N % p or N // p < blowup:
            raise ValueError(f"an LDE of {N} points does not split over "
                             f"{p} ranks")
        # this rank's polynomials, zero rows padding R to a multiple of p
        per = -(-R // p)
        mine = rows[mesh.rank * per:(mesh.rank + 1) * per]
        if mine.shape[0] < per:
            mine = torch.cat([mine, mine.new_zeros(
                (per - mine.shape[0], n))])
        c = stages.intt_rows(mine) if do_intt else mine
        lde = stages.coset_lde_rows(c, N)                     # (per, N)
        # the one exchange: polynomial shares -> row blocks of the domain
        block = mesh.all_to_all(lde, split_dim=1, concat_dim=0)[:R]
        del lde
        tree = ShardedTree(mesh, merkle.hash_leaves(block.T), cap_height)
        coeffs = mesh.all_gather(c, dim=0)[:R] if do_intt else rows
        # the next rank's first `blowup` points: the composition's next row
        nxt = mesh.all_gather(block[None, :, :blowup].contiguous(), dim=0)
        lde = torch.cat([block, nxt[(mesh.rank + 1) % p]], dim=1)
        return coeffs, lde, tree

    def points(self, t):
        return t[..., self._block(t.shape[-1])]

    def gather(self, c):
        both = self.mesh.all_gather(torch.stack(c)[None], dim=0)  # (p, 2, m)
        return tuple(both.transpose(0, 1).reshape(2, -1).unbind(0))

    def fri_commit_layer(self, c, cur_log: int, cap_height: int):
        """The pair-leaves (v[i], v[i+N/2]) of the (replicated) codeword,
        this rank's block of them hashed into a ShardedTree."""
        c0, c1 = c
        h = c0.shape[0] // 2
        if h % self.mesh.world:
            raise ValueError(f"a FRI layer of {h} leaves does not split "
                             f"over {self.mesh.world} ranks")
        sl = self._block(h)
        leaves = torch.stack([c0[:h][sl], c1[:h][sl], c0[h:][sl],
                              c1[h:][sl]], dim=1)
        return ShardedTree(self.mesh, merkle.hash_leaves(leaves), cap_height)

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
        """`stages.open_positions` over the row blocks: the queried leaves
        and the subtree levels of every path are served by their holder,
        all in one all_reduce of zero-filled tensors."""
        mesh = self.mesh
        dev = mesh.device
        idx = torch.tensor(list(indices), dtype=torch.int64, device=dev)
        served = []
        for g, t in zip(leaf_groups, trees):
            m = t.local[0].shape[0]             # the points of each block
            loc = idx - mesh.rank * m
            mine = (loc >= 0) & (loc < m)
            served.append(torch.where(mine[None, :],
                                      g[:, loc.clamp(0, m - 1)], 0))
        tops = []
        for t in trees:
            s, u = t.served_paths(idx)
            served += s
            tops.append((len(s), u))
        fri_pairs, fri_tops = [], []
        cur = idx
        for (c0, c1), tree in fri_layers:
            h = c0.shape[0] // 2
            i = cur % h
            fri_pairs.append((gl.to_u64(c0[i]), gl.to_u64(c1[i]),
                              gl.to_u64(c0[i + h]), gl.to_u64(c1[i + h])))
            s, u = tree.served_paths(i)
            served += s
            fri_tops.append((len(s), u))
            cur = i
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
        fri_paths = [paths(k, u) for k, u in fri_tops]
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

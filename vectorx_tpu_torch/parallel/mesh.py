"""Process group + rank layout — port of `vectorx_tpu.parallel.mesh`.

The reference lays a `jax.sharding.Mesh` over devices and lets XLA insert
the collectives.  Here a `Mesh` is a `torch.distributed` process group (one
process per rank), the rank's device and the transport the caller chose:

* ``"nccl"``: the collectives run on the CUDA tensors themselves;
* ``"gloo"``: on CPU tensors directly; on CUDA tensors every collective
  copies its input to the host, runs there and copies the result back.
  That is the transport for ranks that share one card (NCCL takes one rank
  per device), named by the caller, never a retry after NCCL failed.

The three collectives the port uses live here and nowhere else:
`all_to_all` (tiled, or uneven as `all_to_all_v`), `all_gather` and
`all_reduce_sum`.  Each counts its calls in `Mesh.counts` (read by
`comm_model.collective_counts`).  A rank layout
(`shard_batch`, `replicated`) says which slice of a leading axis a rank
holds.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

COLLECTIVES = ("all_to_all", "all_gather", "all_reduce")


def _rank_device(device, rank: int) -> torch.device:
    """`device` for global rank `rank`: "cuda" without an index maps ranks
    round-robin over the visible cards."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("Mesh on cuda: torch.cuda.is_available() is "
                               "false")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"no Mesh for device {dev}")
    return dev


class Mesh:
    """One axis of ranks: a process group, this process's rank in it, its
    device and the transport of its collectives."""

    def __init__(self, group=None, *, device, axis_name: str = "batch"):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs torch.distributed initialized "
                               "(scheduler.init_distributed)")
        self.group = group
        self.axis_name = axis_name
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = _rank_device(device, dist.get_rank())
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend takes CUDA tensors only")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {self.backend}: nccl or gloo")
        # gloo runs on host memory: CUDA tensors are staged through it
        self.host_staged = self.backend == "gloo" \
            and self.device.type == "cuda"
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    @property
    def transport(self) -> str:
        return "gloo via host copies" if self.host_staged else self.backend

    def reset_counts(self) -> None:
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    def _stage(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.int64:
            raise TypeError(f"collectives take int64 tensors, got {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, the mesh's rank on "
                             f"{self.device}")
        x = x.contiguous()
        return x.cpu() if self.host_staged else x

    def _unstage(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device) if self.host_staged else x

    def all_to_all(self, x: torch.Tensor, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """Tiled all-to-all: `x` splits into `world` equal blocks along
        `split_dim`, block j goes to rank j, and the blocks received
        concatenate in rank order along `concat_dim`."""
        p = self.world
        if x.shape[split_dim] % p:
            raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not "
                             f"split over {p} ranks")
        self.counts["all_to_all"] += 1
        moved = x.movedim(split_dim, 0)
        blk = (p, moved.shape[0] // p, *moved.shape[1:])
        send = self._stage(moved.reshape(blk))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        recv = self._unstage(recv)
        return torch.cat([b.movedim(0, split_dim) for b in recv.unbind(0)],
                         dim=concat_dim)

    def all_to_all_v(self, x: torch.Tensor, send: list[int],
                     recv: list[int]) -> torch.Tensor:
        """Uneven all-to-all along dim 0: the first send[0] rows of `x` go
        to rank 0, the next send[1] to rank 1, ...; returns the rows
        received, recv[j] of them from rank j, in rank order."""
        if sum(send) != x.shape[0] or len(send) != self.world \
                or len(recv) != self.world:
            raise ValueError(f"splits {send} -> {recv} of {x.shape[0]} rows "
                             f"over {self.world} ranks")
        self.counts["all_to_all"] += 1
        s = self._stage(x)
        out = s.new_empty((sum(recv), *s.shape[1:]))
        dist.all_to_all_single(out, s, recv, send, group=self.group)
        return self._unstage(out)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `x`, concatenated in rank order along `dim`."""
        self.counts["all_gather"] += 1
        send = self._stage(x)
        parts = [torch.empty_like(send) for _ in range(self.world)]
        dist.all_gather(parts, send, group=self.group)
        return self._unstage(torch.cat(parts, dim=dim))

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the ranks of `x` (int64; every caller
        keeps its sums below 2^63)."""
        self.counts["all_reduce"] += 1
        t = self._stage(x).clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return self._unstage(t)


def make_mesh(n_devices: int | None = None, axis_name: str = "batch", *,
              device) -> Mesh:
    """1-D mesh over every rank of the default process group; `n_devices`,
    when given, must be its world size."""
    mesh = Mesh(device=device, axis_name=axis_name)
    if n_devices is not None and mesh.world != n_devices:
        raise ValueError(f"need {n_devices} ranks, have {mesh.world}")
    return mesh


def make_mesh_2d(batch: int, poly: int, *, device) -> dict:
    """2-D layout, rank = b·poly + q: {"batch": the ranks of one q,
    "poly": the ranks of one b} — leaf-proof data parallelism x intra-proof
    poly sharding.  Every rank must call it (it creates the subgroups)."""
    world = dist.get_world_size()
    if world != batch * poly:
        raise ValueError(f"{batch} x {poly} ranks, have {world}")
    me = dist.get_rank()
    axes = {}
    for q in range(poly):
        g = dist.new_group([b * poly + q for b in range(batch)])
        if me % poly == q:
            axes["batch"] = g
    for b in range(batch):
        g = dist.new_group([b * poly + q for q in range(poly)])
        if me // poly == b:
            axes["poly"] = g
    return {name: Mesh(g, device=device, axis_name=name)
            for name, g in axes.items()}


def shard_batch(mesh: Mesh, n: int) -> slice:
    """The slice of a length-`n` leading axis this rank holds."""
    if n % mesh.world:
        raise ValueError(f"{n} rows do not split over {mesh.world} ranks")
    m = n // mesh.world
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def replicated(mesh: Mesh, n: int) -> slice:
    """Every rank holds the whole axis."""
    return slice(0, n)


def run_ranks(argvs: list[list[str]], *, timeout: float,
              env=None) -> list[str]:
    """Start one process per rank (`argvs[rank]`), wait for all of them and
    return their outputs (stdout and stderr together).  When one fails,
    or `timeout` seconds pass, every process still running is killed (a
    rank left alone would wait in its next collective) and RuntimeError
    says which rank failed and shows the end of its output."""
    import subprocess
    import tempfile
    import time

    with tempfile.TemporaryDirectory(prefix="vectorx-ranks-") as d:
        files = [open(f"{d}/rank{r}.out", "w+") for r in range(len(argvs))]
        procs = [subprocess.Popen(a, stdout=f, stderr=subprocess.STDOUT,
                                  env=env)
                 for a, f in zip(argvs, files)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
    timed_out = time.monotonic() > deadline
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            why = f"killed after {timeout:.0f} s" if timed_out \
                else f"exit {p.returncode}"
            raise RuntimeError(f"rank {rank} failed ({why}):\n{out[-3000:]}")
    return outs

"""Meshes over ``torch.distributed`` ranks, and the collectives on them.

The port of the JAX package's ``repro.launch.mesh``.  A :class:`Mesh` is a
row-major grid of ranks with named axes (``("data", "model")`` for the
host meshes): rank ``r`` of a ``(data, model)`` mesh sits at
``(r // model, r % model)``, the device order ``jax.make_mesh`` gives host
devices, so partition ownership and query shards match the reference rank
for rank.  The mesh holds one process group per axis (the ranks that
differ only along it) and one over all its ranks, and carries the four
collectives the distributed runtime uses: ``all_to_all`` over an axis
(``dist.all_to_all_single``; ``exchange`` its uneven form), max and sum
all-reduces, and ``all_gather``.

Building a mesh is collective: every rank of the world builds the same
mesh, in the same order, because ``dist.new_group`` must be called by every
rank for every group.  A mesh smaller than the world is laid over
consecutive blocks of ranks, one replica per block (``make_host_mesh``'s
``(1, 1)`` fallback on a world of 4 is four one-rank replicas, each
computing the whole answer).

With no process group initialised, a mesh has one rank (``Mesh((1,
1))``, which ``fpp/backends.default_mesh`` gives) and its collectives
return their input; that is the only place where one rank differs.
A :class:`DryMesh` is one rank of a mesh of any shape with no world at
all: its collectives return outputs of the right shape, uncomputed, and
are counted as a real mesh's (the dry run, ``launch/dryrun.py``;
``make_production_mesh(dry_rank=)``).  Every mesh counts its collectives
by kind and axis with their operands' bytes (:attr:`Mesh.traffic`).

Under autograd the collectives carry their adjoints, chosen so that every
activation replicated over an axis keeps a complete, replicated gradient
(the rule the tensor-parallel blocks of ``models/manual_tp.py`` keep):
``all_reduce_sum`` passes its gradient through (its output is the
replicated sum of partial terms); :meth:`Mesh.sum_grad` is the identity
forward and sums the gradient over its axis (a replicated input entering
a computation split over that axis); ``exchange`` sends each rank's
gradient back the way its rows came; ``all_gather`` hands each rank its
block of the gradient, summed over the axis first when ``grad="sum"``
(the ranks along it computed with different data: the FSDP gather over
``"data"``, whose adjoint is a reduce-scatter); :meth:`Mesh.take_block`
cuts the rank's block of a replicated tensor and gathers the blocks'
gradients (the training forward's sequence-split carry between layers).
A backward enters its collectives in autograd's order, which is the same
on every rank of a mesh that built the same graph; a rank that waits for
a collective the others never enter fails at ``spawn``'s timeout.

Not ported: ``compat_make_mesh`` and ``set_mesh``.  They paper over jax
versions (the ``axis_types=`` keyword, ``jax.set_mesh`` against the
resource-env context) and have no torch counterpart: a torch mesh is built
directly and is never ambient.

:func:`spawn` starts a world of local ranks (``torch.multiprocessing``'s
spawn start method, a ``FileStore`` rendezvous in a temporary directory,
so no port is fixed) and returns each rank's result; the collective
backend is its explicit argument (``gloo``: ranks may share one card or
run on the CPU; ``nccl``: one rank per card).
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

HOST_AXES = ("data", "model")


class Mesh:
    """A row-major grid of ranks with named axes (see the module doc).

    ``shape`` maps each axis name to its size, as the reference's
    ``mesh.shape`` does; ``coords`` maps it to this rank's coordinate.
    ``calls`` counts the collectives this rank has entered on it and
    ``seconds`` adds up the host's time inside them (a collective of CUDA
    tensors first waits for the card's work queued before it).
    ``traffic`` counts them by ``(kind, axis)`` (``all_gather``,
    ``all_reduce``, ``reduce_scatter``, ``all_to_all``, ``exchange`` or
    ``barrier``; axis None for the whole mesh) as ``[calls, bytes]``,
    the bytes the operand's (the reference's ``hlo.collective_stats``
    counts operand bytes too); :meth:`collectives` sums it up.
    """

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = HOST_AXES):
        self.distributed = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        rank = dist.get_rank() if self.distributed else 0
        self._place(shape, axis_names, rank)
        shape, size = tuple(self.shape.values()), self.size
        if world % size:
            raise ValueError(f"a mesh of {size} ranks {shape} does not tile "
                             f"a world of {world}")
        base = rank - rank % size
        grid = np.arange(size).reshape(shape)      # mesh-local ranks
        if not self.distributed:
            return
        # every rank creates every group, in one order (dist.new_group);
        # an axis's groups are the lines of ranks that differ only along it
        for b in range(0, world, size):
            g = dist.new_group(list(range(b, b + size)))
            if b == base:
                self._groups[None] = g
            for ax, n in enumerate(shape):
                for line in np.moveaxis(grid, ax, -1).reshape(-1, n).tolist():
                    ranks = [b + r for r in line]
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        self._groups[self.axis_names[ax]] = g

    def _place(self, shape: Sequence[int], axis_names: Sequence[str],
               rank: int) -> None:
        """The layout fields: names, sizes, ``rank`` and its coordinates
        (row-major over the mesh-local rank ``rank % size``), no groups
        and zero counts."""
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or min(shape) < 1:
            raise ValueError(f"mesh shape {shape} does not fit axes "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.rank = rank
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            rank % self.size, shape))))
        self._groups: dict = {}
        self.calls = 0
        self.seconds = 0.0
        self.traffic: dict = {}

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (its shard number)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    # -- collectives (identity on a one-rank mesh with no process group) --

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``out[j] = x[me]`` of the rank at coordinate ``j`` along
        ``axis``: ``x`` is ``[shape[axis], ...]``."""
        if not self.distributed:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        self._call("all_to_all", axis, x, dist.all_to_all_single, out, x)
        return out

    def exchange(self, x: torch.Tensor, axis: str, send: Sequence[int],
                 recv: Sequence[int]) -> torch.Tensor:
        """An uneven all-to-all over ``axis``: the rows of ``x`` (its dim 0)
        cut in order into ``send[j]`` rows for the rank at coordinate
        ``j``; returns the ``sum(recv)`` rows received, ``recv[j]`` of them
        from coordinate ``j``, in coordinate order.  Its gradient is the
        reverse exchange."""
        if not self.distributed:
            return x
        return _Exchange.apply(x, self, axis, tuple(send), tuple(recv))

    def _exchange(self, x: torch.Tensor, axis: str, send: tuple,
                  recv: tuple) -> torch.Tensor:
        x = x.detach().contiguous()
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        self._call("exchange", axis, x, dist.all_to_all_single, out, x,
                   output_split_sizes=list(recv),
                   input_split_sizes=list(send))
        return out

    def _call(self, kind: str, axis, x: Optional[torch.Tensor], collective,
              *args, **kwargs) -> None:
        """Enter one collective of ``kind`` over ``axis`` (None: the whole
        mesh) on the operand ``x``, counted (:meth:`_count`) and timed."""
        self._count(kind, axis, x)
        t = time.perf_counter()
        collective(*args, group=self._groups[axis], **kwargs)
        self.seconds += time.perf_counter() - t

    def _count(self, kind: str, axis, x: Optional[torch.Tensor]) -> None:
        self.calls += 1
        row = self.traffic.setdefault((kind, axis), [0, 0])
        row[0] += 1
        row[1] += 0 if x is None else x.numel() * x.element_size()

    def collectives(self) -> dict:
        """``{"calls", "bytes", "by_kind": {kind: {"calls", "bytes"}},
        "by_axis": {axis: ...}, "by_kind_axis": {"kind@axis": ...}}`` of
        :attr:`traffic` (the whole mesh's axis is named ``"all"``)."""
        out = {"calls": 0, "bytes": 0, "by_kind": {}, "by_axis": {},
               "by_kind_axis": {}}
        for (kind, axis), (n, b) in sorted(self.traffic.items(),
                                           key=lambda kv: str(kv[0])):
            out["calls"] += n
            out["bytes"] += b
            for key, name in (("by_kind", kind), ("by_axis", axis or "all"),
                              ("by_kind_axis", f"{kind}@{axis or 'all'}")):
                row = out[key].setdefault(name, {"calls": 0, "bytes": 0})
                row["calls"] += n
                row["bytes"] += b
        return out

    def reset_counts(self) -> None:
        """Zero :attr:`calls`, :attr:`seconds` and :attr:`traffic`."""
        self.calls, self.seconds, self.traffic = 0, 0.0, {}

    def _all_reduce(self, x: torch.Tensor, op, axis) -> torch.Tensor:
        if not self.distributed:
            return x
        x = x.detach().clone()
        self._call("all_reduce", axis, x, dist.all_reduce, x, op=op)
        return x

    def all_reduce_max(self, x: torch.Tensor,
                       axis: Optional[str] = None) -> torch.Tensor:
        """Max over ``axis`` (None: over the whole mesh); no gradient."""
        return self._all_reduce(x, dist.ReduceOp.MAX, axis)

    def all_reduce_sum(self, x: torch.Tensor,
                       axis: Optional[str] = None) -> torch.Tensor:
        """Sum over ``axis`` (None: over the whole mesh).  Its gradient is
        the output's, unchanged (module docstring)."""
        if not self.distributed:
            return x
        return _AllReduceSum.apply(x, self, axis)

    def sum_grad(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` itself; its gradient summed over ``axis`` (module
        docstring)."""
        if not (self.distributed and x.requires_grad
                and torch.is_grad_enabled()):
            return x
        return _SumGrad.apply(x, self, axis)

    def all_gather(self, x: torch.Tensor, axis: str,
                   grad: str = "slice") -> torch.Tensor:
        """``[shape[axis], *x.shape]``: every rank's ``x`` along ``axis``,
        in coordinate order.  The gradient of ``x`` is the rank's block of
        the output's, summed over ``axis`` first with ``grad="sum"``."""
        if grad not in ("slice", "sum"):
            raise ValueError(f"all_gather grad={grad!r}: slice or sum")
        if not self.distributed:
            return x[None]
        return _AllGather.apply(x, self, axis, grad == "sum")

    def take_block(self, x: torch.Tensor, axis: str,
                   dim: int) -> torch.Tensor:
        """This rank's block of ``x`` (replicated over ``axis``) along
        ``dim``, the ``shape[axis]``-th part at its coordinate, as a tensor
        of its own.  Its gradient is every rank's block of the output's
        gradient gathered over ``axis`` in coordinate order: the adjoint of
        ``all_gather(grad="slice")``, which it undoes."""
        n = self.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over the {n} ranks of {axis!r}")
        if not self.distributed:
            return x
        return _TakeBlock.apply(x, self, axis, dim)

    def barrier(self) -> None:
        """Every rank of the mesh has reached this call."""
        if self.distributed:
            self._call("barrier", None, None, dist.barrier)

    def _gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.detach().contiguous()
        n = self.shape[axis]
        out = x.new_empty(n * x.numel())
        self._call("all_gather", axis, x, dist.all_gather_into_tensor, out,
                   x.view(-1))
        return out.view((n,) + tuple(x.shape))

    def _reduce_scatter(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x [shape[axis], ...]`` summed over ``axis``; this rank's row."""
        x = x.detach().contiguous()
        out = x.new_empty(x[0].numel())
        self._call("reduce_scatter", axis, x, dist.reduce_scatter_tensor, out,
                   x.view(-1))
        return out.view(x.shape[1:])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


class DryMesh(Mesh):
    """One rank of a mesh of any shape, with no process group: the rank at
    mesh-local ``rank`` (row-major coordinates, as :class:`Mesh` lays
    them).  Its collectives return outputs of the right shape, dtype and
    device, uninitialised (a dry run computes on fake tensors, whose values
    nobody reads), and are counted in :attr:`calls` and :attr:`traffic`
    as a real mesh counts them; ``seconds`` stays 0.  The autograd
    adjoints go through the same primitives, so a backward's collectives
    are counted too (``launch/dryrun.py``)."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = HOST_AXES, *, rank: int = 0):
        self._place(shape, axis_names, rank)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        self.distributed = True

    def _call(self, kind: str, axis, x, collective, *args, **kwargs) -> None:
        self._count(kind, axis, x)

    def __repr__(self) -> str:
        return f"DryMesh({self.shape}, rank={self.rank})"


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh._all_reduce(x, dist.ReduceOp.SUM, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_reduce(g, dist.ReduceOp.SUM, ctx.axis), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, send, recv):
        ctx.mesh, ctx.axis, ctx.send, ctx.recv = mesh, axis, send, recv
        return mesh._exchange(x, axis, send, recv)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh._exchange(g, ctx.axis, ctx.recv, ctx.send), None,
                None, None, None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, summed):
        ctx.mesh, ctx.axis, ctx.summed = mesh, axis, summed
        return mesh._gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.mesh, ctx.axis
        if ctx.summed:
            return mesh._reduce_scatter(g, axis), None, None, None
        return g[mesh.coords[axis]], None, None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        size = x.shape[dim] // mesh.shape[axis]
        return x.narrow(dim, mesh.coords[axis] * size, size).clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        # the blocks joined along dim (a view of the gather where it can)
        parts = ctx.mesh._gather(g, ctx.axis)
        shape = list(g.shape)
        shape[ctx.dim] *= parts.shape[0]
        return parts.movedim(0, ctx.dim).reshape(shape), None, None, None


def world_size() -> int:
    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over the world, or ``(1, 1)`` when it asks
    for more ranks than the world has (the reference's rule)."""
    if data * model > world_size():
        data, model = 1, 1
    return Mesh((data, model))


def make_production_mesh(*, multi_pod: bool = False,
                         dry_rank: Optional[int] = None) -> Mesh:
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``: over an initialised world of exactly that
    many ranks, or with ``dry_rank`` that rank of it as a :class:`DryMesh`,
    with no world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else HOST_AXES
    if dry_rank is not None:
        return DryMesh(shape, axes, rank=dry_rank)
    want, have = math.prod(shape), world_size()
    if have != want:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{want} ranks; this one has {have}")
    return Mesh(shape, axes)


def chips(mesh: Mesh) -> int:
    return int(mesh.size)


# ---------------------------------------------------------------------------
# a world of local ranks


def _rank_main(rank: int, world: int, backend: str, store_dir: str,
               timeout_s: float, fn: Callable, args: tuple) -> None:
    # every rank is on this host, so gloo talks over the loopback device
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(store_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, world: int, backend: str, args: tuple = (),
          timeout_s: float = 60.0) -> list:
    """Run ``fn(rank, *args)`` on ``world`` local ranks joined in one
    process group of ``backend`` and return their results, by rank.

    ``fn`` is a module-level function (the spawn start method pickles it).
    Each rank sets its CUDA device to ``rank % device_count`` where there is
    a card, and one CPU thread; ``timeout_s`` bounds the rendezvous and
    every collective.  A rank that fails fails the call."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown collective backend {backend!r}; "
                         f"gloo or nccl")
    store_dir = tempfile.mkdtemp(prefix="fpp_world_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(world, backend, store_dir, timeout_s, fn, args),
            nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(store_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)

"""The mesh of a distributed fit and the few collectives the fit uses.

A fit whose cells are split over ranks keeps each rank's block of rows on
its device, and every sum over cells becomes the rank's own sum followed by
an ``all_reduce``. Every collective here is an ``all_reduce`` (SUM, MAX or
MIN) of a tensor on the rank's device: together with ``broadcast`` the only
collectives the gloo backend takes on CUDA tensors, so one code path serves
NCCL (one rank a card) and gloo (ranks sharing a card, or on the CPU).
Per-cell outputs are gathered by an ``all_reduce`` SUM of zero-filled
global buffers, each rank writing its own rows (:func:`gather_rows`).

Code that takes ``cells`` (a :class:`Cells`, or None for a fit in one
process) runs the same with and without a mesh: every helper returns its
input unchanged when ``cells`` is None.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

CELL_AXIS = "cells"
GENE_AXIS = "genes"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a fit laid out as (cells, genes), this rank's place in
    it, its device and the process group, None in one process without a
    group (a world of one, which runs no collective)."""

    cells: int
    genes: int
    rank: int
    device: torch.device
    group: object = None

    @property
    def world(self) -> int:
        return self.cells * self.genes

    @property
    def shape(self) -> dict:
        return {CELL_AXIS: self.cells, GENE_AXIS: self.genes}


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a TypeError naming ``make_mesh``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a clonealign_torch.parallel.sharding.Mesh from make_mesh(), got "
            f"{type(mesh).__name__}")
    return mesh


class Cells(NamedTuple):
    """This rank's block of a fit's cells: the global rows start:stop of
    ``n``, on a mesh whose group runs the collectives."""

    mesh: Mesh
    start: int
    stop: int
    n: int


class Shard(NamedTuple):
    """This rank's rows of a per-cell array, on its device, and where they
    lie among every rank's (``distributed.host_local_to_global``); ``cells``
    is None in one process without a group."""

    data: torch.Tensor
    cells: Optional[Cells]

    @property
    def offset(self) -> int:
        return 0 if self.cells is None else self.cells.start

    @property
    def n_cells(self) -> int:
        return self.data.shape[0] if self.cells is None else self.cells.n


def process_cell_slice(n_cells_global: int, rank: int, world: int) -> slice:
    """The rows of ``n_cells_global`` cells that rank ``rank`` of ``world``
    owns: equal contiguous blocks, the last rank taking the remainder
    (clonealign_tpu/parallel/distributed.py:71-79)."""
    per = n_cells_global // world
    start = rank * per
    stop = n_cells_global if rank == world - 1 else start + per
    return slice(start, stop)


def _check_every_rank_has_cells(n: int, world: int) -> None:
    if n < world:
        raise ValueError(f"{n} cells cannot be split over {world} ranks: every rank of the "
                         f"mesh needs at least one cell")


def block_of(mesh: Optional[Mesh], n: int) -> Optional[Cells]:
    """The :class:`Cells` of this rank when every rank holds all ``n`` cells
    and keeps its :func:`process_cell_slice`; None for a mesh without a
    group (or none). Fewer cells than ranks raise a ValueError on every
    rank."""
    if mesh is None or mesh.group is None:
        return None
    _check_every_rank_has_cells(n, mesh.world)
    sl = process_cell_slice(n, mesh.rank, mesh.world)
    return Cells(mesh, sl.start, sl.stop, n)


def cells_of(mesh: Optional[Mesh], n_local: int) -> Optional[Cells]:
    """The :class:`Cells` of this rank when each rank holds only its own
    ``n_local`` rows, in rank order: the offsets from one all_reduce of
    every rank's count. A rank without rows raises a ValueError on every
    rank."""
    if mesh is None or mesh.group is None:
        return None
    counts = torch.zeros(mesh.world, dtype=torch.int64, device=mesh.device)
    counts[mesh.rank] = int(n_local)
    dist.all_reduce(counts, group=mesh.group)
    counts = counts.cpu().tolist()
    if min(counts) == 0:  # every rank sees the same counts, so every rank raises
        raise ValueError(f"every rank of the mesh needs at least one cell; the ranks hold "
                         f"{counts} cells")
    start = sum(counts[: mesh.rank])
    return Cells(mesh, start, start + int(n_local), sum(counts))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _all_reduce(x, cells: Optional[Cells], op: str):
    if cells is None:
        return x
    mesh = cells.mesh
    if torch.is_tensor(x):
        t = torch.clone(x.detach(), memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=_OPS[op], group=mesh.group)
        return t
    arr = np.asarray(x)
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(mesh.device)
    dist.all_reduce(t, op=_OPS[op], group=mesh.group)
    out = t.cpu().numpy()
    return out if isinstance(x, np.ndarray) else out.item()


def all_sum(x, cells: Optional[Cells]):
    """``x`` summed over the ranks: a tensor (detached, a new one), a numpy
    array or a number (each through the rank's device and back)."""
    return _all_reduce(x, cells, "sum")


def all_max(x, cells: Optional[Cells]):
    """The elementwise maximum of ``x`` over the ranks (see :func:`all_sum`)."""
    return _all_reduce(x, cells, "max")


def all_min(x, cells: Optional[Cells]):
    """The elementwise minimum of ``x`` over the ranks (see :func:`all_sum`)."""
    return _all_reduce(x, cells, "min")


def gather_rows(local, cells: Optional[Cells]):
    """The (n, ...) tensor of every rank's rows from this rank's ``local``
    rows (start:stop): an all_reduce SUM of zero-filled buffers on the
    rank's device, each rank writing its own rows. A numpy array comes back
    as one."""
    if cells is None:
        return local
    host = not torch.is_tensor(local)
    t = torch.as_tensor(np.ascontiguousarray(local)) if host else local.detach()
    buf = torch.zeros((cells.n, *t.shape[1:]), dtype=t.dtype, device=cells.mesh.device)
    buf[cells.start : cells.stop] = t.to(cells.mesh.device)
    dist.all_reduce(buf, group=cells.mesh.group)
    if host:
        return buf.cpu().numpy()
    return buf.to(t.device)


def agree(cells: Optional[Cells], fn):
    """``fn()`` on every rank, and if it raised on any rank, an exception
    on every rank (the rank's own, or a RuntimeError naming the ranks that
    failed), so that no rank goes on to a collective the others never
    reach. Returns ``fn()``'s value."""
    if cells is None:
        return fn()
    error = None
    try:
        value = fn()
    except Exception as e:  # raised below, once every rank knows
        error = e
    failed = torch.zeros(cells.mesh.world, dtype=torch.int64, device=cells.mesh.device)
    failed[cells.mesh.rank] = error is not None
    dist.all_reduce(failed, group=cells.mesh.group)
    if error is not None:
        raise error
    if bool(failed.any()):
        ranks = torch.nonzero(failed).flatten().cpu().tolist()
        raise RuntimeError(f"the fit failed on rank(s) {ranks} of the mesh (see their error)")
    return value

"""The mesh of a distributed fit and the few collectives the fit uses.

The ranks of a fit form a (cells, genes) mesh: rank ``r`` of a ``cells x
genes`` world holds the block of rows ``r // genes`` (a :class:`Cells`)
and, of those rows, the block of Y's columns ``r % genes`` (a
:class:`Genes`), the layout of the JAX package's
``np.asarray(devices).reshape(cells, genes)``. A sum over cells is the
rank's own sum followed by an ``all_reduce`` over its cells group (the
ranks of its gene block); a sum over genes an ``all_reduce`` over its
genes group (the ranks of its cell block). Every collective here is an
``all_reduce`` (SUM, MAX or MIN) of a tensor on the rank's device: together
with ``broadcast`` the only collectives the gloo backend takes on CUDA
tensors, so one code path serves NCCL (one rank a card) and gloo (ranks
sharing a card, or on the CPU). Per-cell outputs are gathered by an
``all_reduce`` SUM of zero-filled global buffers, each rank writing its own
rows (:func:`gather_rows`), per-gene outputs likewise over the genes group
(:func:`gather_cols`).

Inside an autograd graph a partial sum over genes goes through
:func:`sum_over_genes` (the sum forward, the identity backward), and a
tensor every gene rank holds whole enters such a sum through
:func:`grad_sum_over_genes` (the identity forward, the sum of its
gradient backward): Megatron-LM's g and f.

Code that takes ``cells`` or ``genes`` (a handle, or None for a fit in one
process or a mesh without that axis) runs the same with and without a
mesh: every helper returns its input unchanged when the handle is None.
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
    it, its device and the process groups: ``group`` every rank's,
    ``cell_group`` the ranks of this rank's gene block (the sums over
    cells), ``gene_group`` the ranks of its cell block (the sums over
    genes); None in one process without a group (a world of one, which
    runs no collective)."""

    cells: int
    genes: int
    rank: int
    device: torch.device
    group: object = None
    cell_group: object = None
    gene_group: object = None

    @property
    def world(self) -> int:
        return self.cells * self.genes

    @property
    def shape(self) -> dict:
        return {CELL_AXIS: self.cells, GENE_AXIS: self.genes}

    @property
    def cell_coord(self) -> int:
        """This rank's block of the cells."""
        return self.rank // self.genes

    @property
    def gene_coord(self) -> int:
        """This rank's block of the genes."""
        return self.rank % self.genes


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a TypeError naming ``make_mesh``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a clonealign_torch.parallel.sharding.Mesh from make_mesh(), got "
            f"{type(mesh).__name__}")
    return mesh


def subgroups(cells: int, genes: int, rank: int, timeout=None):
    """``(cell_group, gene_group)`` of ``rank`` in a ``cells x genes``
    world: every group of both kinds is made on every rank, in the same
    order, as ``torch.distributed.new_group`` requires."""
    kw = {} if timeout is None else {"timeout": timeout}
    by_gene = [dist.new_group([c * genes + j for c in range(cells)], **kw) for j in range(genes)]
    by_cell = [dist.new_group([i * genes + j for j in range(genes)], **kw) for i in range(cells)]
    return by_gene[rank % genes], by_cell[rank // genes]


class Cells(NamedTuple):
    """This rank's block of a fit's cells: the global rows start:stop of
    ``n``, on a mesh whose cells group runs the collectives."""

    mesh: Mesh
    start: int
    stop: int
    n: int

    @property
    def group(self):
        return self.mesh.cell_group


class Genes(NamedTuple):
    """This rank's block of a fit's genes (Y's columns): the columns
    start:stop of ``g``, on a mesh whose genes group runs the
    collectives."""

    mesh: Mesh
    start: int
    stop: int
    g: int

    @property
    def group(self):
        return self.mesh.gene_group


class Shard(NamedTuple):
    """This rank's rows of a per-cell array, on its device, and where they
    lie among every rank's (``distributed.host_local_to_global``); ``cells``
    is None in one process without a group. ``genes``, when the array was
    split along Y's columns too, is the block of columns ``data`` holds."""

    data: torch.Tensor
    cells: Optional[Cells]
    genes: Optional[Genes] = None

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


def process_gene_slice(n_genes: int, coord: int, genes: int) -> slice:
    """The columns of ``n_genes`` genes that gene block ``coord`` of
    ``genes`` holds: contiguous blocks as :func:`process_cell_slice` cuts
    the rows, the last block taking the remainder."""
    return process_cell_slice(n_genes, coord, genes)


def block_of(mesh: Optional[Mesh], n: int) -> Optional[Cells]:
    """The :class:`Cells` of this rank when every rank holds all ``n`` cells
    and keeps its cell block's :func:`process_cell_slice`; None for a mesh
    without a group (or none). Fewer cells than cell blocks raise a
    ValueError on every rank."""
    if mesh is None or mesh.group is None:
        return None
    if n < mesh.cells:
        raise ValueError(f"{n} cells cannot be split over {mesh.cells} blocks of ranks: every "
                         f"rank of the mesh needs at least one cell")
    sl = process_cell_slice(n, mesh.cell_coord, mesh.cells)
    return Cells(mesh, sl.start, sl.stop, n)


def gene_block(mesh: Optional[Mesh], g: int) -> Optional[Genes]:
    """The :class:`Genes` of this rank among ``g`` genes (the kept ones of a
    fit): its gene block's :func:`process_gene_slice`; None for a mesh
    without a genes axis (or a group, or none). Fewer genes than gene
    blocks raise a ValueError on every rank (every rank counts the same
    genes)."""
    if mesh is None or mesh.group is None or mesh.genes == 1:
        return None
    if g < mesh.genes:
        raise ValueError(f"{g} genes cannot be split over {mesh.genes} blocks of ranks: every "
                         f"rank of the mesh needs at least one gene")
    sl = process_gene_slice(g, mesh.gene_coord, mesh.genes)
    return Genes(mesh, sl.start, sl.stop, g)


def cells_of(mesh: Optional[Mesh], n_local: int) -> Optional[Cells]:
    """The :class:`Cells` of this rank when each rank holds only its cell
    block's ``n_local`` rows, in block order (every rank of a block the
    same rows): the offsets from one all_reduce over the cells group of
    every block's count. A rank without rows raises a ValueError on every
    rank."""
    if mesh is None or mesh.group is None:
        return None
    counts = torch.zeros(mesh.cells, dtype=torch.int64, device=mesh.device)
    counts[mesh.cell_coord] = int(n_local)
    dist.all_reduce(counts, group=mesh.cell_group)
    counts = counts.cpu().tolist()
    if min(counts) == 0:  # every rank sees the same counts, so every rank raises
        raise ValueError(f"every rank of the mesh needs at least one cell; the ranks hold "
                         f"{counts} cells")
    start = sum(counts[: mesh.cell_coord])
    return Cells(mesh, start, start + int(n_local), sum(counts))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _all_reduce(x, handle, op: str):
    if handle is None:
        return x
    mesh = handle.mesh
    if torch.is_tensor(x):
        t = torch.clone(x.detach(), memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=_OPS[op], group=handle.group)
        return t
    arr = np.asarray(x)
    t = torch.as_tensor(np.ascontiguousarray(arr)).to(mesh.device)
    dist.all_reduce(t, op=_OPS[op], group=handle.group)
    out = t.cpu().numpy()
    return out if isinstance(x, np.ndarray) else out.item()


def all_sum(x, handle):
    """``x`` summed over the ranks of ``handle``'s group (a :class:`Cells`:
    over the cells; a :class:`Genes`: over the genes): a tensor (detached,
    a new one), a numpy array or a number (each through the rank's device
    and back)."""
    return _all_reduce(x, handle, "sum")


def all_max(x, handle):
    """The elementwise maximum of ``x`` over the ranks (see :func:`all_sum`)."""
    return _all_reduce(x, handle, "max")


def all_min(x, handle):
    """The elementwise minimum of ``x`` over the ranks (see :func:`all_sum`)."""
    return _all_reduce(x, handle, "min")


def gather_rows(local, cells: Optional[Cells]):
    """The (n, ...) tensor of every rank's rows from this rank's ``local``
    rows (start:stop): an all_reduce SUM over the cells group of
    zero-filled buffers on the rank's device, each rank writing its own
    rows. A numpy array comes back as one."""
    return _gather(local, cells, cells.n if cells is not None else 0, 0)


def gather_cols(local, genes: Optional[Genes], dim: int = 0):
    """The tensor of every gene block's entries along ``dim`` (g of them)
    from this rank's ``local`` ones (start:stop), over the genes group, as
    :func:`gather_rows` gathers rows: W, beta, qmu and the correlations
    whole on every rank."""
    return _gather(local, genes, genes.g if genes is not None else 0, dim)


def _gather(local, handle, n: int, dim: int):
    if handle is None:
        return local
    host = not torch.is_tensor(local)
    t = torch.as_tensor(np.ascontiguousarray(local)) if host else local.detach()
    t = t.movedim(dim, 0)
    buf = torch.zeros((n, *t.shape[1:]), dtype=t.dtype, device=handle.mesh.device)
    buf[handle.start : handle.stop] = t.to(handle.mesh.device)
    dist.all_reduce(buf, group=handle.group)
    buf = buf.movedim(0, dim)
    if host:
        return buf.cpu().numpy()
    return buf.to(t.device)


class _SumOverGenes(torch.autograd.Function):
    """g: the forward sums the partial values over the genes group; the
    backward is the identity (each gene rank's cotangent is the whole
    value's already)."""

    @staticmethod
    def forward(ctx, x, genes):
        return all_sum(x, genes)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GradSumOverGenes(torch.autograd.Function):
    """f: the identity forward; the backward sums the gradient over the
    genes group (each gene rank's is the gradient of its partial sums)."""

    @staticmethod
    def forward(ctx, x, genes):
        ctx.genes = genes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_sum(dy, ctx.genes), None


def sum_over_genes(x: torch.Tensor, genes: Optional[Genes]) -> torch.Tensor:
    """``x``, a sum over this rank's genes, summed over every gene block
    (the identity backward); ``x`` as it is without a genes axis."""
    return x if genes is None else _SumOverGenes.apply(x, genes)


def grad_sum_over_genes(x: torch.Tensor, genes: Optional[Genes]) -> torch.Tensor:
    """``x``, held whole by every gene rank, as it enters a sum over this
    rank's genes: its gradient there is summed over every gene block;
    ``x`` as it is without a genes axis."""
    return x if genes is None else _GradSumOverGenes.apply(x, genes)


def world_max(x, cells: Optional[Cells], genes: Optional[Genes]):
    """The elementwise maximum of ``x`` over every rank: over the cells,
    then over the genes."""
    return all_max(all_max(x, cells), genes)


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

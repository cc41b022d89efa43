"""Multi-process execution helpers (counterpart of
``clonealign_tpu/parallel/distributed.py``).

Every rank runs the same program, holds a tile of the counts (a block of
the cells, and on a mesh with a genes axis a block of their genes) and
takes part in the collectives of the fit (``sharding.py``). The helpers
wrap the steps; in one process without a group they degenerate to the
plain fit, so the same script runs anywhere::

    from clonealign_torch.parallel import distributed as dist
    dist.initialize()                  # reads torchrun's environment; False alone
    mesh = make_mesh(gene_parallelism=2)   # this rank's card, the groups
    Y_local = Y_all[dist.process_cell_slice(n_cells, mesh=mesh)]
    result = dist.distributed_fit(Y_local, L, mesh, n_restarts=10)

Unlike the JAX package's, whose genes axis stays inside a process, the
port's ranks are processes, so the genes axis crosses process boundaries:
every rank of a cell block passes that block's rows and keeps its gene
block's columns.

The backend is the caller's: "nccl" by default on CUDA (one rank a card),
"gloo" on the CPU, or "gloo" asked for where ranks share a card (NCCL
refuses two ranks on one GPU). An NCCL failure raises; nothing falls back
to gloo or moves a rank's fit to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from . import sharding
from .collectives import CELL_AXIS, GENE_AXIS, Shard, cells_of, check_mesh, gene_block
from .sharding import make_mesh, sharded_fit

__all__ = ["initialize", "host_local_to_global", "process_cell_slice", "distributed_fit",
           "Shard", "DEFAULT_TIMEOUT_SECONDS"]

# A collective that one rank never reaches raises after this long instead of
# hanging (the process group's timeout, :func:`initialize`'s default).
DEFAULT_TIMEOUT_SECONDS = 600


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    timeout_seconds: Optional[float] = None,
) -> bool:
    """Start the default process group (``torch.distributed``): True when a
    group of more than one rank is up, False for a single process.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` default to ``torchrun``'s environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with none of them set it
    does nothing and returns False. Given explicitly, a group of one is
    started too (its collectives run, on one rank). ``backend`` is "nccl"
    by default when CUDA is available, else "gloo". The group's timeout is
    ``timeout_seconds`` (default :data:`DEFAULT_TIMEOUT_SECONDS`), so a
    collective that one rank never reaches fails instead of hanging."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs coordinator_address, num_processes and process_id (or "
            "torchrun's MASTER_ADDR, WORLD_SIZE and RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    seconds = DEFAULT_TIMEOUT_SECONDS if timeout_seconds is None else timeout_seconds
    timeout = datetime.timedelta(seconds=seconds)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id), timeout=timeout)
    sharding.GROUP_TIMEOUT = timeout  # make_mesh's subgroups time out alike
    return dist.get_world_size() > 1


def process_cell_slice(n_cells_global: int, rank: Optional[int] = None,
                       world: Optional[int] = None, *, mesh=None) -> slice:
    """The half-open row range of the global cell axis owned by ``rank`` of
    ``world`` (by default this process's, from the process group; 0 of 1
    without one): equal contiguous blocks, the last rank taking the
    remainder. With ``mesh`` it is this rank's cell block's, of the mesh's
    cell blocks."""
    if mesh is not None:
        mesh = check_mesh(mesh)
        return collectives.process_cell_slice(int(n_cells_global), mesh.cell_coord, mesh.cells)
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    return collectives.process_cell_slice(int(n_cells_global), int(rank), int(world))


def host_local_to_global(local_array, mesh, spec=None) -> Shard:
    """This rank's rows of a per-cell array (each rank passes its cell
    block's, in block order) as a
    :class:`~clonealign_torch.parallel.collectives.Shard`: the rows on the
    rank's device, their offset and the global cell count (one all_reduce
    of every block's row count). :func:`sharded_fit` takes it in place of
    the whole matrix. ``spec`` is the JAX package's: the rows are split
    along the cells (``CELL_AXIS``), and with ``(CELL_AXIS, GENE_AXIS)``
    the columns along the genes too, so that only this rank's gene block
    goes to its device."""
    spec = (CELL_AXIS,) if spec is None else tuple(spec)
    if spec[:1] != (CELL_AXIS,) or any(a not in (None, GENE_AXIS) for a in spec[1:2]) or \
            any(a is not None for a in spec[2:]):
        raise ValueError(f"host_local_to_global splits the rows along {CELL_AXIS!r} and the "
                         f"columns along {GENE_AXIS!r} only, got {spec}")
    mesh = check_mesh(mesh)
    data = local_array if torch.is_tensor(local_array) else torch.as_tensor(np.asarray(local_array))
    genes = gene_block(mesh, data.shape[1]) if spec[1:2] == (GENE_AXIS,) else None
    if genes is not None:
        data = data[:, genes.start : genes.stop]
    return Shard(data.to(mesh.device), cells_of(mesh, data.shape[0]), genes)


def distributed_fit(Y_local, L, mesh=None, *, x_local=None, **fit_kwargs):
    """The multi-restart fit from each rank's own rows of the count matrix
    (its cell block's ``process_cell_slice`` of the global cell axis, in
    block order; every gene rank of a block passes the same rows): the
    rows are placed by :func:`host_local_to_global`, which keeps this
    rank's gene block of their columns, and the fit is
    :func:`~clonealign_torch.parallel.sharding.sharded_fit`'s, the same
    numbers as with the whole matrix on every rank
    (clonealign_tpu/parallel/distributed.py:115-124). ``mesh`` defaults to
    :func:`make_mesh`. Returns the stacked
    :class:`~clonealign_torch.infer.InferenceResult`; ``psi`` and
    ``gamma_logits`` hold this rank's rows, the per-gene fields every
    gene."""
    mesh = make_mesh() if mesh is None else mesh
    Y = host_local_to_global(Y_local, mesh, (CELL_AXIS, GENE_AXIS))
    x = None
    if x_local is not None:
        x_local = np.asarray(x_local, np.float64)
        x = host_local_to_global(x_local[:, None] if x_local.ndim == 1 else x_local, mesh)
    return sharded_fit(Y, np.asarray(L), mesh, x=x, **fit_kwargs)

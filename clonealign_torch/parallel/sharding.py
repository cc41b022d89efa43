"""Fits whose cells are split over ranks (counterpart of
``clonealign_tpu/parallel/sharding.py``).

The JAX package lays its devices out as a (cells, genes) mesh and lets
GSPMD insert the reductions. Here every rank is one process with one
device, holds a contiguous block of the cells (``process_cell_slice``) and
runs the fit on it, with the fused CUDA kernels on its own rows; the sums
over cells are the rank's sums and an ``all_reduce``
(``parallel/collectives.py``). The per-cell state (Y's rows, the size
factors, the statistics, the covariates and the allele term; psi and the
gamma logits) stays on its rank; the per-gene parameters are every rank's
and take the same steps. Every decision that reads all cells (the gene
filter, Y's storage, the likelihood, the restart batching, the z_cheb
range, the checks) is taken from global values, so no rank decides
differently from another.

The mesh's ``genes`` axis (tensor parallelism over Y's columns) is not
ported: ``make_mesh(gene_parallelism=2)`` raises. The JAX package's GSPMD
placements (``param_shardings``, ``constrain_params``,
``negbin_data_shardings``) have no counterpart: no placement is annotated,
each rank slices its rows by :func:`data_shardings` and
:func:`param_specs`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models import multinomial as mm
from ..models.multinomial import param_specs
from .collectives import CELL_AXIS, GENE_AXIS, Cells, Mesh, Shard, block_of, check_mesh

__all__ = ["CELL_AXIS", "GENE_AXIS", "Mesh", "make_mesh", "data_shardings", "param_specs",
           "shard_data", "shard_extra_log_lik", "sharded_fit", "sharded_negbin_fit"]


def make_mesh(
    devices: Optional[Sequence] = None,
    cell_parallelism: Optional[int] = None,
    gene_parallelism: int = 1,
) -> Mesh:
    """The (cells, genes) mesh of the running processes. Defaults to every
    rank on the cells axis. In one process without an initialized process
    group it is a world of one, which runs no collective: the fit is the
    plain fit.

    This rank's device is ``devices[rank]`` when ``devices`` (one per rank,
    or a single device for this rank) is given, else
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` as ``torchrun``
    sets it, else the rank): two ranks share the one card of a machine that
    has one. Pass ``devices="cpu"`` for the CPU.

    ``gene_parallelism`` > 1 (tensor parallelism over Y's columns) is not
    ported and raises NotImplementedError."""
    from ..api import _not_ported

    if int(gene_parallelism) != 1:
        raise _not_ported("a genes mesh axis (gene_parallelism > 1)", "distributed")
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    cells = world if cell_parallelism is None else int(cell_parallelism)
    if cells != world:
        raise ValueError(f"mesh {cells}x{gene_parallelism} != {world} ranks")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() places each rank on a CUDA device but torch.cuda.is_available() "
                "is false; pass devices='cpu' for the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    elif isinstance(devices, (str, torch.device)):
        device = torch.device(devices)
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    return Mesh(cells=cells, genes=1, rank=rank, device=device, group=group)


def data_shardings(mesh: Optional[Mesh] = None, has_x: bool = False,
                   has_colsum: bool = True) -> mm.ModelData:
    """For each field of ``ModelData``, the axes it is split along: a tuple
    with ``CELL_AXIS`` at the cells' dimension and None elsewhere (None for
    a field that is absent), as ``param_specs`` (``models/multinomial.py``)
    gives them for ``CloneAlignParams``. ``mesh`` is taken for the JAX
    package's call shape; the layout is the same on every mesh."""
    del mesh
    return mm.ModelData(
        Y=(CELL_AXIS, None),
        L=(None, None),
        X=(CELL_AXIS, None) if has_x else None,
        s=(CELL_AXIS,),
        log_binom=(CELL_AXIS,),
        YlogL=(CELL_AXIS, None),
        colsum_Y=(None,) if has_colsum else None,
    )


def _rows(x, cells: Optional[Cells]):
    """This rank's rows of a per-cell array given whole (every rank holds
    all cells), or of a :class:`~clonealign_torch.parallel.collectives.Shard`
    as it is."""
    if isinstance(x, Shard):
        return x.data
    if cells is None or x is None:
        return x
    return x[cells.start : cells.stop]


def shard_data(data: mm.ModelData, mesh: Mesh) -> mm.ModelData:
    """This rank's block of the cells of ``data`` (made from every cell):
    each field sliced along its :func:`data_shardings` axis."""
    cells = block_of(check_mesh(mesh), data.Y.shape[0])
    if cells is None:
        return data
    specs = data_shardings(mesh, data.X is not None, data.colsum_Y is not None)
    fields = {f: getattr(data, f) for f in ("Y", "L", "X", "s", "log_binom", "YlogL", "colsum_Y")}
    return mm.ModelData(**{f: _rows(t, cells) if t is not None and CELL_AXIS in getattr(specs, f)
                           else t for f, t in fields.items()}, cells=cells)


def shard_extra_log_lik(extra_log_lik, mesh: Mesh):
    """This rank's rows of the (N, C) allele term (models/allele.py): per-cell
    data like Y's rows, held only where its cells are."""
    if extra_log_lik is None:
        return None
    return _rows(extra_log_lik, block_of(check_mesh(mesh), extra_log_lik.shape[0]))


def _cells_of_input(Y, mesh: Mesh):
    """``(Y's rows on this rank, cells)``: a Shard's own rows, or this
    rank's block of a matrix every rank holds whole."""
    if isinstance(Y, Shard):
        return Y.data, Y.cells
    cells = block_of(mesh, Y.shape[0])
    return _rows(Y, cells), cells


def sharded_negbin_fit(Y, L, mesh: Mesh, rho_init=None, s=None, dtype="float32", stats=None,
                       **em_kwargs):
    """The legacy v1 negative-binomial VEM fit (``models/negbin.py``) with
    the cells split over the ranks of ``mesh``: Y (every cell on every rank,
    or a Shard of this rank's rows) and the size factors ``s`` are sliced
    to this rank's rows; the size factors' scale, the per-gene moments, the
    E-step's B, the M-step's gradients and the ELBO are every rank's sums,
    gamma stays on its rank. Returns the same
    :class:`~clonealign_torch.models.negbin.NegbinResult` as the one-process
    fit, with ``post.gamma`` this rank's rows. ``stats="cheb"`` switches
    the loop onto the Chebyshev path (``negbin_cheb_stats`` of every rank's
    cells)."""
    from ..models import negbin as nb
    from ..utils.device import resolve_dtype

    mesh = check_mesh(mesh)
    Y_rows, cells = _cells_of_input(Y, mesh)
    if s is not None:
        s = _rows(s, cells)
    dt = resolve_dtype(dtype, mesh.device)
    data = nb.prepare_negbin_data(Y_rows, L, s=s, device=mesh.device, dtype=dt, cells=cells)
    if stats == "cheb":
        stats = nb.negbin_cheb_stats(data)
    return nb.run_negbin_em(data, rho_init, stats, **em_kwargs)


def sharded_fit(
    Y,
    L,
    mesh: Mesh,
    n_restarts: int = 1,
    initial_shrinks=None,
    x=None,
    key=None,
    dtype: str = "float32",
    config: Optional[mm.ModelConfig] = None,
    data_init_mu=True,
    extra_log_lik=None,
    y_storage=None,
    seed: int = 0,
    noises=None,
    **infer_kwargs,
):
    """Multi-restart fit with the cells split over the ranks of ``mesh``,
    the restarts as lanes of one loop (``infer.run_inference_lanes``).
    Returns the stacked :class:`~clonealign_torch.infer.InferenceResult`
    over restarts; its per-cell fields (``psi``, ``gamma_logits``) hold this
    rank's rows, as each JAX process addresses its own shard.

    ``Y`` (and ``x``, ``extra_log_lik``) is the whole matrix on every rank,
    of which each rank keeps and uploads only its rows, or a
    :class:`~clonealign_torch.parallel.collectives.Shard` of this rank's
    rows (``distributed.host_local_to_global``). ``y_storage`` is a name of
    :func:`~clonealign_torch.clonealign`'s option ("auto" resolved from
    every rank's counts) or None for the compute dtype. Restart r draws from
    ``noises[r]``, by default ``Noise(seed + r)`` on the rank's device, the
    same on every rank; ``key`` (a JAX PRNG key) is refused. The keywords
    left go to the loop (``max_iter``, ``rel_tol``, ``learning_rate``,
    ``elbo_eval``; 200, 1e-6, 0.1, "fresh" as in the JAX package)."""
    from ..api import _check_reference_keywords, _resolve_storage
    from ..infer import run_inference_lanes, stack_lanes
    from ..utils.device import resolve_dtype
    from ..utils.noise import Noise

    _check_reference_keywords(key, "while")
    mesh = check_mesh(mesh)
    dev = mesh.device
    dt = resolve_dtype(dtype, dev)
    Y_rows, cells = _cells_of_input(Y, mesh)
    x_rows = None if x is None else _rows(x, cells)
    if x_rows is not None and not torch.is_tensor(x_rows):
        x_rows = np.asarray(x_rows, np.float64)
        x_rows = x_rows[:, None] if x_rows.ndim == 1 else x_rows
    extra = None if extra_log_lik is None else torch.as_tensor(
        _rows(extra_log_lik, cells), dtype=dt, device=dev)
    config = config or mm.ModelConfig(K=1, P=0 if x_rows is None else x_rows.shape[1])
    if not torch.is_tensor(Y_rows) and not hasattr(Y_rows, "tocsr"):
        Y_rows = np.asarray(Y_rows)
    storage = _resolve_storage(y_storage or "float32", Y_rows, cells)
    data = mm.prepare_data(Y_rows, np.asarray(L), x_rows, device=dev, dtype=dt,
                           y_storage=storage, cells=cells)

    if initial_shrinks is None:
        shrinks = np.full(int(n_restarts), 5.0)
    else:
        shrinks = np.asarray(initial_shrinks, np.float64).reshape(-1)
    R = len(shrinks)
    noises = [Noise(int(seed) + r, dev) for r in range(R)] if noises is None else list(noises)
    pca = (mm.pca_init_scores(data.Y, config.K, noises[0], dt, cells=cells)
           if config.K > 0 else None)
    mu_guess = None
    if isinstance(data_init_mu, (bool, np.bool_)):
        mu_guess = mm.data_mu_guess(data.Y, dt, cells=cells) if data_init_mu else None
    params0 = [mm.init_params(data.Y, data.L, noise, K=config.K, data_init_mu=data_init_mu,
                              dtype=dt, pca_scores=pca, mu_guess=mu_guess, P=config.P,
                              cells=cells)
               for noise in noises]
    loop = dict(max_iter=200, rel_tol=1e-6, learning_rate=0.1, elbo_eval="fresh")
    loop.update(infer_kwargs)
    return run_inference_lanes(stack_lanes(params0), data, noises, config,
                               initial_shrinks=shrinks, extra_log_lik=extra, **loop)

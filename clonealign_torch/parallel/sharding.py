"""Fits whose cells and genes are split over ranks (counterpart of
``clonealign_tpu/parallel/sharding.py``).

The JAX package lays its devices out as a (cells, genes) mesh and lets
GSPMD insert the reductions. Here every rank is one process with one
device, holds a tile of Y, its cell block's rows (``process_cell_slice``)
restricted to its gene block's columns (``process_gene_slice``), and runs
the fit on it, with the fused CUDA kernels on its own tile. A sum over
cells is the rank's sum and an ``all_reduce`` over its cells group, a sum
over genes the same over its genes group (``parallel/collectives.py``):
the fused op's A1, A2 and Z, z_cheb's products with Y and its node table,
and the global ELBO terms' per-gene sums reduce over the genes before the
per-(clone, cell) normalization, and psi's gradient from the fused op is
summed over the genes group. The per-cell state (the size factors, the
statistics, the covariates and the allele term; psi and the gamma logits)
is its cell block's, the same on every gene rank of the block; the
per-gene parameters (W, beta, qmu) are the gene block's and take the same
steps on every cell rank of it. Every decision that reads all cells or
genes (the gene filter, Y's storage, the likelihood, the restart
batching, the z_cheb range, the checks) is taken from global values, so
no rank decides differently from another.

The JAX package's GSPMD placements (``param_shardings``,
``constrain_params``, ``negbin_data_shardings``) have no counterpart: no
placement is annotated, each rank slices its tile by
:func:`data_shardings` and :func:`param_specs`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models import multinomial as mm
from ..models.multinomial import param_specs
from .collectives import (CELL_AXIS, GENE_AXIS, Cells, Genes, Mesh, Shard, block_of,
                          check_mesh, gather_cols, gene_block, subgroups)

__all__ = ["CELL_AXIS", "GENE_AXIS", "Mesh", "make_mesh", "data_shardings", "param_specs",
           "shard_data", "shard_extra_log_lik", "sharded_fit", "sharded_negbin_fit"]


# The timeout of the subgroups make_mesh creates: ``distributed.initialize``
# sets it to its process group's, so that a collective one rank never
# reaches fails on a subgroup as on the world.
GROUP_TIMEOUT = None


def make_mesh(
    devices: Optional[Sequence] = None,
    cell_parallelism: Optional[int] = None,
    gene_parallelism: int = 1,
) -> Mesh:
    """The (cells, genes) mesh of the running processes: rank r at cell
    block ``r // gene_parallelism`` and gene block ``r % gene_parallelism``,
    as the JAX package reshapes its devices. Defaults to every rank on the
    cells axis. In one process without an initialized process group it is
    a world of one, which runs no collective: the fit is the plain fit.
    With a group, every rank makes the mesh's cells and genes groups
    (:func:`~clonealign_torch.parallel.collectives.subgroups`), so every
    rank must call this alike.

    This rank's device is ``devices[rank]`` when ``devices`` (one per rank,
    or a single device for this rank) is given, else
    ``cuda:{local_rank % device_count}`` (``LOCAL_RANK`` as ``torchrun``
    sets it, else the rank): two ranks share the one card of a machine that
    has one. Pass ``devices="cpu"`` for the CPU."""
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    rank = dist.get_rank() if group is not None else 0
    genes = int(gene_parallelism)
    cells = world // max(genes, 1) if cell_parallelism is None else int(cell_parallelism)
    if genes < 1 or cells * genes != world:
        raise ValueError(f"mesh {cells}x{genes} != {world} ranks")
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
    cell_group = gene_group = None
    if group is not None:
        cell_group, gene_group = subgroups(cells, genes, rank, GROUP_TIMEOUT)
    return Mesh(cells=cells, genes=genes, rank=rank, device=device, group=group,
                cell_group=cell_group, gene_group=gene_group)


def data_shardings(mesh: Optional[Mesh] = None, has_x: bool = False,
                   has_colsum: bool = True) -> mm.ModelData:
    """For each field of ``ModelData``, the axes it is split along: a tuple
    with ``CELL_AXIS`` at the cells' dimension, ``GENE_AXIS`` at the genes'
    and None elsewhere (None for a field that is absent), as
    ``param_specs`` (``models/multinomial.py``) gives them for
    ``CloneAlignParams`` (clonealign_tpu/parallel/sharding.py:59-78).
    ``mesh`` is taken for the JAX package's call shape; the layout is the
    same on every mesh."""
    del mesh
    return mm.ModelData(
        Y=(CELL_AXIS, GENE_AXIS),
        L=(GENE_AXIS, None),
        X=(CELL_AXIS, None) if has_x else None,
        s=(CELL_AXIS,),
        log_binom=(CELL_AXIS,),
        YlogL=(CELL_AXIS, None),
        colsum_Y=(GENE_AXIS,) if has_colsum else None,
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


def _cols(x, genes: Optional[Genes], dim: int = 0):
    """This rank's block of a per-gene array given whole, along ``dim``."""
    if genes is None or x is None:
        return x
    return x[(slice(None),) * dim + (slice(genes.start, genes.stop),)]


def shard_data(data: mm.ModelData, mesh: Mesh) -> mm.ModelData:
    """This rank's tile of ``data`` (made from every cell and gene): each
    field sliced along its :func:`data_shardings` axes."""
    cells = block_of(check_mesh(mesh), data.Y.shape[0])
    if cells is None:
        return data
    genes = gene_block(mesh, data.Y.shape[1])
    specs = data_shardings(mesh, data.X is not None, data.colsum_Y is not None)

    def tile(t, spec):
        if t is None:
            return t
        if CELL_AXIS in spec:
            t = _rows(t, cells)
        return _cols(t, genes, spec.index(GENE_AXIS)) if GENE_AXIS in spec else t

    fields = ("Y", "L", "X", "s", "log_binom", "YlogL", "colsum_Y")
    return mm.ModelData(**{f: tile(getattr(data, f), getattr(specs, f)) for f in fields},
                        cells=cells, genes=genes)


def shard_extra_log_lik(extra_log_lik, mesh: Mesh):
    """This rank's rows of the (N, C) allele term (models/allele.py): per-cell
    data like Y's rows, held only where its cells are (every gene rank of
    the block alike)."""
    if extra_log_lik is None:
        return None
    return _rows(extra_log_lik, block_of(check_mesh(mesh), extra_log_lik.shape[0]))


def _tile_of_input(Y, mesh: Mesh):
    """``(Y's tile on this rank, cells, genes)``: a Shard's own tile, or
    this rank's rows and gene block of a matrix every rank holds whole. A
    Shard of whole rows is cut to the gene block here."""
    if isinstance(Y, Shard):
        if Y.genes is not None:
            return Y.data, Y.cells, Y.genes
        genes = gene_block(mesh, Y.data.shape[1])
        return _cols(Y.data, genes, 1), Y.cells, genes
    cells = block_of(mesh, Y.shape[0])
    genes = gene_block(mesh, Y.shape[1])
    return _cols(_rows(Y, cells), genes, 1), cells, genes


def _per_gene(result, fn):
    """A NegbinResult with ``fn`` applied to each per-gene field: the
    rates, r and Adam's moments."""
    st = result.opt_state
    return result._replace(
        params=result.params._replace(**{f: fn(getattr(result.params, f))
                                         for f in ("log_mu", "log_beta", "log_phi")}),
        post=result.post._replace(r=fn(result.post.r)),
        opt_state=None if st is None else st._replace(mu=tuple(map(fn, st.mu)),
                                                      nu=tuple(map(fn, st.nu))))


def sharded_negbin_fit(Y, L, mesh: Mesh, rho_init=None, s=None, dtype="float32", stats=None,
                       **em_kwargs):
    """The legacy v1 negative-binomial VEM fit (``models/negbin.py``) with
    the cells and genes split over the ranks of ``mesh``: Y (every cell on
    every rank, or a Shard of this rank's rows) is cut to this rank's tile,
    L, ``rho_init`` and ``resume_from``'s per-gene fields to its gene
    block, the size factors ``s`` to its rows; the size factors' scale,
    the per-gene moments, the E-step's A and B, the M-step's gradients and
    the ELBO are every rank's sums, gamma stays on its cell block (JAX:
    ``negbin_data_shardings``). Returns the same
    :class:`~clonealign_torch.models.negbin.NegbinResult` as the
    one-process fit, with ``post.gamma`` this rank's rows and the per-gene
    fields whole. ``stats="cheb"`` switches the loop onto the Chebyshev
    path (``negbin_cheb_stats`` of every rank's tile)."""
    from ..models import negbin as nb
    from ..utils.device import resolve_dtype

    mesh = check_mesh(mesh)
    Y_tile, cells, genes = _tile_of_input(Y, mesh)
    if s is not None:
        s = _rows(s, cells)
    dt = resolve_dtype(dtype, mesh.device)
    L = _cols(L.detach().cpu().numpy() if torch.is_tensor(L) else np.asarray(L), genes)
    data = nb.prepare_negbin_data(Y_tile, L, s=s, device=mesh.device, dtype=dt, cells=cells,
                                  genes=genes)
    if stats == "cheb":
        stats = nb.negbin_cheb_stats(data)
    if rho_init is not None:
        rho_init = _cols(rho_init if torch.is_tensor(rho_init) else np.asarray(rho_init), genes)
    if genes is None:
        return nb.run_negbin_em(data, rho_init, stats, **em_kwargs)
    if em_kwargs.get("resume_from") is not None:
        em_kwargs["resume_from"] = _per_gene(em_kwargs["resume_from"], lambda t: _cols(t, genes))
    result = nb.run_negbin_em(data, rho_init, stats, **em_kwargs)
    return _per_gene(result, lambda t: gather_cols(t, genes))


def gather_params(params: mm.CloneAlignParams, genes: Optional[Genes]) -> mm.CloneAlignParams:
    """``params``' per-gene fields (W, beta, qmu, with or without a lane
    axis) gathered over the genes group: whole on every rank."""
    if genes is None:
        return params
    return params.replace(**{f: gather_cols(getattr(params, f), genes, dim=spec.index(GENE_AXIS))
                             for f, spec in vars(param_specs(params.qmu_loc.dim() == 2)).items()
                             if GENE_AXIS in spec})


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
    """Multi-restart fit with the cells and genes split over the ranks of
    ``mesh``, the restarts as lanes of one loop
    (``infer.run_inference_lanes``). Returns the stacked
    :class:`~clonealign_torch.infer.InferenceResult` over restarts; its
    per-cell fields (``psi``, ``gamma_logits``) hold this rank's rows, as
    each JAX process addresses its own shard, and its per-gene fields (W,
    beta, qmu) every gene, gathered over the genes group.

    ``Y`` (and ``x``, ``extra_log_lik``) is the whole matrix on every rank,
    of which each rank keeps and uploads only its tile (its rows, its gene
    block's columns), or a
    :class:`~clonealign_torch.parallel.collectives.Shard` of this rank's
    rows (``distributed.host_local_to_global``). ``y_storage`` is a name of
    :func:`~clonealign_torch.clonealign`'s option ("auto" resolved from
    every rank's counts) or None for the compute dtype. Restart r draws from
    ``noises[r]``, by default ``Noise(seed + r)`` on the rank's device, the
    same on every rank (every draw over genes made whole and sliced);
    ``key`` (a JAX PRNG key) is refused. The keywords left go to the loop
    (``max_iter``, ``rel_tol``, ``learning_rate``, ``elbo_eval``; 200,
    1e-6, 0.1, "fresh" as in the JAX package)."""
    from ..api import _check_reference_keywords, _resolve_storage
    from ..infer import run_inference_lanes, stack_lanes
    from ..utils.device import resolve_dtype
    from ..utils.noise import Noise

    _check_reference_keywords(key, "while")
    mesh = check_mesh(mesh)
    dev = mesh.device
    dt = resolve_dtype(dtype, dev)
    Y_tile, cells, genes = _tile_of_input(Y, mesh)
    x_rows = None if x is None else _rows(x, cells)
    if x_rows is not None and not torch.is_tensor(x_rows):
        x_rows = np.asarray(x_rows, np.float64)
        x_rows = x_rows[:, None] if x_rows.ndim == 1 else x_rows
    extra = None if extra_log_lik is None else torch.as_tensor(
        _rows(extra_log_lik, cells), dtype=dt, device=dev)
    config = config or mm.ModelConfig(K=1, P=0 if x_rows is None else x_rows.shape[1])
    if not torch.is_tensor(Y_tile) and not hasattr(Y_tile, "tocsr"):
        Y_tile = np.asarray(Y_tile)
    storage = _resolve_storage(y_storage or "float32", Y_tile, cells, genes)
    data = mm.prepare_data(Y_tile, _cols(np.asarray(L), genes), x_rows, device=dev, dtype=dt,
                           y_storage=storage, cells=cells, genes=genes)

    if initial_shrinks is None:
        shrinks = np.full(int(n_restarts), 5.0)
    else:
        shrinks = np.asarray(initial_shrinks, np.float64).reshape(-1)
    R = len(shrinks)
    noises = [Noise(int(seed) + r, dev) for r in range(R)] if noises is None else list(noises)
    pca = (mm.pca_init_scores(data.Y, config.K, noises[0], dt, cells=cells, genes=genes)
           if config.K > 0 else None)
    mu_guess = None
    if isinstance(data_init_mu, (bool, np.bool_)):
        mu_guess = (mm.data_mu_guess(data.Y, dt, cells=cells, genes=genes) if data_init_mu
                    else None)
    params0 = [mm.init_params(data.Y, data.L, noise, K=config.K, data_init_mu=data_init_mu,
                              dtype=dt, pca_scores=pca, mu_guess=mu_guess, P=config.P,
                              cells=cells, genes=genes)
               for noise in noises]
    loop = dict(max_iter=200, rel_tol=1e-6, learning_rate=0.1, elbo_eval="fresh")
    loop.update(infer_kwargs)
    result = run_inference_lanes(stack_lanes(params0), data, noises, config,
                                 initial_shrinks=shrinks, extra_log_lik=extra, **loop)
    return result._replace(params=gather_params(result.params, genes))

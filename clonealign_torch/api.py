"""Public fit API: ``clonealign(...)`` (reference R/clonealign.R:184-305),
counterpart of ``clonealign_tpu/api.py``.

Parameter names and defaults match the JAX package, plus ``device``
("cuda" by default, or "cpu"; there is no fallback from one to the other)
and an injectable ``noise`` source. This port covers a dense or scipy
sparse count matrix, with or without covariates ``x`` (on CUDA K + P <= 4)
and allele data (``clone_allele``, ``cov``, ``ref``: the beta-binomial SNV
term, with the intended ``alt = cov - ref``), the exact likelihood (on CUDA
through the hand-written kernels) or the Chebyshev normalizer
(``likelihood_impl="z_cheb"``, K = 1 without covariates), Y stored as
``y_storage`` says (the compute dtype, int16, int8 or bfloat16; "auto"
picks the narrowest exact integer type). Every other option raises
NotImplementedError naming its ROADMAP item; none falls back silently.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from . import assign as _assign
from .fit import ClonealignFit, ConvergenceInfo
from .infer import run_inference
from .models import multinomial as mm
from .models.allele import construct_ai_likelihood, sanitize_allele_info, snv_clone_probs
from .ops.fused_likelihood import WIDE_MAX_A2, WIDE_MAX_KF, WIDE_MAX_SC
from .parallel.collectives import (Cells, Genes, agree, all_max, all_min, all_sum, block_of,
                                   gather_cols, gather_rows, gene_block, world_max)
from .utils.chunking import host_row_chunk as _host_row_chunk
from .utils.device import resolve_device, resolve_dtype, synchronize
from .utils.noise import Noise
from .utils.sparsity import is_scipy_sparse as _is_scipy_sparse


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to clonealign_torch yet (ROADMAP.md, "
        f"still to port: {item})"
    )


def saturate(x, threshold=4):
    """Clip copy numbers above threshold (reference R/clonealign.R:394-397)."""
    return np.minimum(np.asarray(x, np.float64), float(threshold))


def _parse_expression(gene_expression_data):
    """Accept a cell-by-gene array, an ExampleSCE-style object with
    ``.counts``/names, or an AnnData-style object with ``.X``
    (reference R/clonealign.R:212-224 accepts SCE or matrix).

    scipy sparse matrices (direct or as AnnData ``.X``) are kept sparse —
    statistics and the device upload are computed from the sparse structure
    without a host-side N x G float64 densification."""
    gene_names = cell_names = None
    obj = gene_expression_data
    if hasattr(obj, "counts"):
        Y = np.asarray(obj.counts)
        gene_names = list(getattr(obj, "gene_names", None) or [])
        cell_names = list(getattr(obj, "cell_names", None) or [])
    elif hasattr(obj, "X"):  # AnnData duck-type
        X = obj.X
        Y = _canonical_csr(X) if _is_scipy_sparse(X) else np.asarray(X)
        if hasattr(obj, "var_names"):
            gene_names = [str(g) for g in obj.var_names]
        if hasattr(obj, "obs_names"):
            cell_names = [str(c) for c in obj.obs_names]
    elif _is_scipy_sparse(obj):
        Y = _canonical_csr(obj)
    elif hasattr(obj, "todense"):  # other COOMatrix-style duck-types
        Y = np.asarray(obj.todense())
    else:
        Y = np.asarray(obj)
    if Y.ndim != 2:
        raise ValueError("gene_expression_data must be a 2-D cell-by-gene matrix")
    # Keep the INPUT dtype: a float64 N x G copy here would peak 16 GB of
    # host RAM for a 1M x 2k int16 matrix (VERDICT r2 weak item 4). All
    # validation and statistics downstream run chunk-wise at input dtype;
    # only non-numeric (object/bool/...) arrays are converted.
    if not _is_scipy_sparse(Y) and not (
        np.issubdtype(Y.dtype, np.integer) or np.issubdtype(Y.dtype, np.floating)
    ):
        Y = Y.astype(np.float64)
    return Y, gene_names or None, cell_names or None


def _canonical_csr(Y):
    """A scipy sparse matrix as a canonical CSR: sorted indices, each
    (cell, gene) stored once, so that its stored values are its counts. A
    canonical CSR is returned as it is; anything else (COO, CSC, a CSR with
    duplicate entries) becomes a copy with its duplicates summed. The copy's
    values are widened first, to int64 or float64, because scipy sums
    duplicates in the values' own dtype: two stored int8 100s would wrap.
    The caller's ``indptr``, ``indices`` and ``data`` are never written."""
    if Y.format == "csr" and Y.has_canonical_format:
        return Y
    wide = np.float64 if np.issubdtype(Y.dtype, np.floating) else np.int64
    out = Y.astype(wide, copy=True).tocsr()
    out.sum_duplicates()
    return out


def _colsum_f64(Y) -> np.ndarray:
    """Per-gene count totals, accumulated in float64 over row chunks at the
    input dtype (no full-matrix temporary); a sparse matrix's from its
    stored entries (reference api.py:82-93)."""
    if _is_scipy_sparse(Y):
        return np.asarray(Y.sum(axis=0, dtype=np.float64)).ravel()
    N, G = Y.shape
    acc = np.zeros(G, np.float64)
    for i in range(0, N, _host_row_chunk(G)):
        acc += Y[i : i + _host_row_chunk(G)].sum(axis=0, dtype=np.float64)
    return acc


_FRACTIONAL_MSG = (
    "gene_expression_data must contain raw integer counts — clonealign's "
    "model is a count likelihood, and the reference API takes the counts "
    "assay specifically (reference R/clonealign.R:212-224). Found fractional "
    "values, which usually means normalized/log-transformed data (e.g. "
    "scanpy's adata.X after normalization). Pass the raw counts instead "
    "(AnnData users: adata.layers['counts'] or adata.raw.X), or set "
    "allow_fractional=True to fit the fractional values anyway."
)


def _validate_counts(Y, allow_fractional: bool = False) -> None:
    """NaN/inf, negativity, integrality, and zero-count-cell checks
    (reference R/inference-tflow.R:212-214; the integrality check enforces
    the reference's counts-assay contract, R/clonealign.R:212-224) —
    chunk-wise so no full-size boolean/temporary is ever allocated; a sparse
    matrix's over its stored entries and row sums, O(nnz) (reference
    api.py:105-130)."""
    if _is_scipy_sparse(Y):
        v = Y.data
        floating = np.issubdtype(v.dtype, np.floating)
        if floating and not np.isfinite(v).all():
            raise ValueError("gene_expression_data contains NaN/inf values")
        if v.size and (v < 0).any():
            raise ValueError("gene_expression_data must be non-negative raw counts")
        if floating and not allow_fractional and np.any(v != np.trunc(v)):
            raise ValueError(_FRACTIONAL_MSG)
        if (np.asarray(Y.sum(axis=1, dtype=np.float64)).ravel() == 0).any():
            raise ValueError("Some cells have no counts mapping")  # R/inference-tflow.R:212-214
        return
    N, G = Y.shape
    check_finite = np.issubdtype(Y.dtype, np.floating)
    zero_cell = False
    for i in range(0, N, _host_row_chunk(G)):
        c = Y[i : i + _host_row_chunk(G)]
        if check_finite and not np.isfinite(c).all():
            raise ValueError("gene_expression_data contains NaN/inf values")
        if (c < 0).any():
            raise ValueError("gene_expression_data must be non-negative raw counts")
        if check_finite and not allow_fractional and np.any(c != np.trunc(c)):
            raise ValueError(_FRACTIONAL_MSG)
        if (c.sum(axis=1, dtype=np.float64) == 0).any():
            zero_cell = True
    if zero_cell:
        raise ValueError("Some cells have no counts mapping")  # R/inference-tflow.R:212-214


def _parse_copy_number(copy_number_data, G):
    """Accept (G, C) array or pandas-like with named clone columns
    (reference R/clonealign.R:237-254)."""
    clone_names = None
    obj = copy_number_data
    if hasattr(obj, "columns") and hasattr(obj, "values"):  # pandas-like
        clone_names = [str(c) for c in obj.columns]
        L = np.asarray(obj.values, np.float64)
    elif isinstance(obj, dict):
        clone_names = [str(c) for c in obj.keys()]
        L = np.stack([np.asarray(v, np.float64) for v in obj.values()], axis=1)
    else:
        L = np.asarray(obj, np.float64)
    if L.ndim == 1:
        L = L[:, None]
    if L.shape[0] != G:
        raise ValueError(
            "copy_number_data must have same number of genes (rows) as "
            f"gene_expression_data: got {L.shape[0]} vs {G}"
        )
    if clone_names is None:
        clone_names = _default_clone_names(L.shape[1])
    return L, clone_names


def _default_clone_names(C: int):
    """Reference default: clone_a, clone_b, ... (R/clonealign.R:252-254)."""
    import string

    letters = string.ascii_lowercase
    return ["clone_" + (letters[i] if i < 26 else str(i)) for i in range(C)]


@dataclasses.dataclass
class FitContext:
    """Parsed, filtered inputs on the device, shared by single- and
    multi-restart fits."""

    Y: object                # (N, G) filtered host counts, input dtype: numpy or scipy CSR
    L: np.ndarray            # (G, C) saturated copy numbers
    clone_names: list
    retained_genes: list
    config: mm.ModelConfig
    data: mm.ModelData
    dtype: torch.dtype
    device: torch.device
    data_init_mu: object
    extra_log_lik: Optional[torch.Tensor] = None  # (N, C) allele term on the device, or None
    clone_probs_from_snv: Optional[np.ndarray] = None  # (N, C) softmax of it, on the host
    # on a mesh, this rank's block of the cells: Y, data's per-cell fields
    # and extra_log_lik are its rows (clone_probs_from_snv is every cell's)
    cells: Optional[Cells] = None
    # on a mesh with a genes axis, this rank's block of the kept genes: Y, L
    # and data's per-gene fields are its columns (retained_genes is every
    # kept gene)
    genes: Optional[Genes] = None


# y_storage -> the storage dtype of the device Y (None: the compute dtype).
# int16 and int8 hold counts exactly (prepare_data raises on a count out of
# range); bfloat16 rounds counts above 256.
_Y_STORAGE = {
    None: None,
    "auto": "auto",
    "float32": None,
    "bfloat16": torch.bfloat16,
    "int16": torch.int16,
    "int8": torch.int8,
}


def _auto_y_storage(y_values, cells: Optional[Cells] = None, genes: Optional[Genes] = None):
    """``y_storage="auto"``: the narrowest exact storage for the counts, int8
    when every count fits, int16 up to 32767, else None (the compute dtype),
    and None for fractional counts (reference api.py:185-210). Integer
    storage is lossless, so "auto" never changes a result.

    The rule holds on the card too: there the kernels read narrow Y faster
    than float32 Y, and the inference holds less. ``chip_smoke.py`` on an
    H100 80GB HBM3 at 700 W, 100,000 x 5,000 x 10 clones: the forward 0.716
    ms at int8 and 0.769 at int16 against 0.887, the backward's gene part
    0.940 and 0.955 against 0.954; the ten-lane exact sweep 2.71-2.78 ms a
    lane-iteration at int8 against 2.93-2.95, its inference peak 1.28 GB
    against 2.79.

    On a mesh (``cells``, ``genes``) the counts are this rank's tile, and
    the largest count and whether any is fractional are every rank's, so
    every rank stores Y alike."""
    ymax, fractional = _count_range(y_values)
    if cells is not None:
        ymax, fractional = world_max(np.array([ymax, fractional], np.float64), cells, genes)
    if fractional or ymax == -np.inf:
        return None
    if ymax <= np.iinfo(np.int8).max:
        return torch.int8
    if ymax <= np.iinfo(np.int16).max:
        return torch.int16
    return None


def _count_range(y_values):
    """``(largest count, whether any count is fractional)`` of a numpy array
    or a tensor; -inf for no counts."""
    if torch.is_tensor(y_values):
        if not y_values.numel():
            return -np.inf, False
        fractional = y_values.is_floating_point() and bool(
            torch.any(y_values != torch.trunc(y_values)))
        return float(y_values.max()), fractional
    if y_values.size == 0:
        return -np.inf, False
    if np.issubdtype(y_values.dtype, np.integer):
        return float(y_values.max()), False
    # chunked integrality scan: no full-size temporaries
    flat = y_values.reshape(-1)
    ymax = -np.inf
    step = 16_777_216
    for i in range(0, flat.size, step):
        c = flat[i : i + step]
        if np.any(c != np.trunc(c)):
            return ymax, True
        ymax = max(ymax, float(c.max()))
    return ymax, False


def _check_reference_keywords(key, loop_impl) -> None:
    """The JAX package's keywords: ``key`` has no counterpart here (every
    draw comes from ``seed`` or a ``noise`` source); ``loop_impl`` "while"
    and "scan" give the same results, so both run the one loop."""
    if key is not None:
        raise ValueError(
            "key (a JAX PRNG key) is not taken by clonealign_torch: pass "
            "seed=<int>, or to clonealign a noise source "
            "(clonealign_torch.utils.noise.Noise)"
        )
    if loop_impl not in ("while", "scan"):
        raise ValueError(f"loop_impl must be 'while' or 'scan', got {loop_impl!r}")


def _check_kernel_contract(device: torch.device, K: int, mc_samples: int, C: int,
                           P: int = 0) -> None:
    """On CUDA the likelihood kernels (past the narrow ones' limits, the wide
    family) take at most WIDE_MAX_KF columns of ``[psi, X]`` (K latent
    factors and P covariates), WIDE_MAX_A2 Monte Carlo samples and
    WIDE_MAX_SC sample x clone columns; refuse wider fits before any data
    reaches the card. z_cheb fits are held to the same limits: their final
    ELBO runs the exact kernels."""
    if device.type != "cuda":
        return
    if K + P > WIDE_MAX_KF or mc_samples > WIDE_MAX_A2 or mc_samples * C > WIDE_MAX_SC:
        raise _not_ported(
            f"a fit on CUDA with K={K}, P={P} covariates, mc_samples={mc_samples} and "
            f"{C} clones (the kernels take K + P <= {WIDE_MAX_KF}, mc_samples <= "
            f"{WIDE_MAX_A2} and mc_samples x clones <= {WIDE_MAX_SC})",
            "wide kernel contract",
        )


def _parse_covariates(x, N: int):
    """``x`` as the reference reads it (reference api.py:334-342): float64 on
    the host, a 1-D array as one column, N rows or a ValueError; None stays
    None."""
    if x is None:
        return None
    x = np.asarray(x, np.float64)
    if x.ndim == 1:
        x = x[:, None]
    if x.shape[0] != N:
        raise ValueError(f"x must have {N} rows (cells)")
    return x


def _resolve_auto_impl(K, mc_samples, dtype, n_elements, P=0) -> str:
    """``likelihood_impl="auto"``: the exact likelihood at every size.

    The JAX package (api.py:213-239) resolves "auto" to z_cheb in the K=1 /
    no-covariate / one-sample / float32 corner from 1M retained N x G
    elements, because on its TPU the Chebyshev normalizer was the faster
    step. On the card it is not: a full-width (100,000 x 5,000 x 10) single
    fit took 11.10-17.02 ms per iteration under z_cheb against 7.41-12.03
    ms under the exact kernels, in turns in each of three runs
    (``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W). The loop is
    bound by the host, and the Clenshaw recurrence and its backward issue
    about 300 small kernels an iteration where the fused kernels issue
    three. So no size opens the corner; z_cheb is there when asked for
    (lane-batched sweeps amortize its launches: PERF.md). The arguments are
    the reference's (P last), so that a later gate can use them."""
    del K, mc_samples, dtype, n_elements, P
    return "xla"


def _check_options(P, y_storage, likelihood_impl, K, mc_samples, fix_alpha):
    if likelihood_impl not in ("auto", "xla", "z_cheb"):
        raise ValueError(
            "likelihood_impl must be one of 'auto', 'xla', 'z_cheb'; "
            f"got {likelihood_impl!r}"
        )
    # a configuration error surfaces before the host validation and upload
    mm._use_z_cheb(mm.ModelConfig(K=K, P=P, mc_samples=int(mc_samples), fix_alpha=fix_alpha,
                                  likelihood_impl=likelihood_impl))
    if y_storage not in _Y_STORAGE:
        raise ValueError(
            "y_storage must be one of 'auto', 'float32', 'int16', 'int8', "
            f"'bfloat16'; got {y_storage!r}"
        )


def _parse_inputs(gene_expression_data, copy_number_data, x, K, mc_samples, fix_alpha,
                  y_storage, likelihood_impl, device, verbose):
    """The host side of setup that every fit shares (``setup_fit`` and
    ``stream.fit_streaming``): the counts (:func:`_parse_expression`), the
    covariates, the option checks, the copy numbers and, on CUDA, the
    kernels' contract. Returns ``(Y, gene_names, L, clone_names, x, P)``."""
    Y, gene_names, _cell_names = _parse_expression(gene_expression_data)
    x = _parse_covariates(x, Y.shape[0])
    P = 0 if x is None else x.shape[1]
    _check_options(P, y_storage, likelihood_impl, K, mc_samples, fix_alpha)
    if verbose:
        print("Constructing model")  # reference R/inference-tflow.R:102-104
    L, clone_names = _parse_copy_number(copy_number_data, Y.shape[1])
    _check_kernel_contract(device, K, int(mc_samples), L.shape[1], P)
    return Y, gene_names, L, clone_names, x, P


def _retained_genes(gene_names, low, verbose):
    """The names (or the indices) of the genes the filter keeps, ``low``
    marking those it removes (reference R/inference-tflow.R:117-131)."""
    if verbose and low.any():
        print(f"Removing {int(low.sum())} genes with low counts")
    if gene_names is not None:
        return [g for g, drop in zip(gene_names, low) if not drop]
    return list(np.flatnonzero(~low))


def _device_validated(Y) -> bool:
    """Dense integer counts of at most 16 bits cannot be NaN or fractional:
    their sign and empty cells are checked on the device, from the
    statistics (:func:`_check_statistics`), with no O(N x G) host pass."""
    return (not _is_scipy_sparse(Y) and np.issubdtype(Y.dtype, np.integer)
            and Y.dtype.itemsize <= 2)


def _check_host_counts(Y, device_validated, allow_fractional, K, cells=None) -> None:
    """The host checks of the counts (:func:`_validate_counts`, unless the
    device checks them) and of the cell count the PCA init needs; on a mesh
    (``cells``: Y this rank's rows) every rank raises if one does."""
    if not device_validated:
        agree(cells, lambda: _validate_counts(Y, allow_fractional=allow_fractional))
    if K > 0 and (Y.shape[0] if cells is None else cells.n) < 2:
        raise ValueError(
            "At least 2 cells are required when K > 0 (the PCA initialization "
            "of the latent space needs multiple cells); pass K=0 for a "
            "single-cell fit"
        )


def _resolve_storage(y_storage, Y, cells: Optional[Cells] = None,
                     genes: Optional[Genes] = None):
    """Y's storage type on the device (``_Y_STORAGE``; "auto":
    :func:`_auto_y_storage` of the counts, a sparse matrix's stored ones;
    on a mesh every rank's); None is the compute dtype."""
    storage = _Y_STORAGE[y_storage]
    if storage == "auto":
        storage = _auto_y_storage(Y.data if _is_scipy_sparse(Y) else Y, cells, genes)
    return storage


def _check_statistics(data, device_validated, feasible=True) -> None:
    """The checks made on the device statistics ``data`` (``s``,
    ``YlogL``): a cell without counts, where the host did not check, and
    with ``feasible`` a cell no clone can explain; on a mesh
    (``data.cells``) over every rank's cells."""
    if device_validated and float(all_min(torch.min(data.s), data.cells)) == 0:
        raise ValueError("Some cells have no counts mapping")  # R/inference-tflow.R:212-214
    if feasible:
        mm._check_cells_feasible(data.YlogL, data.cells)


def _model_config(K, P, mc_samples, fix_alpha, likelihood_impl, dtype, n_elements):
    """The model configuration, "auto" resolved by :func:`_resolve_auto_impl`
    over the retained N x G elements."""
    if likelihood_impl == "auto":
        likelihood_impl = _resolve_auto_impl(K, mc_samples, dtype, n_elements, P)
    return mm.ModelConfig(K=K, P=P, mc_samples=int(mc_samples), fix_alpha=fix_alpha,
                          likelihood_impl=likelihood_impl)


def setup_fit(
    gene_expression_data,
    copy_number_data,
    gene_filter_threshold: float = 0,
    x=None,
    clone_allele=None,
    cov=None,
    ref=None,
    fix_alpha: bool = False,
    dtype: str = "float32",
    saturate: bool = True,
    saturation_threshold: float = 6,
    K: Optional[int] = None,
    mc_samples: int = 1,
    verbose: bool = True,
    data_init_mu=True,
    y_storage: Optional[str] = "auto",
    likelihood_impl: str = "auto",
    allow_fractional: bool = False,
    *,
    device="cuda",
    mesh=None,
) -> FitContext:
    """Input parsing, gene filtering and validation, then the device data
    (reference R/clonealign.R:206-260, R/inference-tflow.R:111-235).

    Dense integer counts of at most 16 bits are checked on the device
    (reference api.py:287-308, 394-446): integers cannot be NaN or
    fractional, ``prepare_data`` raises on a negative count, the gene
    filter reads the device column sums (the kept columns are gathered on
    the device and their statistics taken again) and a cell without counts
    shows in the device row sums, so no O(N x G) host pass runs. Other
    input, a scipy sparse matrix among it (O(nnz) checks; the filter slices
    its CSR columns), is validated and filtered on the host first. Either
    way the per-cell feasibility check sees only the retained genes (unlike
    the reference, whose check precedes its deferred filter).

    ``y_storage`` picks Y's storage type on the device (``_Y_STORAGE``;
    "auto": :func:`_auto_y_storage`). ``likelihood_impl="auto"``
    resolves by :func:`_resolve_auto_impl` over the retained genes. The
    covariates ``x`` (:func:`_parse_covariates`) go to the device beside Y,
    in the compute dtype, and so does the allele term
    (:func:`_setup_allele`).

    ``mesh`` (a :class:`~clonealign_torch.parallel.sharding.Mesh` with a
    process group; ``device`` is then its device) splits the cells: every
    rank parses the whole input and keeps its block of rows
    (``process_cell_slice``) of the counts, the covariates and the allele
    counts. Every decision that reads all cells takes every rank's values:
    the gene filter the summed column totals, the storage the largest
    count, the likelihood the global N x G, and each check raises on every
    rank or on none. With a genes axis the filter is decided on the host
    from those totals first; then the kept genes are split into contiguous
    blocks (``process_gene_slice``) and each rank keeps, checks the rows
    of and uploads only its block's columns of its rows (and its rows of
    L), so that no rank's card holds more than its tile.
    """
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    K = 1 if K is None else int(K)  # reference R/clonealign.R:226-232
    Y, gene_names, L, clone_names, x, P = _parse_inputs(
        gene_expression_data, copy_number_data, x, K, mc_samples, fix_alpha, y_storage,
        likelihood_impl, dev, verbose)
    cells = block_of(mesh, Y.shape[0])
    if cells is not None:
        Y = Y[cells.start : cells.stop]
        x = None if x is None else x[cells.start : cells.stop]
    device_validated = _device_validated(Y)
    # float32 column sums of integers are exact below 2^24, and a total that
    # rounds is far above any threshold this admits; a genes axis splits
    # the kept genes, so they are known before the upload
    split_genes = mesh is not None and mesh.group is not None and mesh.genes > 1
    defer_filter = (device_validated and float(gene_filter_threshold) < 2.0**24
                    and not split_genes)

    def drop_genes(low):  # reference R/inference-tflow.R:117-131
        nonlocal Y, L
        if low.any():
            Y = Y[:, ~low]
            L = L[~low]
        return _retained_genes(gene_names, low, verbose)

    if not defer_filter:
        retained_genes = drop_genes(all_sum(_colsum_f64(Y), cells) <= gene_filter_threshold)
    _check_host_counts(Y, device_validated, allow_fractional, K, cells)
    n_genes = Y.shape[1]
    genes = gene_block(mesh, n_genes)
    if genes is not None:
        Y, L = Y[:, genes.start : genes.stop], L[genes.start : genes.stop]

    # --- saturation (reference R/inference-tflow.R:142-144) ---
    if saturate:
        L = np.minimum(L, float(saturation_threshold))

    # --- allele-specific setup (reference R/inference-tflow.R:166-187) ---
    n_cells = Y.shape[0] if cells is None else cells.n
    extra_log_lik, clone_probs_from_snv = _setup_allele(clone_allele, cov, ref, n_cells,
                                                        L.shape[1], dt, dev, verbose, cells)

    storage = _resolve_storage(y_storage, Y, cells, genes)
    data = mm.prepare_data(Y, L, x, device=dev, dtype=dt, y_storage=storage,
                           check_feasible=not defer_filter, cells=cells, genes=genes)
    if defer_filter:
        low = data.colsum_Y.cpu().numpy() <= gene_filter_threshold
        retained_genes = drop_genes(low)
        if low.any():
            # bfloat16 rounds counts above 256, and the statistics must see
            # the exact ones: those come from the host again
            stored = Y if storage == torch.bfloat16 else data.Y[
                :, torch.as_tensor(np.flatnonzero(~low), device=dev)]
            del data
            data = mm.prepare_data(stored, L, x, device=dev, dtype=dt, y_storage=storage,
                                   check_feasible=False, cells=cells)
    _check_statistics(data, device_validated, feasible=defer_filter)
    config = _model_config(K, P, mc_samples, fix_alpha, likelihood_impl, dt,
                           n_cells * (Y.shape[1] if genes is None else n_genes))

    return FitContext(
        Y=Y,
        L=L,
        clone_names=clone_names,
        retained_genes=retained_genes,
        config=config,
        data=data,
        dtype=dt,
        device=dev,
        data_init_mu=_mu_init_switch(data_init_mu),
        extra_log_lik=extra_log_lik,
        clone_probs_from_snv=clone_probs_from_snv,
        cells=cells,
        genes=genes,
    )


def _mu_init_switch(data_init_mu):
    """``data_init_mu`` with numpy booleans (np.True_, 0-d bool arrays) as the
    boolean switch they are, not a mu init array."""
    if isinstance(data_init_mu, np.bool_) or (
        isinstance(data_init_mu, np.ndarray)
        and data_init_mu.ndim == 0
        and data_init_mu.dtype == np.bool_
    ):
        return bool(data_init_mu)
    return data_init_mu


def _setup_allele(clone_allele, cov, ref, N, C, dtype, device, verbose, cells=None):
    """The allele-specific term (reference api.py:475-495,
    R/inference-tflow.R:166-187): ``(extra_log_lik, clone_probs_from_snv)``,
    the (N, C) term on ``device`` in ``dtype`` and its softmax on the host,
    or ``(None, None)`` when any of the three inputs is missing. ``cov`` and
    ``ref`` are cell-by-variant, N rows; ``alt = cov - ref`` is the intended
    semantics (the reference's public API passes ``ref = cov``, zeroing the
    alternative counts, R/clonealign.R:271). On a mesh (``cells``) they hold
    every cell: the term is made for this rank's rows, its softmax gathered
    for every cell."""
    if clone_allele is None or ref is None or cov is None:
        return None, None
    if verbose:
        print("Using allelic imbalance info")  # R/inference-tflow.R:169-171
    clone_allele = np.asarray(clone_allele, np.float64)
    cov = np.asarray(cov, np.float64)
    ref = np.asarray(ref, np.float64)
    sanitize_allele_info(clone_allele, cov, ref, N, C)
    if cells is not None:
        cov, ref = cov[cells.start : cells.stop], ref[cells.start : cells.stop]
    cov_vn = cov.T
    alt_vn = cov_vn - ref.T
    v_log_prob = construct_ai_likelihood(
        torch.as_tensor(clone_allele, dtype=dtype, device=device), alt_vn, cov_vn)
    return v_log_prob, gather_rows(snv_clone_probs(v_log_prob), cells).cpu().numpy()


def clonealign(
    gene_expression_data,
    copy_number_data,
    max_iter: int = 200,
    rel_tol: float = 1e-6,
    gene_filter_threshold: float = 0,
    learning_rate: float = 0.1,
    x=None,
    clone_allele=None,
    cov=None,
    ref=None,
    fix_alpha: bool = False,
    dtype: str = "float32",
    saturate: bool = True,
    saturation_threshold: float = 6,
    K: Optional[int] = None,
    mc_samples: int = 1,
    verbose: bool = True,
    initial_shrink: float = 5,
    clone_call_probability: float = 0.95,
    data_init_mu=True,
    seed: Optional[int] = None,
    key=None,
    elbo_eval: str = "fresh",
    progress: bool = False,
    y_storage: Optional[str] = "auto",
    likelihood_impl: str = "auto",
    allow_fractional: bool = False,
    loop_impl: str = "while",
    unroll: int = 1,
    remat="auto",
    *,
    device="cuda",
    noise=None,
) -> ClonealignFit:
    """Assign scRNA-seq cells to clones of origin by variational inference.

    Mirrors ``clonealign_tpu.clonealign`` (and the reference's signature,
    R/clonealign.R:184-203). ``device`` is "cuda" (default) or "cpu"; every
    random draw comes from ``noise`` (default: a
    :class:`~clonealign_torch.utils.noise.Noise` seeded with ``seed``, or 0).
    ``x`` (N x P covariates, or one column as a 1-D array) adds the
    coefficients beta, reported as ``ml_params["beta"]`` (G' x P for the
    retained genes); on CUDA K + P <= 4. ``clone_allele`` (V x C copy
    numbers at V variants), ``cov`` and ``ref`` (N x V total and reference
    allele counts) add the beta-binomial SNV term to every clone
    log-likelihood; the fit then carries ``clone_probs_from_snv``. The
    counts may be a scipy sparse matrix (or an AnnData-style ``.X``).
    ``likelihood_impl`` is "auto", "xla" (the exact normalizer) or "z_cheb"
    (the Chebyshev normalizer, K=1 without covariates, with or without the
    allele term; the reported ELBO stays exact).
    ``loop_impl`` ("while" or "scan"), ``unroll`` and ``remat`` are the JAX
    package's compilation controls: accepted, with no effect here. ``key``
    (a JAX PRNG key) is refused: pass ``seed`` or ``noise``.
    """
    _check_reference_keywords(key, loop_impl)
    t0 = time.perf_counter()
    ctx = setup_fit(
        gene_expression_data,
        copy_number_data,
        gene_filter_threshold=gene_filter_threshold,
        x=x,
        clone_allele=clone_allele,
        cov=cov,
        ref=ref,
        fix_alpha=fix_alpha,
        dtype=dtype,
        saturate=saturate,
        saturation_threshold=saturation_threshold,
        K=K,
        mc_samples=mc_samples,
        verbose=verbose,
        data_init_mu=data_init_mu,
        y_storage=y_storage,
        likelihood_impl=likelihood_impl,
        allow_fractional=allow_fractional,
        device=device,
    )
    if noise is None:
        noise = Noise(0 if seed is None else int(seed), ctx.device)
    synchronize(ctx.device)
    t1 = time.perf_counter()

    params0 = mm.init_params(
        ctx.data.Y,
        ctx.data.L,
        noise,
        K=ctx.config.K,
        data_init_mu=ctx.data_init_mu,
        dtype=ctx.dtype,
        P=ctx.config.P,
    )
    synchronize(ctx.device)
    t2 = time.perf_counter()

    if verbose:
        print("Optimizing ELBO")  # reference R/inference-tflow.R:383
    result = run_inference(
        params0,
        ctx.data,
        noise,
        ctx.config,
        max_iter=int(max_iter),
        rel_tol=float(rel_tol),
        learning_rate=float(learning_rate),
        initial_shrink=float(initial_shrink),
        elbo_eval=elbo_eval,
        progress=progress,
        extra_log_lik=ctx.extra_log_lik,
    )
    if verbose:
        print("ELBO converged or reached max iterations")  # R/inference-tflow.R:420
    t3 = time.perf_counter()

    fit = _package_fit(
        result,
        ctx.Y,
        ctx.L,
        ctx.clone_names,
        ctx.retained_genes,
        ctx.config,
        clone_call_probability,
        ctx.clone_probs_from_snv,
        device_Y=ctx.data.Y,
        device_s=ctx.data.s,
    )
    fit.timings = {
        "setup": t1 - t0,
        "init": t2 - t1,
        "inference": t3 - t2,
        "loop": result.loop_seconds,
        "package": time.perf_counter() - t3,
    }
    return fit


def _package_fit(
    result,
    Y,
    L,
    clone_names,
    retained_genes,
    config,
    clone_call_probability,
    clone_probs_from_snv=None,
    device_Y=None,
    device_s=None,
    blocks=None,
    cells: Optional[Cells] = None,
    genes: Optional[Genes] = None,
) -> ClonealignFit:
    """Fetch ML params and build the fit object
    (reference R/inference-tflow.R:424-480, R/clonealign.R:283-303).

    ``Y`` is the host counts, or a streaming fit's row source
    (``stream._RowSource``), read in the row ``blocks`` given, with
    ``device_Y`` its uploading counterpart (``stream._DeviceRows``). On a
    mesh (``cells``) they, ``device_s`` and the result's per-cell
    parameters are this rank's rows: the per-cell outputs are gathered and
    the correlations summed over every rank, so every rank returns the fit
    the one-process call gives. With ``genes`` ``Y``, ``L`` and the
    per-gene parameters are this rank's gene block: the per-gene outputs
    (mu, W, beta, the correlations) are gathered over the genes group, in
    the order of the kept genes."""
    p = result.params
    # Size factors must be float64-exact. For integer host counts (dense or
    # sparse) whose row totals stay below 2^24 the device totals are exact in
    # float32 (sums of non-negative integers never round there); otherwise
    # sum on the host in float64.
    s = None
    if (
        device_s is not None
        and np.issubdtype(Y.dtype, np.integer)
        and float(all_max(torch.max(device_s), cells)) < 2.0**24
    ):
        s = device_s.cpu().numpy().astype(np.float64)
    if s is None and blocks is None:
        s = all_sum(np.asarray(Y.sum(axis=1, dtype=np.float64)).ravel(), genes)
    elif s is None:
        s = all_sum(np.concatenate([Y[i:j].sum(axis=1, dtype=np.float64) for i, j in blocks]),
                    genes)

    def host(t, per_cell=False, per_gene=False):
        t = t.detach()
        t = gather_rows(t, cells) if per_cell else gather_cols(t, genes) if per_gene else t
        return t.cpu().numpy()

    ml_params = {
        "mu": host(mm.softplus(p.qmu_loc), per_gene=True),
        "clone_probs": host(torch.softmax(p.gamma_logits, dim=1), per_cell=True),
        "s": gather_rows(s, cells),
        "alpha": host(torch.softmax(p.alpha_unconstr, dim=0)),
    }
    if config.K > 0:
        ml_params["psi"] = host(p.psi, per_cell=True)
        ml_params["W"] = host(p.W, per_gene=True)
        ml_params["chi"] = host(torch.exp(p.chi_unconstr))
    if config.P > 0:
        ml_params["beta"] = host(p.beta, per_gene=True)

    n_iters = int(result.n_iters)
    trace = np.asarray(result.elbo_trace)[: n_iters + 1]
    conv = ConvergenceInfo(
        final_elbo=float(result.final_elbo),
        sd_final_elbo=float(result.sd_final_elbo),
        elbo=trace,
        n_iters=n_iters,
    )
    if not np.isfinite(trace[0]):
        raise ValueError("Initial elbo is NA")  # reference R/inference-tflow.R:374-376

    clones = _assign.clone_assignment(
        ml_params["clone_probs"], clone_names, clone_call_probability
    )
    correlations = _assign.compute_correlations(
        Y, L, clones if cells is None else clones[cells.start : cells.stop], clone_names,
        device_Y=device_Y, dtype=p.qmu_loc.dtype, blocks=blocks, cells=cells, genes=genes,
    )
    finite = correlations[np.isfinite(correlations)]
    if finite.size and np.quantile(finite, 0.25) < 0:
        warnings.warn(
            "Less than 75% of genes positively correlated with expression - "
            "assignment may have failed"
        )  # reference R/clonealign.R:296-300

    return ClonealignFit(
        clone=clones,
        ml_params=ml_params,
        convergence_info=conv,
        retained_genes=retained_genes,
        correlations=correlations,
        clone_names=list(clone_names),
        clone_probs_from_snv=clone_probs_from_snv,
    )

"""Input preprocessing (reference R/preprocess.R); a numpy-only copy of
``clonealign_tpu/preprocess.py``.

Filter order is semantically significant — each filter sees the previous
filter's output (SURVEY.md §3.3) — and is preserved exactly:

1. genes whose max copy number exceeds ``max_copy_number``
2. genes with total counts <= ``min_counts_per_gene``
3. outlying genes (mean expression > overall mean + nmads * MAD)
4. genes with identical copy number across clones
5. cells with total counts <= ``min_counts_per_cell``
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .api import _parse_copy_number, _parse_expression
from .utils.sparsity import is_scipy_sparse as _is_sparse


def mad(x):
    """R's stats::mad — median absolute deviation with the 1.4826 consistency
    constant (reference R/preprocess.R:58-62 calls it on gene means)."""
    x = np.asarray(x, np.float64)
    return 1.4826 * np.median(np.abs(x - np.median(x)))


def _colsum(Y):
    return np.asarray(Y.sum(axis=0), np.float64).ravel()


def _rowsum(Y):
    return np.asarray(Y.sum(axis=1), np.float64).ravel()


def get_outlying_genes(Y, nmads):
    """Boolean mask of outlier genes (reference R/preprocess.R:58-62).
    Accepts dense arrays or scipy sparse matrices (no densification)."""
    gene_means = _colsum(Y) / Y.shape[0]
    return gene_means > gene_means.mean() + nmads * mad(gene_means)


class PreprocessResult(NamedTuple):
    gene_expression_data: np.ndarray  # (N', G') filtered counts (sparse in -> sparse out)
    copy_number_data: np.ndarray      # (G', C)
    retained_cells: Optional[list]
    retained_genes: Optional[list]
    clone_names: list


def preprocess_for_clonealign(
    gene_expression_data,
    copy_number_data,
    min_counts_per_gene: float = 20,
    min_counts_per_cell: float = 100,
    remove_outlying_genes: bool = True,
    nmads: float = 10,
    max_copy_number: float = 6,
    remove_genes_same_copy_number: bool = True,
) -> PreprocessResult:
    """Filter genes/cells for clonealign input (reference R/preprocess.R:93-147).

    scipy sparse counts pass through without densification (column filters
    run on a CSC view, row filters on CSR; statistics come from axis sums).
    """
    Y, gene_names, cell_names = _parse_expression(gene_expression_data)
    G = Y.shape[1]
    L, clone_names = _parse_copy_number(copy_number_data, G)
    sparse = _is_sparse(Y)
    if sparse:
        Y = Y.tocsc()

    gene_names = list(gene_names) if gene_names is not None else None
    cell_names = list(cell_names) if cell_names is not None else None

    def keep_genes(mask):
        nonlocal Y, L, gene_names
        mask = np.asarray(mask).ravel()
        Y = Y[:, mask]
        L = L[mask]
        if gene_names is not None:
            gene_names = [g for g, k in zip(gene_names, mask) if k]

    # 1. copy number exceeds max (reference R/preprocess.R:114-116)
    keep_genes(~(L.max(axis=1) > max_copy_number))
    # 2. insufficient expression (reference R/preprocess.R:118-120)
    keep_genes(_colsum(Y) > min_counts_per_gene)
    # 3. outliers (reference R/preprocess.R:123-128)
    if remove_outlying_genes:
        keep_genes(~get_outlying_genes(Y, nmads))
    # 4. constant copy number across clones (reference R/preprocess.R:131-135)
    if remove_genes_same_copy_number:
        keep_genes(~(L.var(axis=1, ddof=1) == 0))
    # 5. low-coverage cells (reference R/preprocess.R:138-139)
    cell_mask = _rowsum(Y) > min_counts_per_cell
    Y = (Y.tocsr() if sparse else Y)[cell_mask]
    if cell_names is not None:
        cell_names = [c for c, k in zip(cell_names, cell_mask) if k]

    return PreprocessResult(
        gene_expression_data=Y,
        copy_number_data=L,
        retained_cells=cell_names,
        retained_genes=gene_names,
        clone_names=clone_names,
    )

"""Region-level CNV calls -> gene-level clone copy-number matrix; a copy of
``clonealign_tpu/cnv.py`` (NumPy only).

The reference deliberately ships this workflow as a vignette rather than a
function (reference vignettes/preparing_copy_number_data.Rmd:44-185): overlap
gene annotations with CNV segments, keep uniquely-mapped genes, spread to a
gene x clone matrix, and filter. Here it is a function — the genome-specific
choices (annotation source, chromosome naming) are explicit arguments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np


class GeneCNVMatrix(NamedTuple):
    copy_number: np.ndarray  # (G', C)
    gene_ids: list
    clone_names: list


def _norm_chr(c) -> str:
    c = str(c)
    return c[3:] if c.lower().startswith("chr") else c


def cnv_regions_to_genes(
    cnv_chr: Sequence,
    cnv_start: Sequence,
    cnv_end: Sequence,
    cnv_copy_number: Sequence,
    cnv_clone: Sequence,
    gene_ids: Sequence,
    gene_chr: Sequence,
    gene_start: Sequence,
    gene_end: Sequence,
    max_min_copy_number: Optional[float] = 6,
    require_varying_copy_number: bool = True,
) -> GeneCNVMatrix:
    """Map clone-specific region CNVs onto genes by genomic overlap.

    Follows the reference recipe exactly
    (reference vignettes/preparing_copy_number_data.Rmd:100-178):

    1. overlap genes with CNV segments (inclusive interval intersection,
       chromosome names normalized so "chr1" == "1");
    2. keep genes hit exactly once per clone (genes spanning breakpoints or
       multi-mapped are dropped);
    3. spread to a (gene, clone) matrix;
    4. keep genes with min copy number <= ``max_min_copy_number`` ("we expect
       dosage mechanisms to tail off", Rmd:168) and, optionally, copy number
       that varies between clones.
    """
    cnv_chr = np.asarray([_norm_chr(c) for c in cnv_chr])
    cnv_start = np.asarray(cnv_start, np.float64)
    cnv_end = np.asarray(cnv_end, np.float64)
    cnv_cn = np.asarray(cnv_copy_number, np.float64)
    cnv_clone = np.asarray([str(c) for c in cnv_clone])

    gene_ids = [str(g) for g in gene_ids]
    gene_chr = np.asarray([_norm_chr(c) for c in gene_chr])
    gene_start = np.asarray(gene_start, np.float64)
    gene_end = np.asarray(gene_end, np.float64)

    clone_names = [str(c) for c in sorted(set(cnv_clone))]
    C = len(clone_names)
    clone_idx = {c: i for i, c in enumerate(clone_names)}

    G = len(gene_ids)
    hits_cn = np.full((G, C), np.nan)
    hit_counts = np.zeros((G, C), np.int64)

    # Vectorized interval join, per (chromosome, clone) — no per-gene Python
    # loop, so genome scale (60k genes x thousands of segments) stays fast:
    #
    # * overlap count is exact for ANY segment set via two binary searches:
    #   #(start <= gene_end) - #(end < gene_start). (Every segment with
    #   end < gene_start also has start <= end < gene_start <= gene_end, so
    #   the subtraction never goes negative.)
    # * when the count is 1, the overlapping segment is the first one, in
    #   start order, whose running-max end reaches gene_start: any earlier
    #   segment with end >= gene_start would also have start <= the hit's
    #   start <= gene_end and overlap too, contradicting count == 1. The
    #   running max is nondecreasing, so that index is a searchsorted.
    for chrom in np.unique(gene_chr):
        g_idx = np.flatnonzero(gene_chr == chrom)
        gs_arr = gene_start[g_idx]
        ge_arr = gene_end[g_idx]
        chrom_m = cnv_chr == chrom
        if not chrom_m.any():
            continue
        for cname, ci in clone_idx.items():
            m = chrom_m & (cnv_clone == cname)
            if not m.any():
                continue
            order = np.argsort(cnv_start[m], kind="stable")
            starts_s = cnv_start[m][order]
            ends_s = cnv_end[m][order]
            cn_s = cnv_cn[m][order]

            n_started = np.searchsorted(starts_s, ge_arr, side="right")
            n_ended = np.searchsorted(np.sort(ends_s), gs_arr, side="left")
            cnt = n_started - n_ended
            hit_counts[g_idx, ci] = cnt

            cand = np.searchsorted(
                np.maximum.accumulate(ends_s), gs_arr, side="left"
            )
            one = cnt == 1
            hits_cn[g_idx[one], ci] = cn_s[cand[one]]

    # uniquely mapped: exactly one hit per clone (Rmd:144-148), and drop
    # genes whose matched segment carries a NaN copy number (tidyr::spread
    # NAs in the reference flow would otherwise leak into the matrix)
    keep = (hit_counts == 1).all(axis=1) & ~np.isnan(hits_cn).any(axis=1)

    mat = hits_cn[keep]
    ids = [g for g, k in zip(gene_ids, keep) if k]

    # final filters (Rmd:170-172)
    fmask = np.ones(mat.shape[0], bool)
    if max_min_copy_number is not None:
        fmask &= mat.min(axis=1) <= max_min_copy_number
    if require_varying_copy_number and C > 1:
        fmask &= mat.var(axis=1, ddof=1) > 0

    return GeneCNVMatrix(
        copy_number=mat[fmask],
        gene_ids=[g for g, k in zip(ids, fmask) if k],
        clone_names=clone_names,
    )


def align_expression_to_cnv(Y, gene_names, gene_cnv, on_missing: str = "error"):
    """Subset an expression matrix to a gene-level CNV matrix's genes, in CNV
    order — the vignette's final manual step ``sce <- sce[rownames(cnv_mat),]``
    (reference vignettes/preparing_copy_number_data.Rmd:176-185) as a
    function, so the CNV-prep recipe flows straight into :func:`clonealign`.

    Args:
      Y: (N, G) counts, dense or scipy sparse, columns ordered by
        ``gene_names``.
      gene_names: length-G gene identifiers for Y's columns.
      gene_cnv: a :class:`GeneCNVMatrix` (from :func:`cnv_regions_to_genes`)
        or a ``(gene_ids, copy_number)`` pair.
      on_missing: CNV genes absent from the expression matrix — ``"error"``
        (like R's subsetting by missing rownames) or ``"drop"`` (drop them
        from the CNV side too).

    Returns:
      ``(Y_aligned, L_aligned, gene_ids)`` with matching gene order.
    """
    if isinstance(gene_cnv, GeneCNVMatrix):
        cnv_ids, L = list(gene_cnv.gene_ids), np.asarray(gene_cnv.copy_number)
    else:
        cnv_ids, L = list(gene_cnv[0]), np.asarray(gene_cnv[1])
    if on_missing not in ("error", "drop"):
        raise ValueError(f"on_missing must be 'error' or 'drop', got {on_missing!r}")

    gene_names = list(gene_names)
    pos = {g: i for i, g in enumerate(gene_names)}
    if len(pos) != len(gene_names):
        raise ValueError("gene_names contains duplicates; disambiguate first")
    missing = [g for g in cnv_ids if g not in pos]
    if missing and on_missing == "error":
        raise ValueError(
            f"{len(missing)} CNV genes absent from the expression matrix "
            f"(e.g. {missing[:5]}); pass on_missing='drop' to drop them"
        )
    keep = [g for g in cnv_ids if g in pos]
    if not keep:
        raise ValueError("no genes in common between expression and CNV data")
    idx = np.asarray([pos[g] for g in keep])
    cnv_keep = np.asarray([g in pos for g in cnv_ids])

    Y_sub = Y.tocsc()[:, idx].tocsr() if hasattr(Y, "tocsc") else np.asarray(Y)[:, idx]
    return Y_sub, L[cnv_keep], keep

"""CNV-vs-expression diagnostic plot (reference R/plotting.R:70-226); a
copy of ``clonealign_tpu/plot.py`` (matplotlib imported inside the
functions).

Two aligned tracks over genomic rank-position for one chromosome:

* RNA (top): per-clone mean z-scored expression per gene (points) and per
  copy-number "state" segment (lines);
* DNA (bottom): per-clone copy-number segments, optionally jittered so
  overlapping clones stay visible.

"States" are runs of consecutive genes (in genomic order) over which *every*
clone's copy number is constant (reference R/plotting.R:139-151).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def plot_elbo(fit, ax=None):
    """ELBO-trace convergence plot (the reference vignette's
    ``qplot(elbo)`` check, introduction_to_clonealign.Rmd:158-161).
    Accepts a v2 :class:`~clonealign_torch.fit.ClonealignFit` or a legacy
    :class:`~clonealign_torch.models.negbin.ClonealignV1Fit`."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(6, 3))
    if hasattr(fit, "convergence_info"):
        trace = np.asarray(fit.convergence_info.elbo, np.float64)
        title = (f"final: {fit.convergence_info.final_elbo:.1f} "
                 f"± {fit.convergence_info.sd_final_elbo:.1f}")
    else:  # v1 family: deterministic, no sd
        trace = np.asarray(fit.elbo_trace, np.float64)
        title = f"final: {fit.final_elbo:.1f}"
    ax.plot(np.arange(len(trace)), trace, lw=1.5)
    ax.set_xlabel("Iteration")
    ax.set_ylabel("ELBO")
    ax.set_title(title, fontsize=9)
    return ax.figure


def _rank(x):
    """R's rank() with average ties."""
    x = np.asarray(x, np.float64)
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def segment_states(cnv: np.ndarray) -> np.ndarray:
    """Run-length state ids over genomically-ordered genes: a new state starts
    whenever any clone's copy number changes (reference R/plotting.R:139-151).
    Returns 1-based state ids, shape (G,)."""
    cnv = np.asarray(cnv)
    if len(cnv) == 0:
        return np.zeros(0, int)
    changed = np.any(cnv[1:] != cnv[:-1], axis=1)
    return np.concatenate([[1], 1 + np.cumsum(changed)])


def plot_clonealign_adata(
    adata,
    clones: Sequence,
    cnv_data=None,
    chromosome: str = "1",
    chr_str: str = "chr",
    start_str: str = "start_position",
    end_str: str = "end_position",
    layer: Optional[str] = "logcounts",
    cnv_cols: Optional[Sequence[str]] = None,
    **kwargs,
):
    """AnnData-native entry matching the reference's SCE ergonomics
    (reference R/plotting.R:70-112): gene coordinates are read from named
    ``adata.var`` columns instead of pre-extracted arrays.

    Args:
      adata: AnnData (or duck-type) with cells x genes ``.X``, pandas-like
        ``.var``, and optionally ``.layers``.
      clones: length-N clone assignment per cell (e.g. ``fit.clone``).
      cnv_data: (G, C) copy numbers (matrix/DataFrame). Alternatively pass
        ``cnv_cols`` naming per-clone columns of ``adata.var`` (the reference
        example's ``rowData(example_sce)[, c("A","B","C")]``).
      chr_str/start_str/end_str: names of the ``adata.var`` columns holding
        each gene's chromosome and start/end positions.
      layer: which ``adata.layers`` entry holds normalized log expression
        (the reference requires ``logcounts(sce)``). Falls back to ``.X``
        when the layer is absent or ``layer=None``.

    Extra kwargs are forwarded to :func:`plot_clonealign`.
    """
    var = adata.var
    for value, argname in (
        (chr_str, "chr_str"),
        (start_str, "start_str"),
        (end_str, "end_str"),
    ):
        if value not in var.columns:
            # reference R/plotting.R:93-104 error wording
            raise ValueError(
                f"The column '{argname}' (currently set to '{value}') must be "
                f"in adata.var and refer to the gene coordinates"
            )
    if cnv_data is None:
        if cnv_cols is None:
            raise ValueError("pass cnv_data or cnv_cols (adata.var column names)")
        missing = [c for c in cnv_cols if c not in var.columns]
        if missing:
            raise ValueError(f"cnv_cols not in adata.var: {missing}")
        cnv_data = var[list(cnv_cols)]

    X = None
    if layer is not None and hasattr(adata, "layers"):
        try:
            X = adata.layers[layer]
        except (KeyError, TypeError):
            X = None
    if X is None:
        X = adata.X
    if hasattr(X, "todense"):
        X = np.asarray(X.todense())

    return plot_clonealign(
        X,
        clones,
        cnv_data,
        np.asarray(var[chr_str]),
        np.asarray(var[start_str], np.float64),
        np.asarray(var[end_str], np.float64),
        chromosome=chromosome,
        **kwargs,
    )


def plot_clonealign(
    logcounts,
    clones: Sequence,
    cnv_data,
    gene_chr: Sequence,
    gene_start: Sequence,
    gene_end: Sequence,
    chromosome: str = "1",
    clone_names: Optional[Sequence[str]] = None,
    jitter_cnv: bool = True,
    expression_ylim=(-0.15, 0.15),
    cnv_dodge_sd: float = 0.1,
    rng=None,
    ax=None,
):
    """Plot gene expression and copy number along one chromosome.

    Args:
      logcounts: (N, G) normalized log expression (the reference requires
        ``logcounts(sce)``; any normalized matrix works).
      clones: length-N clone assignment per cell (e.g. ``fit.clone``);
        "unassigned" cells are dropped from the RNA track.
      cnv_data: (G, C) copy numbers, or dict/pandas-like with clone columns.
      gene_chr/gene_start/gene_end: per-gene genomic coordinates
        (the reference reads them from ``rowData(sce)``).
      chromosome: which chromosome to plot.

    Returns a matplotlib Figure.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(0) if rng is None else rng

    if hasattr(cnv_data, "columns") and hasattr(cnv_data, "values"):
        parsed_names = [str(c) for c in cnv_data.columns]
        cnv = np.asarray(cnv_data.values, np.float64)
    elif isinstance(cnv_data, dict):
        parsed_names = [str(c) for c in cnv_data.keys()]
        cnv = np.stack([np.asarray(v, np.float64) for v in cnv_data.values()], axis=1)
    else:
        cnv = np.asarray(cnv_data, np.float64)
        # default naming must MATCH the fit API's (clone_a, clone_b, ... —
        # api._default_clone_names), or a bare-array fit's clone labels never
        # match the plot's series and every panel silently comes up empty
        from .api import _default_clone_names

        parsed_names = _default_clone_names(cnv.shape[1])
    if clone_names is None:
        clone_names = parsed_names

    logcounts = np.asarray(logcounts, np.float64)
    gene_chr = np.asarray([str(c) for c in gene_chr])
    on_chr = gene_chr == str(chromosome)
    if not on_chr.any():
        raise ValueError(f"No genes on chromosome {chromosome} in CNV regions")

    lc = logcounts[:, on_chr]
    cnv = cnv[on_chr]
    mid = (np.asarray(gene_start, np.float64)[on_chr] + np.asarray(gene_end, np.float64)[on_chr]) / 2
    rank_pos = _rank(mid)

    # order genes genomically for state segmentation
    order = np.argsort(rank_pos, kind="stable")
    cnv_o = cnv[order]
    rank_o = rank_pos[order]
    states = segment_states(cnv_o)

    # --- DNA track data: per (state, clone, cn) segments ---
    segs = []  # (start, end, cn, clone_idx)
    for s in np.unique(states):
        m = states == s
        start, end = rank_o[m].min(), rank_o[m].max()
        for ci in range(cnv.shape[1]):
            cn = cnv_o[m][0, ci]
            jit = rng.normal(0, cnv_dodge_sd) if jitter_cnv else 0.0
            segs.append((start, end, cn + jit, ci))

    # --- RNA track: z-score per gene over assigned cells ---
    clones = np.asarray([str(c) for c in clones], dtype=object)
    keep = clones != "unassigned"
    lc_k = lc[keep]
    clones_k = clones[keep]

    mean_g = lc_k.mean(axis=0)
    sd_g = lc_k.std(axis=0, ddof=1) if lc_k.shape[0] > 1 else np.ones(lc_k.shape[1])
    sd_g = np.where((sd_g == 0) | ~np.isfinite(sd_g), 1.0, sd_g)
    z = (lc_k - mean_g) / sd_g

    fig = None
    if ax is None:
        fig, (ax_rna, ax_dna) = plt.subplots(
            2, 1, figsize=(9, 5), sharex=True, constrained_layout=True
        )
    else:
        ax_rna, ax_dna = ax

    colors = plt.get_cmap("Set1").colors

    for ci, cname in enumerate(clone_names):
        cells = clones_k == cname
        color = colors[ci % len(colors)]
        if cells.any():
            gene_means = z[cells].mean(axis=0)  # per-gene mean z over clone's cells
            ax_rna.scatter(rank_pos, gene_means, s=12, alpha=0.5, color=color, label=cname)
            # per clone x state mean segments
            gm_o = gene_means[order]
            for s in np.unique(states):
                m = states == s
                val = gm_o[m].mean()
                ax_rna.plot(
                    [rank_o[m].min() - 1, rank_o[m].max() + 1], [val, val],
                    color=color, lw=2,
                )

    for start, end, cn, ci in segs:
        ax_dna.plot(
            [start - 1, end + 1], [cn, cn],
            color=colors[ci % len(colors)], lw=3, solid_capstyle="butt",
        )

    ax_rna.set_ylabel("Gene expression")
    ax_rna.set_title("scRNA-seq", fontsize=10, loc="left")
    if expression_ylim is not None:
        ax_rna.set_ylim(*expression_ylim)
    ax_rna.legend(title="Clone", fontsize=8)
    ax_dna.set_ylabel("Copy number")
    ax_dna.set_xlabel("Genomic position")
    ax_dna.set_title("scDNA-seq", fontsize=10, loc="left")

    return fig if fig is not None else ax_rna.figure

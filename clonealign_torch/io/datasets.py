"""Bundled example datasets, converted from the reference's ``data/*.rda``.

The reference ships three lazy-loaded R datasets (documented at
reference R/clonealign.R:360-387):

* ``example_sce`` — SingleCellExperiment, 100 genes x 200 cells, with clone
  copy-number columns A/B/C in ``rowData``.
* ``df_cnv``     — region-level CNV calls (chr, start, end, copy_number, clone).
* ``example_clonealign_fit`` — a saved (v1-era) fit, used by print/plot examples.

Here they are plain NumPy containers, read from the converted ``.npz``
artifacts in ``<repo>/data`` (or the directory ``CLONEALIGN_TPU_DATA`` names,
as in the JAX package); a copy of the loaders of
``clonealign_tpu/io/datasets.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "data")


def _data_path(name: str) -> str:
    override = os.environ.get("CLONEALIGN_TPU_DATA")
    base = override if override else _DATA_DIR
    return os.path.join(base, name)


@dataclass
class ExampleSCE:
    """The reference's ``example_sce``, flattened to arrays.

    ``counts`` is cell-by-gene (N x G) — already transposed the way
    ``clonealign()`` consumes it (reference R/clonealign.R:217 does
    ``t(counts)``).
    """

    counts: np.ndarray  # (N, G) raw counts
    gene_names: list
    cell_names: list
    copy_number: np.ndarray  # (G, C) clone copy numbers
    clone_names: list = field(default_factory=lambda: ["A", "B", "C"])

    @property
    def n_cells(self) -> int:
        return self.counts.shape[0]

    @property
    def n_genes(self) -> int:
        return self.counts.shape[1]


def load_example_sce() -> ExampleSCE:
    """The bundled example dataset (the reference's lazy-loaded
    ``example_sce``, reference R/clonealign.R:360-371): 200 cells x 100
    genes of integer counts plus the A/B/C clone copy-number columns."""
    z = np.load(_data_path("example_sce.npz"), allow_pickle=False)
    return ExampleSCE(
        counts=z["counts"],
        gene_names=[str(g) for g in z["gene_names"]],
        cell_names=[str(c) for c in z["cell_names"]],
        copy_number=z["copy_number"],
        clone_names=[str(c) for c in z["clone_names"]],
    )


def load_df_cnv() -> dict:
    """Region-level CNV table as a dict of column arrays."""
    z = np.load(_data_path("df_cnv.npz"), allow_pickle=False)
    return {k: z[k] for k in z.files}


def load_example_fit() -> dict:
    """The saved v1-era example fit (clone labels + legacy ml_params).

    Note: this predates the v2 multinomial model (it has ``phi``/``basis_means``
    slots the v2 reference no longer produces) — use it for print/plot
    round-trips, not ELBO parity.
    """
    z = np.load(_data_path("example_clonealign_fit.npz"), allow_pickle=False)
    return {k: z[k] for k in z.files}


def load_example_clonealign_fit():
    """The bundled example fit as a :class:`~clonealign_torch.fit.ClonealignFit`
    (the reference's lazy-loaded ``example_clonealign_fit``,
    R/clonealign.R:380-387)."""
    from ..fit import ClonealignFit, ConvergenceInfo

    raw = load_example_fit()
    probs = raw["clone_probs"]
    return ClonealignFit(
        clone=[str(c) for c in raw["clone"]],
        ml_params={
            "clone_probs": probs,
            "mu": raw["mu"],
            "s": raw["s"],
            "alpha": raw["alpha"],
        },
        convergence_info=ConvergenceInfo(
            final_elbo=float(raw["log_lik"][-1]),
            sd_final_elbo=float("nan"),
            elbo=raw["log_lik"],
            n_iters=len(raw["log_lik"]) - 1,
        ),
        retained_genes=[str(g) for g in raw["retained_genes"]],
        correlations=np.full(len(raw["mu"]), np.nan),
        clone_names=["A", "B", "C"],
    )


def convert_reference_data(reference_data_dir: str, out_dir: Optional[str] = None) -> None:
    """Not ported: the conversion reads the R package's ``.rda`` files, which
    the repository does not hold; the converted ``data/*.npz`` it wrote are
    read by the loaders above."""
    raise NotImplementedError(
        "convert_reference_data is not ported: it waits for the reference's "
        ".rda data files in the repository; the loaders read data/*.npz"
    )

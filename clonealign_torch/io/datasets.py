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
``clonealign_tpu/io/datasets.py`` and of its :func:`convert_reference_data`,
which writes those artifacts from the R package's ``.rda`` files
(``python -m clonealign_torch.io.datasets REFERENCE_DATA_DIR [OUT_DIR]``).
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


# ---------------------------------------------------------------------------
# Conversion from the original .rda artifacts
# ---------------------------------------------------------------------------

def convert_reference_data(reference_data_dir: str, out_dir: Optional[str] = None) -> None:
    """Convert the reference's ``.rda`` datasets (``example_sce.rda``,
    ``df_cnv.rda``, ``example_clonealign_fit.rda`` in ``reference_data_dir``)
    to the ``.npz`` artifacts the loaders above read, in ``out_dir`` (by
    default ``<repo>/data``). A copy of ``clonealign_tpu/io/datasets.py``'s
    conversion, reading through this package's ``io/rds.py``.

    Layout knowledge: the SingleCellExperiment stores the counts assay under
    ``@assays@.xData[".->data"]@listData`` (an R5 shallow-list environment) and
    the clone copy-number columns under ``@rowRanges@elementMetadata@listData``.
    """
    from .rds import RObj, read_rda, unwrap

    out_dir = out_dir or _DATA_DIR
    os.makedirs(out_dir, exist_ok=True)

    def r_matrix(obj: RObj) -> np.ndarray:
        dim = np.asarray(unwrap(obj.attr("dim")))
        return np.asarray(obj.value).reshape(tuple(dim), order="F")

    # --- example_sce ---
    sce = read_rda(os.path.join(reference_data_dir, "example_sce.rda"))["example_sce"]
    assays_env = sce.attributes["assays"].attributes[".xData"]
    simple_list = assays_env.frame[".->data"]
    assay_list = simple_list.attributes["listData"]
    assay_names = assay_list.attr("names")
    counts_gxn = r_matrix(assay_list.value[assay_names.index("counts")])
    row_meta = sce.attributes["rowRanges"].attributes["elementMetadata"].attributes["listData"]
    clone_names = row_meta.attr("names")
    L = np.stack([np.asarray(unwrap(c)) for c in row_meta.value], axis=1).astype(np.float64)
    gene_names = sce.attributes["rowRanges"].attributes["partitioning"].attributes["NAMES"].value
    cell_names = sce.attributes["colData"].attributes["rownames"].value
    np.savez_compressed(
        os.path.join(out_dir, "example_sce.npz"),
        counts=counts_gxn.T.astype(np.int64),  # -> (N, G)
        gene_names=np.asarray(gene_names),
        cell_names=np.asarray(cell_names),
        copy_number=L,
        clone_names=np.asarray(clone_names),
    )

    # --- df_cnv ---
    cnv = read_rda(os.path.join(reference_data_dir, "df_cnv.rda"))["df_cnv"]
    cols = {}
    for nm, col in zip(cnv.attr("names"), cnv.value):
        v = unwrap(col)
        if isinstance(v, list):
            cols[nm] = np.asarray([str(x) for x in v])
        else:
            cols[nm] = np.asarray(v)
    np.savez_compressed(os.path.join(out_dir, "df_cnv.npz"), **cols)

    # --- example_clonealign_fit (legacy v1 object; keep the useful slots) ---
    fit = read_rda(os.path.join(reference_data_dir, "example_clonealign_fit.rda"))[
        "example_clonealign_fit"
    ]
    items = dict(zip(fit.attr("names"), fit.value))
    ml = items["ml_params"]
    ml_items = dict(zip(ml.attr("names"), ml.value))
    out = {
        "clone": np.asarray([str(c) for c in unwrap(items["clone"])]),
        "retained_genes": np.asarray([str(g) for g in unwrap(items["retained_genes"])]),
        "log_lik": np.asarray(unwrap(items["log_lik"])),
        "clone_probs": r_matrix(ml_items["clone_probs"]),
        "mu": np.asarray(unwrap(ml_items["mu"])),
        "s": np.asarray(unwrap(ml_items["s"])),
        "alpha": np.asarray(unwrap(ml_items["alpha"])),
    }
    np.savez_compressed(os.path.join(out_dir, "example_clonealign_fit.npz"), **out)


def main(argv=None) -> int:
    """``python -m clonealign_torch.io.datasets REFERENCE_DATA_DIR [OUT_DIR]``:
    convert the three ``.rda`` files there (OUT_DIR by default
    ``<repo>/data``)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m clonealign_torch.io.datasets",
        description="Convert the reference's example_sce.rda, df_cnv.rda and "
                    "example_clonealign_fit.rda to the .npz files the loaders read.")
    parser.add_argument("reference_data_dir", help="directory holding the three .rda files")
    parser.add_argument("out_dir", nargs="?", default=None,
                        help="where to write the .npz files (default: the repository's data/)")
    args = parser.parse_args(argv)
    convert_reference_data(args.reference_data_dir, args.out_dir)
    out = args.out_dir or _DATA_DIR
    print("converted:", sorted(f for f in os.listdir(out) if f.endswith(".npz")))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

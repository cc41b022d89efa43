"""The fit object (reference's ``clonealign_fit`` S3 class,
R/clonealign.R:303,348-357) as a plain dataclass of NumPy arrays; a copy of
``clonealign_tpu/fit.py`` without the ``.rds`` reader and writer."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class ConvergenceInfo:
    """reference R/inference-tflow.R:451-461."""

    final_elbo: float
    sd_final_elbo: float
    elbo: np.ndarray  # trace, length n_iters + 1 (initial ELBO first)
    n_iters: int = 0


@dataclass
class ClonealignFit:
    """Result of :func:`clonealign_torch.clonealign`.

    Field contract mirrors the reference fit object
    (reference tests/testthat/test_clonealign.R:35-37, SURVEY.md §2.3):
    ``clone``, ``ml_params`` (clone_probs/mu/s/alpha, plus psi/W/chi when
    K>0 and beta when P>0), ``convergence_info``, ``retained_genes``,
    ``correlations``, ``clone_probs_from_snv``; multi-restart fits add
    ``multirun_info``. ``timings`` holds the wall seconds of the fit's
    phases (``setup``, ``init``, ``inference``, ``loop``, ``package``,
    measured after synchronizing the device), and for a restart sweep also
    ``iterations``, each restart's Adam iterations; it is not saved.
    """

    clone: List[str]
    ml_params: Dict[str, np.ndarray]
    convergence_info: ConvergenceInfo
    retained_genes: List
    correlations: np.ndarray
    clone_names: List[str]
    clone_probs_from_snv: Optional[np.ndarray] = None
    multirun_info: Optional[dict] = None
    timings: Optional[Dict[str, float]] = None

    def __repr__(self):  # reference R/clonealign.R:348-357
        n = len(self.clone)
        g = len(np.atleast_1d(self.ml_params.get("mu", [])))
        c = len(self.clone_names)
        return (
            f"A clonealign_fit for {n} cells, {g} genes, and {c} clones\n"
            "To access clone assignments, call fit.clone\n"
            "To access ML parameter estimates, call fit.ml_params"
        )

    # --- persistence (the reference's saveRDS analog; SURVEY.md §5
    # "Checkpoint / resume") ---

    def save(self, path: str) -> str:
        """Serialize to a single .npz archive.

        Returns the path actually written: np.savez appends ``.npz`` when
        the name lacks it, so callers reporting the destination must use
        the return value, not their argument."""
        arrays = {
            "clone": np.asarray(self.clone, dtype=object).astype(str),
            "clone_names": np.asarray(self.clone_names, dtype=str),
            "retained_genes": np.asarray([str(g) for g in self.retained_genes], dtype=np.str_),
            "correlations": np.asarray(self.correlations, np.float64),
            "conv_final_elbo": np.asarray(self.convergence_info.final_elbo),
            "conv_sd_final_elbo": np.asarray(self.convergence_info.sd_final_elbo),
            "conv_elbo": np.asarray(self.convergence_info.elbo),
            "conv_n_iters": np.asarray(self.convergence_info.n_iters),
        }
        for k, v in self.ml_params.items():
            arrays[f"ml__{k}"] = np.asarray(v)
        if self.clone_probs_from_snv is not None:
            arrays["clone_probs_from_snv"] = np.asarray(self.clone_probs_from_snv)
        if self.multirun_info is not None:
            # flat, pickle-free encoding of the sweep QC payload
            arrays["mr__elbos"] = np.asarray(self.multirun_info["elbos"], np.float64)
            arrays["mr__median_correlations"] = np.asarray(
                self.multirun_info["median_correlations"], np.float64
            )
            import json as _json

            arrays["mr__prevalences_json"] = np.asarray(
                _json.dumps(
                    self.multirun_info["clone_prevalences_at_different_shrinks"]
                )
            )
            arrays["mr__initial_shrinks"] = np.asarray(
                self.multirun_info["initial_shrinks"], np.float64
            )
            arrays["mr__best_run"] = np.asarray(self.multirun_info["best_run"])
        np.savez_compressed(path, **arrays)
        return path if str(path).endswith(".npz") else f"{path}.npz"

    @classmethod
    def load(cls, path: str) -> "ClonealignFit":
        z = np.load(path, allow_pickle=False)
        ml_params = {k[4:]: z[k] for k in z.files if k.startswith("ml__")}
        return cls(
            clone=[str(c) for c in z["clone"]],
            ml_params=ml_params,
            convergence_info=ConvergenceInfo(
                final_elbo=float(z["conv_final_elbo"]),
                sd_final_elbo=float(z["conv_sd_final_elbo"]),
                elbo=z["conv_elbo"],
                n_iters=int(z["conv_n_iters"]),
            ),
            retained_genes=[str(g) for g in z["retained_genes"]],
            correlations=z["correlations"],
            clone_names=[str(c) for c in z["clone_names"]],
            clone_probs_from_snv=(
                z["clone_probs_from_snv"] if "clone_probs_from_snv" in z.files else None
            ),
            multirun_info=cls._load_multirun_info(z),
        )

    @staticmethod
    def _load_multirun_info(z):
        if "mr__elbos" not in z.files:
            return None
        import json as _json

        return {
            "elbos": z["mr__elbos"],
            "clone_prevalences_at_different_shrinks": _json.loads(
                str(z["mr__prevalences_json"])
            ),
            "median_correlations": z["mr__median_correlations"],
            "initial_shrinks": z["mr__initial_shrinks"],
            "best_run": int(z["mr__best_run"]),
        }

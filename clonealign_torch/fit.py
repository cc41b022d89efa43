"""The fit object (reference's ``clonealign_fit`` S3 class,
R/clonealign.R:303,348-357) as a plain dataclass of NumPy arrays; a copy of
``clonealign_tpu/fit.py``, with ``timings`` added."""

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

    def save_rds(self, path: str, compress: str = "gzip") -> None:
        """Write the fit as an ``.rds`` file readable by R's ``readRDS()``.

        The exported list mirrors the reference's saved fit object
        (reference R/clonealign.R:303 builds the ``clonealign_fit`` list;
        users persist it with ``saveRDS``, which is exactly how the bundled
        ``example_clonealign_fit.rda`` was made): slots ``clone``,
        ``ml_params`` (``clone_probs`` carries the clone names as column
        dimnames, reference R/clonealign.R:286), ``convergence_info``,
        ``retained_genes``, ``correlations``, ``clone_probs_from_snv``, and
        ``multirun_info`` when present, with ``class = "clonealign_fit"`` —
        so existing downstream R code keeps working on fits produced here.
        """
        from .io.rds import RObj, write_rds

        clone_names = [str(c) for c in self.clone_names]
        ml: Dict[str, object] = {}
        for k, v in self.ml_params.items():
            arr = np.asarray(v)
            if arr.dtype.kind == "f":
                arr = arr.astype(np.float64)  # R numeric is double
            if k == "clone_probs" and arr.ndim == 2:
                arr = RObj(arr, {"dimnames": RObj([None, clone_names])})
            ml[k] = arr
        payload: Dict[str, object] = {
            # dtype=np.str_ keeps zero-length vectors character() (an
            # untyped np.asarray([]) is float64 -> would export numeric(0))
            "clone": np.asarray([str(c) for c in self.clone], dtype=np.str_),
            "ml_params": ml,
            "convergence_info": {
                "final_elbo": float(self.convergence_info.final_elbo),
                "sd_final_elbo": float(self.convergence_info.sd_final_elbo),
                "elbo": np.asarray(self.convergence_info.elbo, np.float64),
                "n_iters": int(self.convergence_info.n_iters),
            },
            "retained_genes": np.asarray([str(g) for g in self.retained_genes], dtype=np.str_),
            "correlations": np.asarray(self.correlations, np.float64),
            "clone_probs_from_snv": (
                None
                if self.clone_probs_from_snv is None
                else RObj(
                    np.asarray(self.clone_probs_from_snv, np.float64),
                    {"dimnames": RObj([None, clone_names])},
                )
            ),
        }
        if self.multirun_info is not None:
            mr = self.multirun_info
            payload["multirun_info"] = {
                "elbos": np.asarray(mr["elbos"], np.float64),
                # the reference stores `table(ca$clone)` per run (reference
                # R/clonealign.R:69); a named integer vector indexes the same
                "clone_prevalences_at_different_shrinks": [
                    RObj(
                        np.asarray(list(tab.values()), np.int32),
                        {"names": [str(k) for k in tab.keys()]},
                    )
                    for tab in mr["clone_prevalences_at_different_shrinks"]
                ],
                "median_correlations": np.asarray(
                    mr["median_correlations"], np.float64
                ),
                "initial_shrinks": np.asarray(mr["initial_shrinks"], np.float64),
                "best_run": int(mr["best_run"]) + 1,  # 1-based for R readers
            }
        write_rds(
            RObj(payload, {"class": ["clonealign_fit"]}), path, compress=compress
        )

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

    @classmethod
    def load_rds(cls, path: str) -> "ClonealignFit":
        """Load a fit that R saved with ``saveRDS()`` (or :meth:`save_rds`).

        Accepts the reference's ``clonealign_fit`` list layout (reference
        R/clonealign.R:303: ``clone``, ``ml_params``, ``convergence_info``,
        ``retained_genes``, ``correlations``, ``clone_probs_from_snv``, plus
        ``multirun_info`` from ``run_clonealign``, reference
        R/clonealign.R:67-72) — so fits produced by the original R package
        can be re-thresholded (:func:`recompute_clone_assignment`), printed,
        plotted, and served against (:func:`clonealign_torch.serve.assign_cells`)
        without an R runtime. Clone names come from ``clone_probs``'s column
        dimnames (reference R/clonealign.R:286).

        Also accepts the v1-era layout of the bundled
        ``example_clonealign_fit.rda`` (slots ``clone``, ``ml_params``,
        ``log_lik``, ``retained_genes``, ``basis_means`` — the pre-v2
        negative-binomial model): ``convergence_info`` is synthesized from
        the ``log_lik`` trace and the extra ML parameters (``phi``, ``a``,
        ``b``, ``basis_means``) are kept in ``ml_params``."""
        from .io.rds import RObj, read_rda, read_rds, unwrap

        def named(o, what):
            names = o.attr("names") if isinstance(o, RObj) else None
            if names is None:
                raise ValueError(f"{path}: expected a named R list for {what}")
            return dict(zip([str(n) for n in names], o.value))

        def array(o):
            """Reassemble an R vector/matrix (flat column-major + dim)."""
            dim = o.attr("dim") if isinstance(o, RObj) else None
            a = np.asarray(unwrap(o))
            if dim is not None:
                a = a.reshape(tuple(int(d) for d in dim), order="F")
            return a

        def strings(o):
            return [str(s) for s in unwrap(o)] if unwrap(o) is not None else []

        if path.endswith((".rda", ".RData", ".Rdata")):
            # workspace save (e.g. the bundled example_clonealign_fit.rda):
            # take the clonealign_fit-classed object, or the only object
            objs = read_rda(path)
            fits = {
                k: v
                for k, v in objs.items()
                if isinstance(v, RObj) and v.rclass == ["clonealign_fit"]
            }
            pool = fits or objs
            if len(pool) != 1:
                raise ValueError(
                    f"{path}: workspace holds {sorted(objs)} — expected exactly "
                    "one clonealign_fit object"
                )
            (obj,) = pool.values()
        else:
            obj = read_rds(path)
        if isinstance(obj, RObj) and obj.rclass not in (None, ["clonealign_fit"]):
            raise ValueError(
                f"{path}: R object has class {obj.rclass}, not clonealign_fit"
            )
        top = named(obj, "the fit")
        ml_r = named(top["ml_params"], "ml_params")
        ml = {k: array(v) for k, v in ml_r.items() if unwrap(v) is not None}
        for k in ("s", "mu", "alpha", "chi"):
            if k in ml:
                ml[k] = ml[k].ravel()

        cp = ml_r.get("clone_probs")
        dimnames = cp.attr("dimnames") if isinstance(cp, RObj) else None
        if dimnames is not None and unwrap(dimnames[1]) is not None:
            clone_names = strings(dimnames[1])
        else:  # unnamed matrix: fall back to observed labels
            clone_names = sorted(set(strings(top["clone"])) - {"unassigned"})

        if "convergence_info" in top:
            ci = named(top["convergence_info"], "convergence_info")
            trace = array(ci["elbo"]).ravel() if "elbo" in ci else np.asarray([])
            conv = ConvergenceInfo(
                final_elbo=float(array(ci["final_elbo"]).ravel()[0]),
                sd_final_elbo=float(array(ci["sd_final_elbo"]).ravel()[0]),
                elbo=trace,
                # R fits carry no n_iters slot; the trace is initial + one/iter
                n_iters=(
                    int(array(ci["n_iters"]).ravel()[0])
                    if "n_iters" in ci
                    else max(trace.size - 1, 0)
                ),
            )
        elif "log_lik" in top:  # v1 layout: per-iteration log-lik trace only
            trace = array(top["log_lik"]).ravel()
            if unwrap(top.get("basis_means")) is not None:
                ml["basis_means"] = array(top["basis_means"]).ravel()
            conv = ConvergenceInfo(
                final_elbo=float(trace[-1]) if trace.size else float("nan"),
                sd_final_elbo=float("nan"),
                elbo=trace,
                n_iters=max(trace.size - 1, 0),
            )
        else:
            raise ValueError(
                f"{path}: no convergence_info or log_lik slot — "
                "not a clonealign fit layout this loader knows"
            )

        multirun = None
        if unwrap(top.get("multirun_info")) is not None:
            mr = named(top["multirun_info"], "multirun_info")
            tabs = []
            for tab in unwrap(mr["clone_prevalences_at_different_shrinks"]):
                labels = tab.attr("names") if isinstance(tab, RObj) else None
                counts = array(tab).ravel()
                tabs.append(
                    {str(l): int(c) for l, c in zip(strings(labels), counts)}
                )
            multirun = {
                "elbos": array(mr["elbos"]).ravel(),
                "clone_prevalences_at_different_shrinks": tabs,
                "median_correlations": array(mr["median_correlations"]).ravel(),
                "initial_shrinks": array(mr["initial_shrinks"]).ravel(),
                "best_run": int(array(mr["best_run"]).ravel()[0]) - 1,  # 1-based in R
            }

        snv = top.get("clone_probs_from_snv")
        return cls(
            clone=strings(top["clone"]),
            ml_params=ml,
            convergence_info=conv,
            retained_genes=strings(top["retained_genes"]),
            correlations=(
                array(top["correlations"]).ravel()
                if unwrap(top.get("correlations")) is not None
                else np.asarray([])
            ),
            clone_names=clone_names,
            clone_probs_from_snv=array(snv) if unwrap(snv) is not None else None,
            multirun_info=multirun,
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

"""clonealign_torch: the clonealign fit in PyTorch, with its likelihood in
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``clonealign_tpu`` that sits beside it: module
paths and public names mirror it, and its tests hold this package against
it on identical inputs. Every public entry point takes ``device``: "cuda"
by default, or "cpu". On CPU tensors the likelihood runs its plain PyTorch
version; on CUDA tensors only the kernels in ``ops/csrc``.

Public API:

- :func:`clonealign` — fit a single model
- :func:`run_clonealign` — multi-restart sweep, best-ELBO fit
- :func:`fit_streaming` — the fit with Y streamed through the card in chunks
- :func:`assign_cells` — assign new cells against a fitted model
- :func:`preprocess_for_clonealign` — gene/cell filtering
- :func:`recompute_clone_assignment` — re-threshold clone calls
- :func:`inference_em`, :func:`gibbs_pi_rho` — the legacy v1
  negative-binomial family (``models/negbin.py``), its fit
  :class:`ClonealignV1Fit` and ``models.negbin.classify_cells``
"""

from .api import clonealign, saturate
from .assign import (
    clone_assignment,
    compute_ca_fit_mse,
    compute_correlations,
    recompute_clone_assignment,
)
from .cnv import align_expression_to_cnv, cnv_regions_to_genes
from .fit import ClonealignFit, ConvergenceInfo
from .models.negbin import (
    ClonealignV1Fit,
    clone_probs_from_gibbs,
    gibbs_pi_rho,
    inference_em,
    rho_probs_from_gibbs,
)
from .preprocess import preprocess_for_clonealign
from .restarts import run_clonealign
from .serve import assign_cells
from .stream import fit_streaming

__version__ = "0.5.0"

__all__ = [
    "clonealign",
    "run_clonealign",
    "fit_streaming",
    "assign_cells",
    "preprocess_for_clonealign",
    "recompute_clone_assignment",
    "clone_assignment",
    "compute_correlations",
    "compute_ca_fit_mse",
    "align_expression_to_cnv",
    "cnv_regions_to_genes",
    "saturate",
    "ClonealignFit",
    "ConvergenceInfo",
    "inference_em",
    "gibbs_pi_rho",
    "clone_probs_from_gibbs",
    "rho_probs_from_gibbs",
    "ClonealignV1Fit",
    "__version__",
]

try:  # matplotlib is optional
    from .plot import plot_clonealign, plot_clonealign_adata  # noqa: F401

    __all__ += ["plot_clonealign", "plot_clonealign_adata"]
except ImportError:  # pragma: no cover
    pass

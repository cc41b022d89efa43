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
- :func:`preprocess_for_clonealign` — gene/cell filtering
- :func:`recompute_clone_assignment` — re-threshold clone calls
"""

from .api import clonealign, saturate
from .assign import clone_assignment, compute_correlations, recompute_clone_assignment
from .fit import ClonealignFit, ConvergenceInfo
from .preprocess import preprocess_for_clonealign
from .restarts import run_clonealign

__all__ = [
    "clonealign",
    "run_clonealign",
    "preprocess_for_clonealign",
    "recompute_clone_assignment",
    "clone_assignment",
    "compute_correlations",
    "saturate",
    "ClonealignFit",
    "ConvergenceInfo",
]

"""Multi-restart sweep (reference R/clonealign.R:35-75), counterpart of
``clonealign_tpu/restarts.py``.

The restarts run one after another on the device ("map" batching in the JAX
package), each exactly the single-fit path. The deterministic init passes —
the PCA scores and the mu guess — run once and are shared by every lane;
only the psi jitter and the Monte Carlo draws differ between restarts, as
in the reference.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import assign as _assign
from .api import _not_ported, _package_fit, setup_fit
from .infer import run_inference
from .models import multinomial as mm
from .utils.noise import Noise


def run_clonealign(
    gene_expression_data,
    copy_number_data,
    initial_shrinks: Sequence[float] = (0, 5, 10),
    n_repeats: int = 3,
    print_elbos: bool = True,
    max_iter: int = 200,
    rel_tol: float = 1e-6,
    learning_rate: float = 0.1,
    clone_call_probability: float = 0.95,
    seed: Optional[int] = None,
    elbo_eval: str = "fresh",
    mesh=None,
    restart_batching: str = "auto",
    multirun_correlations: bool = True,
    *,
    device,
    **kwargs,
):
    """Sweep restarts, return the max-ELBO fit with ``multirun_info`` attached
    (reference R/clonealign.R:35-75). Extra kwargs go to the model setup
    (same names as :func:`clonealign_torch.clonealign`).

    Restart r draws from ``Noise(seed + r)``, so a one-restart sweep is the
    single fit with the same seed. ``restart_batching`` "auto" and "map" run
    the restarts in sequence.
    """
    if mesh is not None:
        raise _not_ported("mesh sharding", "distributed")
    if restart_batching == "vmap":
        raise _not_ported("restart_batching='vmap'", "R-batched restarts")
    if restart_batching not in ("auto", "map"):
        raise ValueError(
            f"restart_batching must be 'auto', 'map' or 'vmap', got {restart_batching!r}"
        )
    verbose = kwargs.get("verbose", True)
    ctx = setup_fit(gene_expression_data, copy_number_data, device=device, **kwargs)
    config, data = ctx.config, ctx.data

    shrinks = np.asarray(
        [s for s in initial_shrinks for _ in range(n_repeats)], np.float64
    )
    R = len(shrinks)
    base = 0 if seed is None else int(seed)
    noises = [Noise(base + r, ctx.device) for r in range(R)]

    shared_pca = None
    if config.K > 0:
        shared_pca = mm.pca_init_scores(data.Y, config.K, noises[0], ctx.dtype)
    shared_mu = None
    if ctx.data_init_mu is True:
        shared_mu = mm.data_mu_guess(data.Y, ctx.dtype)

    results = []
    for noise, shrink in zip(noises, shrinks):
        params0 = mm.init_params(
            data.Y, data.L, noise, K=config.K, data_init_mu=ctx.data_init_mu,
            dtype=ctx.dtype, pca_scores=shared_pca, mu_guess=shared_mu,
        )
        results.append(run_inference(
            params0, data, noise, config,
            max_iter=int(max_iter), rel_tol=float(rel_tol),
            learning_rate=float(learning_rate), initial_shrink=float(shrink),
            elbo_eval=elbo_eval,
        ))

    final_elbos = np.asarray([r.final_elbo for r in results], np.float64)
    if print_elbos and verbose:
        print("ELBOs: ", " ".join(str(e) for e in final_elbos))

    # NaN-safe best: np.argmax would select a diverged (NaN) lane over all
    # finite ones. All-NaN mirrors the reference's NA-initial-ELBO hard error
    # (reference R/inference-tflow.R:372-376).
    if np.isnan(final_elbos).all():
        raise ValueError(
            "All restarts produced NaN ELBOs — inference diverged; try a "
            "lower learning_rate"
        )
    best = int(np.nanargmax(final_elbos))

    fit = _package_fit(
        results[best],
        ctx.Y,
        ctx.L,
        ctx.clone_names,
        ctx.retained_genes,
        config,
        clone_call_probability,
        device_Y=data.Y,
        device_s=data.s,
    )

    # multirun_info (reference R/clonealign.R:67-73)
    called, counts = _assign.multirun_calls_device(
        torch.stack([r.params.gamma_logits for r in results]), clone_call_probability
    )
    labels_all = [str(c) for c in ctx.clone_names] + [_assign.UNASSIGNED]
    prevalences = []
    median_correlations = []
    for r in range(R):
        prevalences.append(
            {labels_all[i]: int(n) for i, n in enumerate(counts[r]) if n}
        )
        if multirun_correlations:
            corr_r = _assign.compute_correlations(
                ctx.Y, ctx.L, None, ctx.clone_names,
                device_Y=data.Y, clones_idx=called[r],
            )
            finite = corr_r[np.isfinite(corr_r)]
            median_correlations.append(float(np.median(finite)) if finite.size else np.nan)
        else:
            median_correlations.append(np.nan)

    fit.multirun_info = {
        "elbos": final_elbos,
        "clone_prevalences_at_different_shrinks": prevalences,
        "median_correlations": np.asarray(median_correlations),
        "initial_shrinks": shrinks,
        "best_run": best,
    }
    return fit

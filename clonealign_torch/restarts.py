"""Multi-restart sweep (reference R/clonealign.R:35-75), counterpart of
``clonealign_tpu/restarts.py``.

The restarts run either as lanes of one batched loop ("vmap",
:func:`clonealign_torch.infer.run_inference_lanes`: one host sync per
iteration for every lane, a converged lane freezes while the rest go on) or
one after another ("map", each exactly the single-fit path). The
deterministic init passes — the PCA scores and the mu guess — run once and
are shared by every lane; only the psi jitter and the Monte Carlo draws
differ between restarts, as in the reference.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import assign as _assign
from .api import _check_reference_keywords, _package_fit, setup_fit
from .infer import lane_result, run_inference, run_inference_lanes, stack_lanes
from .models import multinomial as mm
from .ops import fused_likelihood as fl
from .parallel.collectives import check_mesh, world_max
from .utils.device import synchronize
from .utils.noise import Noise

# Bytes the lane-batched sweep may plan to hold on the device: half the
# 80 GB of one NVIDIA H100 80GB HBM3 (700 W), the card the port is built for,
# leaving the rest to the caching allocator's slack, the CUDA context and
# the kernels' per-call scratch. The CPU path is held to the same budget.
SWEEP_BUDGET_BYTES = 40 * 10**9


# _sweep_bytes' counts: (S, C, N) and (C, N) tensors a lane's ELBO holds,
# (S, C, N) transients of the one lane the op runs at a time, and the
# parameter sets "map" holds for each restart (the card measured 2.8).
_ELBO_SCN = 1
_ELBO_CN = 9
_OP_SCN = 2
_MAP_HELD = 3


def _sweep_bytes(N, G, C, K, S, n_lanes, itemsize, device_type, y_itemsize=None, P=0,
                 z_cheb=False, allele=False, batching="vmap") -> int:
    """The sweep's working set, reckoned from the code, in bytes: of
    ``n_lanes`` restarts run as lanes of one loop (``batching="vmap"``), or
    one after another (``"map"``); ``itemsize`` is the compute dtype's,
    ``y_itemsize`` Y's storage type's (by default the compute dtype's), P
    the covariate columns, ``z_cheb`` whether the likelihood resolved to
    the Chebyshev normalizer and ``allele`` whether the fit carries the
    allele term.

    Shared by every lane: Y (N x G, at its storage itemsize), the
    covariates X (N x P) and the allele term (N x C). On CUDA the kernels
    store no N x G tensor and read Y as it is stored; only z_cheb's products
    with Y convert a narrow Y, a row block (``_CHUNK_ELEMENTS`` elements at
    most) at a time in the compute dtype. On the CPU the fused op's plain
    version holds about three N x G temporaries (log_rfe, rfe and dlog_rfe
    in its backward), and a fourth for Y converted from narrow storage; the
    lane loop in ``models/multinomial._likelihood_terms`` runs it one lane
    at a time, so they are held once, not per lane.

    Per live lane: the parameters n_par = N (K + C) + G (K + P + 2) + K + C,
    9 n_par in all (the caller's initial values and their stacked,
    warm-started copy, the leaves, their gradients, the two Adam moments and
    the step's three candidates, ``infer.TF1Adam.step``); the ELBO's
    tensors that stay per lane until the backward, counted apart by shape
    (``models/multinomial.elbo``): _ELBO_SCN of (S, C, N) (the stacked Z
    that its log saves) and _ELBO_CN of (C, N) (the samples' mean of the
    clone log-likelihoods, gamma and log gamma, the masked products and the
    gradients of gamma's logits); the fused op's YW and A1 (N (K + P) + N);
    and with covariates the concatenations [psi, X] and [W, beta] it saves
    ((N + G)(K + P)). Held once, since the op runs one lane at a time: that
    lane's _OP_SCN (S, C, N) transients (log Z, the clone log-likelihoods,
    the gradient of Z). "map" runs one live lane beside every restart's
    initial parameters and, once run, its result, _MAP_HELD n_par each.

    Held once on CUDA: with the exact backward, the gene part's scratch
    (``fused_likelihood.gene_scratch``: partial sums of each chunk of
    cells, the packed cell side) and its (K + P + S C, G) sums; where the
    wide family runs (K + P, S or S C past the narrow kernels' limits;
    ``fused_likelihood.wide_plan``) the wide forward's packed gene table
    (every forward, z_cheb's too), and with the exact backward the wide
    dpsi's packed gene table and the wide gene part's workspace in place of
    the narrow one's. In float64 (``itemsize`` 8) the float64 family runs at
    every width: its forward's packed gene table (``fwd_workspace``, every
    forward) and with the exact backward dpsi's packed gene table
    (``dpsi_workspace``) and its gene part's partial sums, packed cell
    table and sums (``fused_likelihood.f64_plan``'s ``gene_workspace``),
    float64 values.

    The counts of the ELBO's tensors and of "map"'s held parameters are the
    code's order fitted to the card's peaks (``chip_smoke.inference_peaks``;
    tests/test_torch_restarts.py holds the reckoning between them and 1.3
    times them).
    """
    y_itemsize = itemsize if y_itemsize is None else y_itemsize
    narrow = y_itemsize != itemsize
    if device_type == "cuda":
        temporaries = min(N * G, mm._CHUNK_ELEMENTS) if narrow and z_cheb else 0
    else:
        temporaries = N * G * (4 if narrow else 3)
    Kf = K + P
    n_par = N * (K + C) + G * (Kf + 2) + K + C
    saved_ext = (N + G) * Kf if P else 0
    per_lane = (9 * n_par + _ELBO_SCN * N * S * C + _ELBO_CN * N * C + N * (Kf + 1)
                + saved_ext)
    live, held = (n_lanes, 0) if batching == "vmap" else (min(n_lanes, 1),
                                                          _MAP_HELD * n_lanes * n_par)
    shared = N * P + (N * C if allele else 0) + (_OP_SCN * N * S * C if live else 0)
    workspace = 0
    if device_type == "cuda" and itemsize == 8:
        plan = fl.f64_plan(N, G, Kf, 0, S * C)
        workspace += 8 * plan["fwd_workspace"]
        if not z_cheb:
            workspace += 8 * (plan["gene_workspace"] + (plan["dpsi_workspace"] if Kf else 0))
    elif device_type == "cuda":
        if fl.wide_route(Kf, S, S * C):
            workspace += 4 * fl.wide_plan(N, G, Kf, S, S * C)["fwd_workspace"]
        if not z_cheb and fl.wide_route(Kf, 0, S * C):
            workspace += 4 * (fl.gene_wide_workspace(N, G, Kf, 0, S * C)
                              + (fl.wide_plan(N, G, Kf, 0, S * C)["dpsi_workspace"] if Kf else 0))
        elif not z_cheb:
            workspace += 4 * (fl.gene_scratch(N, G, Kf, 0, S * C) + (Kf + S * C) * G)
    return (y_itemsize * N * G + itemsize * (shared + temporaries + held + live * per_lane)
            + workspace)


def _auto_restart_batching(N, G, C, K, S, n_lanes, itemsize, device_type, y_itemsize=None,
                           P=0, z_cheb=False, allele=False, cells=None, genes=None) -> str:
    """"vmap" when the lane-batched sweep's working set (:func:`_sweep_bytes`)
    fits :data:`SWEEP_BUDGET_BYTES`, else "map", which holds one lane at a
    time. At 100,000 x 5,000 x 10 (K = 1, S = 1, float32) a lane adds about
    81 MB to Y's 2 GB, so "vmap" takes up to 469 lanes there. (The JAX
    package's 6e9 lane-elements cutover was measured on a 16 GB TPU v5e and
    does not carry over.) On a mesh (``cells``, ``genes``) N and G are this
    rank's tile, N_c x G_g, and the largest need of any rank decides, so
    that every rank batches alike: ranks that differ would run different
    collectives."""
    need = _sweep_bytes(N, G, C, K, S, n_lanes, itemsize, device_type, y_itemsize, P, z_cheb,
                        allele)
    need = world_max(float(need), cells, genes)
    return "vmap" if need <= SWEEP_BUDGET_BYTES else "map"


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
    key=None,
    elbo_eval: str = "fresh",
    mesh=None,
    restart_batching: str = "auto",
    loop_impl: str = "while",
    unroll: int = 1,
    remat="auto",
    multirun_correlations: bool = True,
    *,
    device="cuda",
    **kwargs,
):
    """Sweep restarts, return the max-ELBO fit with ``multirun_info`` attached
    (reference R/clonealign.R:35-75). Extra kwargs go to the model setup
    (same names as :func:`clonealign_torch.clonealign`, the covariates ``x``,
    the allele data and a sparse count matrix among them; every lane has its
    own beta and shares the allele term).

    Restart r draws from ``Noise(seed + r)``, so a one-restart sweep is the
    single fit with the same seed. ``restart_batching``: "vmap" runs the
    restarts as lanes of one batched loop, "map" one after another (memory of
    one fit), "auto" picks "vmap" when the sweep's working set fits the
    card (:func:`_auto_restart_batching`). Both give each lane the same
    iterations, launches and results; in float32 on CUDA the batched
    reductions may round differently. ``loop_impl``, ``unroll`` and
    ``remat`` are the JAX package's compilation controls: accepted, with no
    effect here. ``key`` is refused: pass ``seed``.

    ``mesh`` (:func:`clonealign_torch.parallel.sharding.make_mesh`) splits
    the cells, and with ``gene_parallelism`` the kept genes, over its
    ranks: every rank calls this with the whole input, keeps and uploads
    its tile (its block of rows, its block of their columns) and runs the
    sweep on it with the fused kernels, on the mesh's device (``device``
    is not read); the sums over cells and over genes are all-reduced
    (``api.setup_fit``, ``infer``, ``models/multinomial``). Every rank
    returns the fit the one-process call gives on the whole matrix, clone
    calls, correlations and ``multirun_info`` included.
    """
    _check_reference_keywords(key, loop_impl)
    if mesh is not None:
        device = check_mesh(mesh).device
    if restart_batching not in ("auto", "map", "vmap"):
        raise ValueError(
            f"restart_batching must be 'auto', 'map' or 'vmap', got {restart_batching!r}"
        )
    verbose = kwargs.get("verbose", True)
    t0 = time.perf_counter()
    ctx = setup_fit(gene_expression_data, copy_number_data, device=device, mesh=mesh, **kwargs)
    config, data, cells, genes = ctx.config, ctx.data, ctx.cells, ctx.genes
    synchronize(ctx.device)
    t1 = time.perf_counter()

    shrinks = np.asarray(
        [s for s in initial_shrinks for _ in range(n_repeats)], np.float64
    )
    R = len(shrinks)
    if restart_batching == "auto":
        (N, G), C = data.Y.shape, data.L.shape[1]
        restart_batching = _auto_restart_batching(
            N, G, C, config.K, config.mc_samples, R,
            torch.finfo(ctx.dtype).bits // 8, ctx.device.type, data.Y.element_size(),
            config.P, mm._use_z_cheb(config), ctx.extra_log_lik is not None, cells, genes,
        )
    base = 0 if seed is None else int(seed)
    noises = [Noise(base + r, ctx.device) for r in range(R)]

    shared_pca = None
    if config.K > 0:
        shared_pca = mm.pca_init_scores(data.Y, config.K, noises[0], ctx.dtype, cells=cells,
                                        genes=genes)
    shared_mu = None
    if ctx.data_init_mu is True:
        shared_mu = mm.data_mu_guess(data.Y, ctx.dtype, cells=cells, genes=genes)

    params0 = [
        mm.init_params(
            data.Y, data.L, noise, K=config.K, data_init_mu=ctx.data_init_mu,
            dtype=ctx.dtype, pca_scores=shared_pca, mu_guess=shared_mu, P=config.P,
            cells=cells, genes=genes,
        )
        for noise in noises
    ]
    synchronize(ctx.device)
    t2 = time.perf_counter()

    loop = dict(max_iter=int(max_iter), rel_tol=float(rel_tol),
                learning_rate=float(learning_rate), elbo_eval=elbo_eval,
                extra_log_lik=ctx.extra_log_lik)
    if restart_batching == "vmap":
        lanes = run_inference_lanes(stack_lanes(params0), data, noises, config,
                                    initial_shrinks=shrinks, **loop)
        results = [lane_result(lanes, r) for r in range(R)]
        loop_seconds = lanes.loop_seconds
    else:
        results = [
            run_inference(p, data, noise, config, initial_shrink=float(shrink), **loop)
            for p, noise, shrink in zip(params0, noises, shrinks)
        ]
        loop_seconds = sum(r.loop_seconds for r in results)
    t3 = time.perf_counter()

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
        ctx.clone_probs_from_snv,
        device_Y=data.Y,
        device_s=data.s,
        cells=cells,
        genes=genes,
    )

    # multirun_info (reference R/clonealign.R:67-73)
    called, counts = _assign.multirun_calls_device(
        torch.stack([r.params.gamma_logits for r in results]), clone_call_probability, cells
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
                device_Y=data.Y, clones_idx=called[r], dtype=ctx.dtype, cells=cells,
                genes=genes,
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
    fit.timings = {
        "setup": t1 - t0,
        "init": t2 - t1,
        "inference": t3 - t2,
        "loop": loop_seconds,
        "package": time.perf_counter() - t3,
        "iterations": [r.n_iters for r in results],
    }
    return fit

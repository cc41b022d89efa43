"""Serving: assign new cells against an already-fitted model, without
refitting (counterpart of ``clonealign_tpu/serve.py``).

The fitted gene-level parameters (mu, the clone priors alpha) give a
posterior over clones for any new cell in closed form:

    log p(z=c | y) ∝ log alpha_c + log Multinomial(y | t, p_c)
    p_c ∝ mu * L[:, c]                       (rfe = 1 for unseen cells)

that is ``Y_new @ log(mu L) - t log Z(c)`` up to per-cell constants: one
pass over Y (:func:`_posterior_log_probs`).

For a fit with one latent factor (K = 1), ``latent="refine"`` restores the
per-cell modulation ``exp(psi_n W_g)`` by a Laplace approximation per
(cell, clone): a damped-Newton solve for the MAP psi (the objective is
strictly concave in psi) and the curvature correction -½ log(-f'')
(:func:`_posterior_log_probs_refined`). It costs about ``newton_iters`` + 1
passes over an (N, G) workspace per clone, made one clone and one row block
at a time.

No kernel of its own: the JAX package's serving is plain products and
softmax moments, so here too the products are ``torch.matmul`` in full
float32 (TF32 off) and the rest elementwise PyTorch. Y travels to the device
in its narrowest exact type (int8 or int16 where the counts fit), one row
block of ``models/multinomial._CHUNK_ELEMENTS`` at a time, and each block's
products are taken before the next is uploaded: the device never holds the
whole of Y.
"""

from __future__ import annotations

import numpy as np
import torch

from . import assign as _assign
from .api import _auto_y_storage, _canonical_csr, _parse_copy_number, _validate_counts
from .models import multinomial as mm
from .stream import _DeviceRows, _RowSource
from .utils.device import full_fp32_matmul, resolve_device
from .utils.sparsity import is_scipy_sparse as _is_scipy_sparse


@torch.no_grad()
def _posterior_parts(Y, L, mu, log_alpha, W=None):
    """The unnormalized clone log-posteriors (N_new, C) of :func:`_posterior_log_probs`,
    with ``Y @ W[:, 0]`` (N_new,) when ``W`` is given (else None) and the
    totals t (N_new,), from one row-blocked product of Y with
    ``[log(mu L), mu L <= 0, 1, W[:, :1]]`` in full float32
    (``models/multinomial._y_times``)."""
    C = L.shape[1]
    rates = mu[:, None] * L
    zero = rates <= 0
    log_rates = torch.where(zero, 0.0, torch.log(torch.where(zero, 1.0, rates)))
    cols = [log_rates, zero.to(rates.dtype), torch.ones_like(mu)[:, None]]
    cols += [] if W is None else [W[:, :1]]
    prod = mm._y_times(Y, torch.cat(cols, dim=1))  # (N, 2C + 1 [+ 1])
    ylogr, hits, t = prod[:, :C], prod[:, C:2 * C], prod[:, 2 * C]
    ylogr = torch.where(hits > 0, -torch.inf, ylogr)
    log_Z = torch.log(torch.sum(rates, dim=0))[None, :]
    lp = log_alpha[None, :] + ylogr - t[:, None] * log_Z
    return lp, None if W is None else prod[:, 2 * C + 1], t


def _posterior_log_probs(Y, L, mu, log_alpha):
    """(N_new, C) unnormalized clone log-posteriors of new cells (reference
    serve.py:39-58). ``Y`` is (N_new, G) on the device in any storage type;
    ``L`` (G, C), ``mu`` (G,) and ``log_alpha`` (C,) in the compute dtype."""
    return _posterior_parts(Y, L, mu, log_alpha)[0]


def _clone_stats(lw, safe, w, psi):
    """Softmax moments of w under p_g ∝ rate_g exp(w_g psi_n) for one clone
    and a block of cells (reference serve.py:77-89): E_w (B,), Var_w (B,)
    and the log-normalizer (B,). ``lw`` (G,) is the clone's log rates,
    ``safe`` (G,) where its rate is positive."""
    logits = torch.where(safe[None, :], lw[None, :] + w[None, :] * psi[:, None], -torch.inf)
    logsumZ = torch.logsumexp(logits, dim=1)
    p = torch.softmax(logits, dim=1)
    with full_fp32_matmul():
        Ew = p @ w
        var = torch.clamp_min(p @ (w * w) - Ew * Ew, 0.0)
    return Ew, var, logsumZ


@torch.no_grad()
def _refine(base, yW, t, L, mu, W, newton_iters):
    """The Laplace refinement of :func:`_posterior_log_probs_refined` from
    the plain posterior ``base`` (N, C), ``yW`` and the totals ``t`` (N,).

    Each (cell, clone) pair's solve is independent, so the loop runs over
    clones and, within a clone, over row blocks of ``_CHUNK_ELEMENTS``: one
    (block, G) workspace at a time, whatever N is."""
    w = W[:, 0]
    rates = mu[:, None] * L
    N, C = base.shape
    psi = torch.zeros((N, C), dtype=base.dtype, device=base.device)
    dlogZ = torch.empty_like(psi)
    neg_hess = torch.empty_like(psi)
    for c in range(C):
        safe = rates[:, c] > 0
        lw = torch.log(torch.where(safe, rates[:, c], 1.0))
        _, _, logsum0 = _clone_stats(lw, safe, w, torch.zeros(1, dtype=w.dtype, device=w.device))
        for i, j in mm._row_blocks(N, w.shape[0]):
            p, tb, yb = psi[i:j, c], t[i:j], yW[i:j]
            for _ in range(int(newton_iters)):
                Ew, var, _ = _clone_stats(lw, safe, w, p)
                grad = yb - tb * Ew - p
                hess = -tb * var - 1.0
                p = p - grad / hess
            _, var_f, logsum1 = _clone_stats(lw, safe, w, p)
            psi[i:j, c] = p
            dlogZ[i:j, c] = logsum1 - logsum0
            neg_hess[i:j, c] = tb * var_f + 1.0
    return (
        base
        + yW[:, None] * psi
        - t[:, None] * dlogZ
        - 0.5 * psi * psi
        - 0.5 * torch.log(neg_hess)
    )


def _posterior_log_probs_refined(Y, L, mu, log_alpha, W, newton_iters=8):
    """(N_new, C) clone log-posteriors with a MAP psi per (cell, clone), for
    a K = 1 fit (reference serve.py:60-125). For clone c the concave
    objective

        f(p) = yW p - t log Z_c(p) - p²/2,   Z_c(p) = sum_g mu_g L_gc exp(W_g p)

    is maximized by ``newton_iters`` Newton steps from 0 (f'' = -t Var_w(W) - 1
    <= -1), and the clone's log-likelihood is the Laplace approximation
    ``base + yW psi - t (log Z_c(psi) - log Z_c(0)) - psi²/2 - ½ log(-f'')``,
    ``base`` being :func:`_posterior_log_probs`."""
    base, yW, t = _posterior_parts(Y, L, mu, log_alpha, W)
    return _refine(base, yW, t, L, mu, W, newton_iters)


def _transfer_storage(values):
    """The type new counts travel to the device in (reference
    serve.py:128-148): int8 or int16 when every value fits
    (``api._auto_y_storage``), else float32, and float32 whenever a value is
    negative, which a narrowing cast would wrap."""
    if values.size and values.min() < 0:
        return torch.float32
    return _auto_y_storage(values) or torch.float32


def assign_cells(
    fit,
    Y_new,
    copy_number_data=None,
    clone_call_probability: float = 0.95,
    saturate: bool = True,
    saturation_threshold: float = 6,
    latent: str = "auto",
    newton_iters: int = 8,
    *,
    device="cuda",
):
    """Assign new cells to clones using a fitted model's parameters
    (``clonealign_tpu.serve.assign_cells``'s arguments, plus ``device``).

    Args:
      fit: a :class:`~clonealign_torch.fit.ClonealignFit`.
      Y_new: (N_new, G') raw counts over the fit's ``retained_genes`` (same
        order): a dense array or a scipy sparse matrix. They are checked as
        a fit's counts are (``api._validate_counts``: NaN, negative,
        fractional values and cells without counts raise ValueError); a
        sparse matrix with duplicate entries is read by its summed counts,
        from a copy, so the caller's matrix is never changed.
      copy_number_data: the (G', C) copy numbers used in the fit.
      clone_call_probability: threshold for the "unassigned" fallback.
      saturate / saturation_threshold: the fit's own settings.
      latent: ``"ignore"`` sets rfe = 1 (exact for K = 0 fits);
        ``"refine"`` solves each new cell's psi per clone (a K = 1 fit);
        ``"auto"`` refines when the fit has K = 1, else ignores.
      newton_iters: Newton steps of the psi solve.
      device: "cuda" (default) or "cpu"; "cuda" without a GPU raises.

    Returns:
      (clones, clone_probs): the labels and the (N_new, C) float32 posterior
      as a numpy array.
    """
    lp = _log_posteriors(fit, Y_new, copy_number_data, saturate, saturation_threshold, latent,
                         newton_iters, device=device)
    probs = torch.softmax(lp, dim=1).cpu().numpy()
    clones = _assign.clone_assignment(probs, fit.clone_names, clone_call_probability)
    return clones, probs


def _log_posteriors(fit, Y_new, copy_number_data, saturate, saturation_threshold, latent,
                    newton_iters, *, device):
    """:func:`assign_cells`'s checks, then the (N_new, C) float32 clone
    log-posteriors of the new cells on ``device``. Y travels in its transfer type one row
    block of ``_CHUNK_ELEMENTS`` at a time (``stream._DeviceRows``), each
    block's products taken before the next is uploaded."""
    dev = resolve_device(device)
    sparse = _is_scipy_sparse(Y_new)
    Y_new = _canonical_csr(Y_new) if sparse else np.asarray(Y_new)
    G = len(fit.ml_params["mu"])
    if Y_new.ndim != 2 or Y_new.shape[1] != G:
        raise ValueError(
            f"Y_new must be (n_cells, {G}) over the fit's retained_genes; got "
            f"{Y_new.shape}"
        )
    if copy_number_data is None:
        raise ValueError("copy_number_data (genes x clones, over retained_genes) is required")
    L, _names = _parse_copy_number(copy_number_data, G)
    if saturate:
        L = np.minimum(L, float(saturation_threshold))
    if latent not in ("auto", "ignore", "refine"):
        raise ValueError(f"latent must be 'auto', 'ignore', or 'refine', got {latent!r}")
    W = fit.ml_params.get("W")
    K = 0 if W is None else np.asarray(W).shape[1]
    if latent == "refine" and K != 1:
        raise ValueError(
            f"latent='refine' requires a K=1 fit (this fit has K={K}); "
            "use latent='ignore'"
        )
    refine = (latent == "refine") or (latent == "auto" and K == 1)

    # Integer dense counts cannot be NaN or fractional: only their sign is
    # checked on the host (the transfer type reads it anyway), and cells
    # without counts are found in the totals on the device.
    int_dense = not sparse and np.issubdtype(Y_new.dtype, np.integer)
    if int_dense:
        if Y_new.size and Y_new.min() < 0:
            raise ValueError("gene_expression_data must be non-negative raw counts")
    else:
        _validate_counts(Y_new)
    rows = _DeviceRows(_RowSource(Y_new, None), _transfer_storage(
        Y_new.data if sparse else Y_new), dev)

    like = dict(dtype=torch.float32, device=dev)
    mu = torch.as_tensor(np.asarray(fit.ml_params["mu"]), **like)
    alpha = np.asarray(fit.ml_params["alpha"], np.float64)
    log_alpha = torch.as_tensor(np.log(alpha / alpha.sum()), **like)
    Ld = torch.as_tensor(L, **like)
    Wd = torch.as_tensor(np.asarray(W), **like) if refine else None
    parts = [_posterior_parts(rows[i:j], Ld, mu, log_alpha, Wd)
             for i, j in mm._row_blocks(*Y_new.shape)]
    lp, yW, t = (None if p[0] is None else torch.cat(p) for p in zip(*parts))
    if int_dense and bool(torch.any(t == 0)):
        raise ValueError("Some cells have no counts mapping")  # R/inference-tflow.R:212-214
    if refine:
        lp = _refine(lp, yW, t, Ld, mu, Wd, newton_iters)
    return lp

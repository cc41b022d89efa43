"""The clonealign probabilistic model as functions on tensors (counterpart of
``clonealign_tpu/models/multinomial.py``).

The multinomial log-likelihood of cell n under clone c and mu sample s is
decomposed so that no (S, C, N, G) tensor exists:

    log p(y_n | c) = log_binom[n] + A2[n,s] + A1[n] + YlogL[n,c] - t_n log Z[s,c,n]

with ``A1[n] = sum_g y_ng (psi W^T)[n,g]``, ``A2[n,s] = sum_g y_ng log mu[s,g]``
and ``Z[s,c,n] = sum_g mu[s,g] L[g,c] exp(psi W^T)[n,g]``. A1, A2 and Z are
the contract of the fused-likelihood op (``ops/fused_likelihood.py``): on
CUDA tensors its hand-written kernels, on CPU tensors its plain versions.

This slice covers the default corner of the reference: no covariates
(P = 0), a dense count matrix and the exact normalizer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fused_likelihood import fused_likelihood_terms
from ..utils.device import full_fp32_matmul
from ..utils.sparsity import is_scipy_sparse

LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Numerics helpers (reference R/inference-tflow.R:2-15)
# ---------------------------------------------------------------------------

def softplus(x):
    """log(1 + exp(x)), exact for every x (``torch.nn.functional.softplus``
    switches to the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def safe_inverse_softplus(x):
    """log(exp(x)-1) computed stably for positive x
    (reference R/inference-tflow.R:6-11)."""
    return torch.log(-torch.expm1(-torch.abs(x))) + torch.clamp_min(x, 0.0)


def _normal_log_prob(x, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return -0.5 * z * z - log_scale - 0.5 * LOG_2PI


# ---------------------------------------------------------------------------
# Parameters, data, configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CloneAlignParams:
    """Free variables optimized jointly by Adam
    (reference R/inference-tflow.R:240-273)."""

    W: torch.Tensor              # (G, K) gene loadings, init 0
    chi_unconstr: torch.Tensor   # (K,) prior precision of W (chi = exp), init 0
    psi: torch.Tensor            # (N, K) cell latent factors, init PCA
    alpha_unconstr: torch.Tensor  # (C,) clone mixing logits, init 0
    qmu_loc: torch.Tensor        # (G,) variational loc of inv-softplus(mu)
    qmu_log_scale: torch.Tensor  # (G,) log scale, init log(1)=0
    gamma_logits: torch.Tensor   # (N, C) variational clone responsibilities

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def replace(self, **changes) -> "CloneAlignParams":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class ModelData:
    """Per-fit tensors, computed once and kept on the device."""

    Y: torch.Tensor          # (N, G) counts in the compute dtype
    L: torch.Tensor          # (G, C) copy numbers (saturated)
    s: torch.Tensor          # (N,) per-cell totals (multinomial total_count)
    log_binom: torch.Tensor  # (N,) lgamma(s+1) - sum_g lgamma(y+1)
    YlogL: torch.Tensor      # (N, C) sum_g xlogy(y_ng, L_gc)
    colsum_Y: torch.Tensor   # (G,) per-gene count totals (see elbo())


class ModelConfig(NamedTuple):
    K: int = 1
    mc_samples: int = 1
    fix_alpha: bool = False


# ---------------------------------------------------------------------------
# Data preparation
# ---------------------------------------------------------------------------

def _prepare_data_core(Y, L):
    """Data statistics in the compute dtype, float32 products without TF32
    (the YlogL constant feeds every ELBO evaluation)."""
    s = torch.sum(Y, dim=1)
    log_binom = torch.lgamma(s + 1.0) - torch.sum(torch.lgamma(Y + 1.0), dim=1)
    log_L_safe = torch.where(L > 0, torch.log(torch.where(L > 0, L, 1.0)), 0.0)
    with full_fp32_matmul():
        B = Y @ log_L_safe
        hits_zero = (Y @ (L <= 0).to(Y.dtype)) > 0
    B = torch.where(hits_zero, -math.inf, B)
    return s, log_binom, B, torch.sum(Y, dim=0)


def prepare_data(Y, L, *, device, dtype=torch.float32) -> ModelData:
    """Move a dense count matrix to ``device`` in ``dtype`` and compute its
    statistics there.

    ``YlogL`` uses xlogy semantics: a gene with zero copy number in clone c
    contributes -inf to that clone's log-likelihood only for cells
    expressing it. Y is uploaded in its host dtype (an int16 matrix moves
    half the bytes of float32) and converted on the device.
    """
    if is_scipy_sparse(Y):
        raise NotImplementedError(
            "sparse count matrices are not ported yet (ROADMAP.md, still to port: "
            "chunked and sparse prepare); pass a dense array"
        )
    Yt = torch.from_numpy(np.ascontiguousarray(Y)) if isinstance(Y, np.ndarray) else torch.as_tensor(Y)
    Yd = Yt.to(device=device).to(dtype)
    if Yd.numel() and float(Yd.min()) < 0:
        raise ValueError("gene_expression_data must be non-negative raw counts")
    Ld = torch.as_tensor(np.asarray(L), dtype=dtype, device=device)
    s, log_binom, B, colsum = _prepare_data_core(Yd, Ld)
    _check_cells_feasible(B)
    return ModelData(Y=Yd, L=Ld, s=s, log_binom=log_binom, YlogL=B, colsum_Y=colsum)


def _check_cells_feasible(B):
    """Every cell needs >= 1 clone with finite YlogL. A cell with nonzero
    counts at a zero-copy-number gene in EVERY clone has zero likelihood
    under the whole model; it is a typed input error instead of a NaN fit."""
    bad = ~torch.any(torch.isfinite(B), dim=1)
    n_bad = int(bad.sum())
    if n_bad:
        first = int(torch.argmax(bad.to(torch.int8)))
        raise ValueError(
            f"{n_bad} cell(s) have nonzero counts at genes whose copy "
            f"number is 0 in every clone (first: cell {first}) — no clone "
            "can explain them. Remove these cells, or fix the copy-number "
            "matrix (genes with copy number 0 across all clones are "
            "removed by preprocess_for_clonealign)."
        )


# ---------------------------------------------------------------------------
# Initialization (reference R/inference-tflow.R:204-273)
# ---------------------------------------------------------------------------

def _standardize(x, dim=0, ddof=1):
    mu = torch.mean(x, dim=dim, keepdim=True)
    sd = torch.std(x, dim=dim, keepdim=True, correction=ddof)
    return (x - mu) / torch.where(sd == 0, 1.0, sd)


def randomized_pca(X, k: int, noise, oversample: int = 8, power_iters: int = 4):
    """Top-k PCA scores of the column-standardized X via randomized subspace
    iteration; the Gaussian test matrix is ``noise``'s ``"pca_omega"`` draw.
    Signs of the scores are arbitrary, as with any SVD."""
    n, g = X.shape
    k_eff = min(k + oversample, min(n, g))
    Xc = _standardize(X, dim=0)
    omega = noise.normal("pca_omega", (g, k_eff), X.dtype, X.device)
    with full_fp32_matmul():
        Q = Xc @ omega
        for _ in range(power_iters):
            Q, _ = torch.linalg.qr(Q)
            Q, _ = torch.linalg.qr(Xc @ (Xc.T @ Q))
        B = Q.T @ Xc  # (k_eff, g)
        _, _, Vt = torch.linalg.svd(B, full_matrices=False)
        return Xc @ Vt[:k].T  # (n, k)


def pca_init_scores(Y, K: int, noise, dtype=torch.float32):
    """Standardized top-K PCA scores of log2(Y+1)
    (reference R/inference-tflow.R:204-207), before the jitter. A restart
    sweep computes them once and shares them across lanes."""
    N = Y.shape[0]
    if K <= 0:
        return torch.zeros(N, 0, dtype=dtype, device=Y.device)
    pcs = randomized_pca(torch.log2(Y.to(dtype) + 1.0), K, noise)
    return _standardize(pcs, dim=0)


def data_mu_guess(Y, dtype=torch.float32):
    """colMeans(Y / rowMeans(Y)) — the data-driven mu initialization
    (reference R/inference-tflow.R:220-231)."""
    Y = Y.to(dtype)
    return torch.mean(Y / torch.mean(Y, dim=1, keepdim=True), dim=0)


def init_params(
    Y,
    L,
    noise,
    K: int = 1,
    data_init_mu=True,
    dtype=torch.float32,
    pca_scores=None,
    mu_guess=None,
) -> CloneAlignParams:
    """Initial parameter values (reference R/inference-tflow.R:204-273).

    - psi: PCA of log2(Y+1), re-standardized, + N(0, 0.05) jitter
    - qmu_loc: inv-softplus of colMeans(Y / rowMeans(Y)) (or ones, or the
      given array divided by its mean)
    - everything else zeros

    ``pca_scores`` / ``mu_guess`` take precomputed outputs of
    :func:`pca_init_scores` / :func:`data_mu_guess` (shared across restarts).
    """
    N, G = Y.shape
    C = L.shape[1]
    dev = Y.device

    if K > 0:
        pcs = pca_scores if pca_scores is not None else pca_init_scores(Y, K, noise, dtype)
        pcs = pcs.to(dtype) + 0.05 * noise.normal("psi_jitter", pcs.shape, dtype, dev)
    else:
        pcs = torch.zeros(N, 0, dtype=dtype, device=dev)

    if mu_guess is not None:
        mu_guess = torch.as_tensor(mu_guess, dtype=dtype, device=dev)
    elif isinstance(data_init_mu, (bool, np.bool_)):
        mu_guess = data_mu_guess(Y, dtype) if data_init_mu else torch.ones(G, dtype=dtype, device=dev)
    else:
        mu_guess = torch.as_tensor(data_init_mu, dtype=dtype, device=dev)
        mu_guess = mu_guess / torch.mean(mu_guess)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    return CloneAlignParams(
        W=zeros(G, max(K, 0)),
        chi_unconstr=zeros(max(K, 0)),
        psi=pcs,
        alpha_unconstr=zeros(C),
        qmu_loc=safe_inverse_softplus(mu_guess),
        qmu_log_scale=zeros(G),
        gamma_logits=zeros(N, C),
    )


# ---------------------------------------------------------------------------
# Likelihood + ELBO
# ---------------------------------------------------------------------------

def sample_mu_base(params: CloneAlignParams, eps):
    """Reparametrized base-normal draws from the (S, G) standard normals
    ``eps``; mu = softplus(base) (reference R/inference-tflow.R:258-269)."""
    return params.qmu_loc[None, :] + torch.exp(params.qmu_log_scale)[None, :] * eps


def _likelihood_terms(params, data, mu_samples, log_mu):
    """A1 (N,), A2 (N, S) or None, and log Z as (S, C, N), through the
    fused-likelihood op."""
    S, G = mu_samples.shape
    N, C = data.Y.shape[0], data.L.shape[1]
    muL = (mu_samples[:, :, None] * data.L[None, :, :]).permute(1, 0, 2).reshape(G, S * C)
    A1, A2, Z = fused_likelihood_terms(data.Y, params.psi, params.W, log_mu, muL)
    logZ = torch.log(Z).reshape(N, S, C).permute(1, 2, 0)
    return A1, A2, logZ


def log_p_y_on_c(params: CloneAlignParams, data: ModelData, mu_base):
    """(S, C, N) expression log-likelihood, decomposed form (module docstring)."""
    mu_samples = softplus(mu_base)
    log_mu = torch.log(mu_samples)
    A1, A2, logZ = _likelihood_terms(params, data, mu_samples, log_mu)
    return (
        data.log_binom[None, None, :]
        + A1[None, None, :]
        + A2.T[:, None, :]
        + data.YlogL.T[None, :, :]
        - data.s[None, None, :] * logZ
    )


def elbo(params: CloneAlignParams, data: ModelData, eps, config: ModelConfig):
    """The evidence lower bound (reference R/inference-tflow.R:298-336) at the
    mu sample made from the (S, G) standard normals ``eps``.

    Reproduces the reference's objective with its quirks: the mu prior is
    Normal(0,1) on log(mu) without a Jacobian, and the Dirichlet prior is
    evaluated at softmax(alpha)+1e-3, off the simplex.

    Constant-cotangent decomposition: the likelihood terms that are the same
    for every clone — log_binom, A1, A2 — leave the responsibility
    contraction, because softmax rows sum to 1 and a per-cell constant
    shift is annihilated by the softmax Jacobian. So A2 enters as
    ``dot(colsum_Y, sum_s log_mu) / S`` (Y is not read for it) and A1 as
    its sum; only YlogL and the normalizer Z stay inside the contraction.
    """
    S = config.mc_samples
    mu_base = sample_mu_base(params, eps)
    mu_samples = softplus(mu_base)
    log_mu = torch.log(mu_samples)

    A1, _, logZ = _likelihood_terms(params, data, mu_samples, None)
    A2_sum = torch.dot(data.colsum_Y, torch.sum(log_mu, dim=0)) / S
    const_sum = torch.sum(data.log_binom) + torch.sum(A1) + A2_sum

    clone_ll = data.YlogL.T[None, :, :] - data.s[None, None, :] * logZ  # (S, C, N)
    gamma = torch.softmax(params.gamma_logits, dim=1)
    log_gamma = torch.log_softmax(params.gamma_logits, dim=1)

    E_clone_ll = torch.mean(clone_ll, dim=0)  # (C, N)
    # xlogy-style guard: a clone with zero copy number at an expressed gene
    # has log-lik -inf and responsibility exactly 0; 0 * -inf must give 0.
    # The -inf is masked before the multiply so the backward pass never
    # sees 0 * inf either.
    safe_ll = torch.where(gamma == 0, 0.0, E_clone_ll.T)
    EE_p_y = torch.sum(gamma * safe_ll) + const_sum

    if config.fix_alpha:
        log_alpha = torch.log_softmax(torch.zeros_like(params.alpha_unconstr), dim=0)
    else:
        log_alpha = torch.log_softmax(params.alpha_unconstr, dim=0)

    C = log_alpha.shape[0]
    dir_conc = 1.0 / C
    dir_x = torch.exp(log_alpha) + 1e-3
    dirichlet_lp = torch.sum((dir_conc - 1.0) * torch.log(dir_x)) - C * math.lgamma(dir_conc)
    E_log_p_p = (
        torch.sum(log_alpha[None, :] * gamma)
        + torch.sum(_normal_log_prob(log_mu)) / S
        + dirichlet_lp
    )

    if config.K > 0:
        chi = torch.exp(params.chi_unconstr)
        w_scale = torch.sqrt(1.0 / chi)
        W_lp = torch.sum(_normal_log_prob(params.W, 0.0, w_scale[None, :]))
        chi_lp = torch.sum(torch.log(chi) - chi)  # Gamma(2, 1)
        psi_lp = torch.sum(_normal_log_prob(params.psi))
        E_log_p_p = E_log_p_p + W_lp + chi_lp + psi_lp

    # E_q[log q]: the qmu log-prob changes variables through the softplus
    # bijector, log q(mu) = N(y; loc, scale) - log sigmoid(y).
    scale = torch.exp(params.qmu_log_scale)
    qmu_lp = _normal_log_prob(mu_base, params.qmu_loc[None, :], scale[None, :])
    qmu_lp = qmu_lp - torch.nn.functional.logsigmoid(mu_base)
    gamma_entropy_term = torch.sum(torch.where(gamma == 0, 0.0, gamma * log_gamma))
    E_log_q = torch.sum(torch.mean(qmu_lp, dim=0)) + gamma_entropy_term

    return EE_p_y + E_log_p_p - E_log_q


def gamma_warm_start_logits(
    params: CloneAlignParams,
    data: ModelData,
    eps,
    initial_shrink: float = 5.0,
):
    """Likelihood-based responsibility warm start
    (reference R/inference-tflow.R:338-342,367-369), at the mu sample made
    from the (S, G) standard normals ``eps``. Logits are scaled by
    ``initial_shrink``/5: 0 = uniform, 5 = the reference's behaviour,
    10 = sharper."""
    p_y = log_p_y_on_c(params, data, sample_mu_base(params, eps))  # (S, C, N)
    # SUM over MC samples, as the reference's tf$reduce_sum(p_y_on_c, axis=0)
    g = torch.sum(p_y, dim=0)  # (C, N)
    impossible = torch.isneginf(g)  # zero-CN clone at an expressed gene
    g = g - torch.logsumexp(g, dim=0, keepdim=True)
    logits = (initial_shrink / 5.0) * torch.clamp_min(g, -1e30)
    # impossible clones stay impossible at any shrink: their logit is pinned
    # at a finite value whose softmax underflows to exactly 0
    logits = torch.where(impossible, -1e30, logits)
    return logits.T  # (N, C)

"""Legacy v1 model family: the negative-binomial dosage mixture
(counterpart of ``clonealign_tpu/models/negbin.py``).

clonealign v1 assigned cells to clones under a negative-binomial likelihood
with a per-gene dosage indicator rho_g deciding whether gene g's expression
follows the clone copy-number profile:

    y_ng ~ NB(mean = s_n * ((1 - rho_g) mu_g + rho_g beta_g Lp[g, pi_n]),
              size = phi_g)

It is fitted by structured mean-field variational EM, q(pi, rho) =
prod_n q(pi_n) prod_g q(rho_g): closed-form CAVI updates of gamma = q(pi)
and r = q(rho), a closed-form clone prior alpha, and ``m_steps`` Adam steps
on (log mu, log beta, log phi) for all genes at once, with the reference
script's ``lambda`` penalty tying mu to beta * l_hat (reference
inst/create_model3_synthetic.R:62-105). Besides: a Gibbs sampler over (pi,
rho) (:func:`gibbs_pi_rho`), serving of new cells (:func:`classify_cells`)
and a fit object saved as ``.npz`` (:class:`ClonealignV1Fit`), in the JAX
package's format.

The design on the card. The JAX package fuses each clone's (N, G) term D_c
and its reductions into one pass over Y. Eager PyTorch makes every
intermediate an (N, G) tensor, so every pass over Y here — the clone scan of
the E-step and of serving, the M-step's value and gradient, the monitored
ELBO, the initialization and the Chebyshev statistics — runs over row blocks
of at most ``_BLOCK_ELEMENTS`` elements (64 MB at float32), one clone at a
time: no (N, G, C) tensor is made, and the M-step's autograd graph lives for
one block. Its gradients are taken with respect to the (G,)-sized rates of
the block's terms (phi, mu, log mu, beta Lp, q), accumulated over the
blocks, and carried back to (log mu, log beta, log phi) once. The monitored
ELBO and the E-step's B scan that feeds it evaluate their elements in
float64 (:func:`_elbo_with_B`): in float32 the ELBO's own rounding sits
near the stopping rule's ``rel_tol``.

The Chebyshev path (``stats`` from :func:`negbin_cheb_stats`) reads Y twice
an iteration, in two thin products that run in full float32
(``utils/device.full_fp32_matmul``: TF32 would cost clone accuracy, as
bfloat16 did in the JAX package), and its M-step touches no cell-indexed
tensor.

Every function keeps the JAX package's expressions and term order: the
clone difference D_c and the llk0 sums are assembled element by element
before any reduction, so that their float32 values and gradients net at
the scale of the residuals (see :func:`_accumulate`).

On a mesh (``NegbinData.cells``, ``parallel/sharding.sharded_negbin_fit``)
the data holds one rank's rows: every sum over cells (the constants, B, the
llk0 sums, the M-step's value and gradients, the moments, the clone prior,
the Chebyshev statistics and the ELBO's cell terms) is all-reduced, and the
cell count N is every rank's; A and gamma stay on their cell block. With a
genes axis (``NegbinData.genes``) the data holds its gene block's columns
of those rows, and the per-gene rates, r and B are the block's: the sums
over genes (the E-step's A, the constants, the llk0 sums, the M-step's
value, the ELBO's per-gene terms, Lp's column means) are all-reduced over
the genes group (clonealign_tpu/parallel/sharding.py:132-145).
"""

from __future__ import annotations

import math
import string
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..infer import Monitor, OptaxAdam, OptaxAdamState
from ..parallel.collectives import Cells, Genes, all_max, all_sum, sum_over_genes, world_max
from ..utils.device import full_fp32_matmul, resolve_device, resolve_dtype, synchronize
from ..utils.sparsity import is_scipy_sparse
from . import multinomial as mm

# Every pass over Y takes row blocks of at most this many elements: 64 MB a
# float32 temporary, about a dozen of them in the M-step's graph of one block.
_BLOCK_ELEMENTS = 1 << 24


class NegbinData(NamedTuple):
    Y: torch.Tensor       # (N, G) counts, in the compute dtype
    Lp: torch.Tensor      # (G, C) per-clone mean-normalized copy number
    s: torch.Tensor       # (N,) size factors
    l_hat: torch.Tensor   # (G,) rowMeans(Lp), the script's l_g_hat
    cells: Optional[Cells] = None  # on a mesh, which block of the cells Y and s hold
    genes: Optional[Genes] = None  # with a genes axis, which block of the genes Y, Lp hold


class NegbinParams(NamedTuple):
    log_mu: torch.Tensor        # (G,)
    log_beta: torch.Tensor      # (G,)
    log_phi: torch.Tensor       # (G,)
    alpha_logits: torch.Tensor  # (C,) clone prior (closed-form M-step)


class NegbinPosterior(NamedTuple):
    gamma: torch.Tensor   # (N, C) q(pi_n = c)
    r: torch.Tensor       # (G,)   q(rho_g = 1)


def nb_log_prob(y, mean, phi):
    """Negative-binomial log-pmf in (mean, size) parametrization, the form
    R's ``rnbinom(mu=, size=)`` draws from (reference
    inst/create_model3_synthetic.R:27)."""
    log_mp = torch.log(phi + mean)
    return (
        torch.lgamma(y + phi) - torch.lgamma(phi) - torch.lgamma(y + 1.0)
        + phi * (torch.log(phi) - log_mp)
        + y * (torch.log(mean) - log_mp)
    )


def _llk0(params: NegbinParams, data: NegbinData):
    """(N, G) log NB(y | s_n mu_g, phi_g), the rho=0 branch (no clone
    dependence). Whole-matrix: for small inputs and tests."""
    mu = torch.exp(params.log_mu)
    phi = torch.exp(params.log_phi)
    return nb_log_prob(data.Y, data.s[:, None] * mu[None, :], phi[None, :])


def _n_cells(data: NegbinData) -> int:
    """The fit's cell count: every rank's on a mesh."""
    return data.Y.shape[0] if data.cells is None else data.cells.n


def _all_cells_genes(x, data: NegbinData):
    """``x``, this rank's sum over its tile, summed over every tile."""
    return all_sum(all_sum(x, data.cells), data.genes)


def _gene_sum(x, data: NegbinData):
    """``x``, a sum over this rank's genes (in a graph: the identity
    backward), summed over every gene block."""
    return sum_over_genes(x, data.genes)


def _blocks(N: int, G: int):
    """(start, stop) of each row block of a pass over an (N, G) matrix."""
    rows = max(1, _BLOCK_ELEMENTS // max(G, 1))
    return [(i, min(i + rows, N)) for i in range(0, N, rows)]


class _NBConsts(NamedTuple):
    """Parameter-independent reductions of Y, computed once per fit."""
    lgamma_y1_sum: torch.Tensor   # sum_ng lgamma(y + 1)


def _nb_constants(data: NegbinData) -> _NBConsts:
    total = torch.zeros((), dtype=torch.float64, device=data.Y.device)
    with torch.no_grad():
        for i, j in _blocks(*data.Y.shape):
            total += torch.lgamma(data.Y[i:j] + 1.0).sum(dtype=torch.float64)
    return _NBConsts(lgamma_y1_sum=_all_cells_genes(total, data).to(data.Y.dtype))


# --- the exact clone scan ----------------------------------------------------

class _ScanRates(NamedTuple):
    """The (G,)-sized factors of the clone scan's per-element terms."""
    phi: torch.Tensor      # (G,)
    mu: torch.Tensor       # (G,)
    log_mu: torch.Tensor   # (G,)
    k1: torch.Tensor       # (G, C) beta_g Lp[g, c]
    q: torch.Tensor        # (G, C) log(beta_g Lp[g, c]) - log mu_g


def _scan_rates(log_mu, log_beta, log_phi, Lp) -> _ScanRates:
    return _ScanRates(
        phi=torch.exp(log_phi), mu=torch.exp(log_mu), log_mu=log_mu.clone(),
        k1=torch.exp(log_beta)[:, None] * Lp,
        q=log_beta[:, None] + torch.log(Lp) - log_mu[:, None],
    )


def _block_base(Yb, sb, rates: _ScanRates):
    """Yp = y + phi and log(phi + m0), m0 = s mu, on a block of rows."""
    m0 = sb[:, None] * rates.mu[None, :]
    return Yb + rates.phi[None, :], torch.log(rates.phi[None, :] + m0)


def _clone_diff(Yb, sb, Yp, log_pm0, rates: _ScanRates, c: int):
    """D_c = llk1_c - llk0 on a block of rows (see :func:`_accumulate`)."""
    log_pm1 = torch.log(rates.phi[None, :] + sb[:, None] * rates.k1[:, c][None, :])
    return Yp * (log_pm0 - log_pm1) + Yb * rates.q[:, c][None, :]


def _scan(params: NegbinParams, data: NegbinData, gene_w=None, cell_w=None, dtype=None):
    """The clone scan over row blocks: A (N, C) when ``gene_w`` is given, B
    (G,) when ``cell_w`` is given (None for the one not asked for), each
    element's terms evaluated in ``dtype`` (by default Y's). On a mesh A is
    this rank's rows, every gene block's sum, and B (its gene block's)
    every cell block's sum."""
    N, G = data.Y.shape
    C = data.Lp.shape[1]
    dt = data.Y.dtype if dtype is None else dtype
    A = None if gene_w is None else torch.empty((N, C), dtype=dt, device=data.Y.device)
    B = None if cell_w is None else torch.zeros(G, dtype=dt, device=data.Y.device)
    gene_w = None if gene_w is None else gene_w.to(dt)
    cell_w = None if cell_w is None else cell_w.to(dt)
    with torch.no_grad(), full_fp32_matmul():
        rates = _scan_rates(params.log_mu.to(dt), params.log_beta.to(dt), params.log_phi.to(dt),
                            data.Lp.to(dt))
        s = data.s.to(dt)
        for i, j in _blocks(N, G):
            Yb, sb = data.Y[i:j].to(dt), s[i:j]
            Yp, log_pm0 = _block_base(Yb, sb, rates)
            for c in range(C):
                D_c = _clone_diff(Yb, sb, Yp, log_pm0, rates, c)
                if A is not None:
                    A[i:j, c] = D_c @ gene_w
                if B is not None:
                    B += cell_w[i:j, c] @ D_c
    return (None if A is None else all_sum(A, data.genes),
            None if B is None else all_sum(B, data.cells))


def _accumulate(params: NegbinParams, data: NegbinData, gene_w, cell_w):
    """Both E-step accumulators without an (N, G, C) intermediate:

      A[n, c] = sum_g gene_w[g] * D_c[n, g]    (gamma update, gene_w = r)
      B[g]    = sum_c cell_w[n, c]-weighted column sums of D_c
                                               (r update, cell_w = gamma)

    with D_c = llk1_c - llk0. Every lgamma of the two NB log-pmfs cancels in
    that difference, leaving

      D_c = (y + phi) * log((phi + m0) / (phi + m1_c)) + y * q_c,
      q_c[g] = log(beta_g Lp[g,c]) - log mu_g          (cell-independent),

    one log per element per clone. D_c is assembled element by element
    (q_c broadcast into the expression, not hoisted into a separate Y @
    (w*q) product): near the optimum its two parts cancel to small
    residuals per element, and netting inside the expression keeps the
    float32 values and gradients at the residuals' scale."""
    return _scan(params, data, gene_w=gene_w, cell_w=cell_w)


def _accumulate_A(params: NegbinParams, data: NegbinData, gene_w):
    """The A accumulator alone (serving: no r update, so no B pass)."""
    return _scan(params, data, gene_w=gene_w)[0]


def _llk0_core(Yb, log_sb, Yp, log_pm0, log_mu):
    """The per-element part of :func:`_llk0_sum`: lgamma(y + phi) - (y +
    phi) log(phi + m0) + y log m0, with log m0 = log s + log mu by a
    broadcast add."""
    return (torch.lgamma(Yp) - Yp * log_pm0
            + Yb * (log_sb[:, None] + log_mu[None, :]))


def _llk0_globals(log_phi, phi, N, consts: _NBConsts, data: NegbinData):
    neg, pos = _gene_sum(torch.stack([torch.sum(torch.lgamma(phi)), torch.sum(phi * log_phi)]),
                         data).unbind()
    return -N * neg - consts.lgamma_y1_sum + N * pos


def _llk0_sum(params: NegbinParams, data: NegbinData, consts: _NBConsts):
    """sum_ng log NB(y | s_n mu_g, phi_g) with the y-independent lgammas
    reduced out: lgamma(phi) is a per-gene sum and lgamma(y+1) a
    precomputed constant, so one lgamma, lgamma(y+phi), which the phi
    gradient needs, is left per element. The y log m0 term stays element
    by element, so the log mu cotangent nets y - (y+phi) m0/(phi+m0) per
    element. The M-step's cheap form; the monitored ELBO uses
    :func:`_llk0_netted_sum`."""
    N, G = data.Y.shape
    total = torch.zeros((), dtype=data.Y.dtype, device=data.Y.device)
    with torch.no_grad():
        rates = _scan_rates(params.log_mu, params.log_beta, params.log_phi, data.Lp)
        log_s = torch.log(data.s)
        for i, j in _blocks(N, G):
            Yp, log_pm0 = _block_base(data.Y[i:j], data.s[i:j], rates)
            total += torch.sum(_llk0_core(data.Y[i:j], log_s[i:j], Yp, log_pm0, rates.log_mu))
        return (_all_cells_genes(total, data)
                + _llk0_globals(params.log_phi, rates.phi, _n_cells(data), consts, data))


def _llk0_netted_sum(params: NegbinParams, data: NegbinData):
    """sum_ng log NB(y | s_n mu_g, phi_g) with every term netted inside one
    elementwise expression before the reduction: two lgammas per element
    more than :func:`_llk0_sum`, but its value noise is at the elements'
    scale, where _llk0_sum's is that of separately reduced pieces of ~1e9.
    The form of the monitored ELBO, evaluated element by element in
    float64 (see :func:`_elbo_with_B`); the result is float64."""
    N, G = data.Y.shape
    f64 = torch.float64
    total = torch.zeros((), dtype=f64, device=data.Y.device)
    with torch.no_grad():
        log_phi, log_mu = params.log_phi.to(f64), params.log_mu.to(f64)
        phi = torch.exp(log_phi)[None, :]
        mu = torch.exp(log_mu)[None, :]
        lgamma_phi = torch.lgamma(phi)
        phi_log_phi = phi * log_phi[None, :]
        s = data.s.to(f64)
        log_s = torch.log(s)
        for i, j in _blocks(N, G):
            Yb, sb = data.Y[i:j].to(f64), s[i:j]
            m0 = sb[:, None] * mu
            log_m0 = log_s[i:j, None] + log_mu[None, :]
            Yp = Yb + phi
            core = (
                torch.lgamma(Yp) - lgamma_phi - torch.lgamma(Yb + 1.0)
                + phi_log_phi
                - Yp * torch.log(phi + m0)
                + Yb * log_m0
            )
            total += core.sum()
    return _all_cells_genes(total, data)


def _penalty(log_mu, log_beta, l_hat, lam, data: NegbinData):
    return _gene_sum(lam * torch.sum((torch.exp(log_mu) - torch.exp(log_beta) * l_hat) ** 2),
                     data)


def _r_dot(r, B, data: NegbinData):
    """sum_g r_g B_g over every gene block."""
    return _gene_sum(r @ B, data)


def _mstep_value_and_grad(rates3, data: NegbinData, post: NegbinPosterior, lam,
                          consts: _NBConsts):
    """The M-step objective (:func:`_mstep_objective`) at the rates
    ``(log_mu, log_beta, log_phi)`` and its gradient with respect to them.

    The graph is built one row block at a time: each block's terms are a
    function of the (G,)-sized factors of :class:`_ScanRates`, whose
    gradients are summed over the blocks and carried back to the rates in
    one backward pass through the small graph that made them. Only B enters
    the objective, so no A product is formed."""
    N, G = data.Y.shape
    C = data.Lp.shape[1]
    lmu, lbeta, lphi = (t.detach().requires_grad_(True) for t in rates3)
    with torch.enable_grad(), full_fp32_matmul():
        rates = _scan_rates(lmu, lbeta, lphi, data.Lp)
        leaves = _ScanRates(*(t.detach().requires_grad_(True) for t in rates))
        grads = [torch.zeros_like(t) for t in leaves]
        total = torch.zeros((), dtype=data.Y.dtype, device=data.Y.device)
        log_s = torch.log(data.s)
        for i, j in _blocks(N, G):
            Yb, sb = data.Y[i:j], data.s[i:j]
            Yp, log_pm0 = _block_base(Yb, sb, leaves)
            value = torch.sum(_llk0_core(Yb, log_s[i:j], Yp, log_pm0, leaves.log_mu))
            B = 0.0
            for c in range(C):
                B = B + post.gamma[i:j, c] @ _clone_diff(Yb, sb, Yp, log_pm0, leaves, c)
            value = value + post.r @ B
            for acc, g in zip(grads, torch.autograd.grad(value, leaves)):
                acc += g
            total += value.detach()
        if data.cells is not None:  # every rank's blocks, in one all_reduce
            flat = all_sum(torch.cat([g.reshape(-1) for g in grads] + [total.reshape(1)]),
                           data.cells)
            *grads, total = [p.view_as(t) for p, t in zip(
                flat.split([g.numel() for g in grads] + [1]), grads + [total])]
        total = all_sum(total, data.genes)
        small = (_llk0_globals(lphi, rates.phi, _n_cells(data), consts, data)
                 - _penalty(lmu, lbeta, data.l_hat, lam, data))
        d = torch.autograd.grad([*rates, small], [lmu, lbeta, lphi],
                                grad_outputs=[*grads, torch.ones_like(small)])
    return (total + small).detach(), d


def _expected_llk(params: NegbinParams, data: NegbinData, post: NegbinPosterior,
                  consts: Optional[_NBConsts] = None):
    """E_q[log p(Y | pi, rho, params)], the M-step objective's data term:
    sum_ng llk0_ng + sum_g r_g B_g, B from the gamma-weighted scan."""
    if consts is None:
        consts = _nb_constants(data)
    _, B = _scan(params, data, cell_w=post.gamma)
    return _llk0_sum(params, data, consts) + _r_dot(post.r, B, data)


def _mstep_objective(params: NegbinParams, data: NegbinData, post: NegbinPosterior, lam,
                     consts: Optional[_NBConsts] = None):
    """Penalized expected log-likelihood (per-gene L-BFGS analog,
    reference inst/create_model3_synthetic.R:62-75)."""
    if consts is None:
        consts = _nb_constants(data)
    rates3 = (params.log_mu, params.log_beta, params.log_phi)
    return _mstep_value_and_grad(rates3, data, post, lam, consts)[0]


def _elbo(params: NegbinParams, data: NegbinData, post: NegbinPosterior, lam, rho_prior):
    """Mean-field ELBO: E[log p(Y, pi, rho)] + H(q) - penalty. The loop's
    convergence monitor (the v1 script's ``rel_tol``)."""
    _, B = _scan(params, data, cell_w=post.gamma, dtype=torch.float64)
    return _elbo_with_B(params, data, post, B, lam, rho_prior)


def _elbo_with_B(params: NegbinParams, data: NegbinData, post: NegbinPosterior, B, lam,
                 rho_prior):
    """The ELBO from a gamma-weighted B already in hand (the E-step has
    one), with the netted llk0 sum: the single assembly of monitored ELBO
    values, returned in the compute dtype.

    It is evaluated in float64, B too (the E-step's B scan runs in float64
    for it): in float32 the elements' own terms — lgamma(y + phi) and (y +
    phi) log(phi + m) of ~1e5 where counts reach 1e4 — carry ~0.03 of
    rounding each, enough that the JAX package's float32 fit misses its
    golden pin's 1e-5 bar at iteration 0 (tests/test_torch_negbin.py), and
    near the stopping rule's rel_tol at 10^8 elements."""
    f64 = torch.float64
    with torch.no_grad():
        p64 = NegbinParams(*(t.to(f64) for t in params))
        post64 = NegbinPosterior(*(t.to(f64) for t in post))
        rest = (_r_dot(post64.r, B.to(f64), data)
                - _penalty(p64.log_mu, p64.log_beta, data.l_hat.to(f64), lam, data)
                + _elbo_extras(p64, data, post64, rho_prior, data.cells))
        return (_llk0_netted_sum(params, data) + rest).to(data.Y.dtype)


def _elbo_extras(params: NegbinParams, data: NegbinData, post: NegbinPosterior, rho_prior,
                 cells: Optional[Cells] = None):
    """The ELBO minus the penalized expected log-likelihood: clone and
    dosage priors plus the mean-field entropies (no Y-sized work); on a
    mesh (``cells``) gamma's terms summed over every rank, r's over every
    gene block."""
    log_alpha = torch.log_softmax(params.alpha_logits, dim=0)
    gamma, r = post.gamma, post.r
    zero = torch.zeros((), dtype=gamma.dtype, device=gamma.device)
    h_gamma = -torch.sum(torch.where(gamma > 0, gamma * torch.log(torch.clamp(gamma, min=1e-30)),
                                     zero))
    prior_pi = torch.sum(gamma @ log_alpha)
    if cells is not None:
        h_gamma, prior_pi = all_sum(torch.stack([h_gamma, prior_pi]), cells).unbind()
    h_r = -torch.sum(
        torch.where(r > 0, r * torch.log(torch.clamp(r, min=1e-30)), zero)
        + torch.where(r < 1, (1 - r) * torch.log(torch.clamp(1 - r, min=1e-30)), zero)
    )
    prior_rho = torch.sum(r * math.log(rho_prior) + (1 - r) * math.log1p(-rho_prior))
    h_r, prior_rho = _gene_sum(torch.stack([h_r, prior_rho]), data).unbind()
    return prior_pi + prior_rho + h_gamma + h_r


# --- Chebyshev sufficient-statistics path -----------------------------------
#
# Every cell-indexed quantity of the VEM depends on cell n only through
# (y_ng, s_n): per gene (and clone) the log-likelihood pieces are smooth 1-D
# functions of t_n = log s_n times y_ng or 1. Expanding them in a degree-D
# Chebyshev series over [min t, max t] turns every cell sum into a
# contraction against sufficient statistics (clonealign_tpu/models/
# negbin.py:293-332): YT = Y^T T once a fit, YGT = Y^T (gamma x T) and GT =
# gamma^T T once an E-step, and for lgamma(y + phi) a per-gene value
# histogram of the integer counts below ``hist_cap`` plus a log-y expansion
# of the rare larger ones. The M-step then costs O(G (V + C D)) a step,
# independent of N, and an iteration reads Y twice.

class NegbinChebStats(NamedTuple):
    """Per-fit sufficient statistics for the Chebyshev M-step (independent
    of the parameters and the posterior; computed once)."""
    T: torch.Tensor         # (N, D+1) Chebyshev basis at the scaled log s
    YT: torch.Tensor        # (G, D+1) Y^T @ T; YT[:, 0] is colsum(Y)
    sumT: torch.Tensor      # (D+1,)   column sums of T
    hist: torch.Tensor      # (V0, G)  per-gene histogram of values < V0
    vals: torch.Tensor      # (V0,)    0..V0-1
    nodes_t: torch.Tensor   # (D+1,)   log size factors at the Chebyshev nodes
    theta: torch.Tensor     # (D+1,)   node angles (for the DCT transform)
    tailT: torch.Tensor     # (G, Dt+1) sum over {y >= V0} of T_d(scaled log y)
    tail_nodes_u: torch.Tensor  # (Dt+1,) log-count values at the tail nodes
    tail_theta: torch.Tensor    # (Dt+1,)


def _cheb_basis(x, degree: int):
    """(N, D+1) Chebyshev-Vandermonde columns by the T_j recurrence."""
    cols = [torch.ones_like(x), x]
    for _ in range(2, degree + 1):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    return torch.stack(cols[: degree + 1], dim=-1)


def _cheb_transform(fvals, theta):
    """Node values (..., D+1) -> Chebyshev coefficients (..., D+1), with the
    mean taken out before the transform so that the cancellation behind the
    small high-order coefficients happens on O(spread) values; the product
    in full precision for the same reason."""
    D1 = fvals.shape[-1]
    f0 = torch.mean(fvals, dim=-1, keepdim=True)
    jj = torch.arange(D1, dtype=fvals.dtype, device=fvals.device)
    M = torch.cos(jj[:, None] * theta[None, :])              # (D+1, D+1)
    with full_fp32_matmul():
        coef = (2.0 / D1) * torch.einsum("...k,jk->...j", fvals - f0, M)
    return torch.cat([coef[..., :1] * 0.5 + f0, coef[..., 1:]], dim=-1)


def _angles(degree: int, dtype, device):
    k = torch.arange(degree + 1, dtype=dtype, device=device)
    return math.pi * (k + 0.5) / (degree + 1)


def _cheb_stats_program(data: NegbinData, ymax: float, *, degree: int, n_vals: int,
                        tail_degree: int) -> NegbinChebStats:
    Y, dev, dt, cells = data.Y, data.Y.device, data.Y.dtype, data.cells
    N, G = Y.shape
    t = torch.log(data.s)
    t_min, t_max = torch.min(t), torch.max(t)
    if cells is not None:  # the range of every rank's size factors
        neg_min, t_max = all_max(torch.stack([-t_min, t_max]), cells).unbind()
        t_min = -neg_min
    mid = 0.5 * (t_min + t_max)
    half = torch.clamp(0.5 * (t_max - t_min), min=1e-6)
    T = _cheb_basis((t - mid) / half, degree)               # (N, D+1)
    with full_fp32_matmul():
        YT = all_sum(Y.T @ T, cells)

    # the tail range in u = log y over [log V0, log ymax] (the scaled
    # coordinate is clipped, so that ymax itself maps inside [-1, 1])
    u_lo = torch.log(torch.tensor(float(n_vals), dtype=dt, device=dev))
    u_hi = torch.clamp(torch.log(torch.tensor(max(ymax, float(n_vals)), dtype=dt, device=dev)),
                       min=u_lo + 1e-6)
    u_mid = 0.5 * (u_lo + u_hi)
    u_half = torch.clamp(0.5 * (u_hi - u_lo), min=1e-6)

    # one blocked pass over Y: the exact value histogram of y < V0 (values
    # >= V0 land in an extra row that is dropped), and where any count
    # reaches V0 the tail basis sums (else they are exactly zero)
    cols = torch.arange(G, device=dev)[None, :]
    hist = torch.zeros((n_vals + 1) * G, dtype=torch.int64, device=dev)
    tailT = torch.zeros((G, tail_degree + 1), dtype=dt, device=dev)
    has_tail = ymax >= n_vals
    for i, j in _blocks(N, G):
        Yb = Y[i:j]
        idx = torch.clamp(Yb, max=float(n_vals)).to(torch.int64) * G + cols
        hist += torch.bincount(idx.reshape(-1), minlength=(n_vals + 1) * G)
        del idx
        if has_tail:
            mask = (Yb >= float(n_vals)).to(dt)
            xu = torch.clamp((torch.log(torch.clamp(Yb, min=1.0)) - u_mid) / u_half, -1.0, 1.0)
            b_prev, b_cur = mask, mask * xu
            acc = [torch.sum(b_prev, dim=0), torch.sum(b_cur, dim=0)]
            for _ in range(2, tail_degree + 1):
                b_prev, b_cur = b_cur, 2.0 * xu * b_cur - b_prev
                acc.append(torch.sum(b_cur, dim=0))
            tailT += torch.stack(acc[: tail_degree + 1], dim=-1)
    hist = all_sum(hist, cells).view(n_vals + 1, G)[:n_vals].to(dt)

    theta = _angles(degree, dt, dev)
    tail_theta = _angles(tail_degree, dt, dev)
    return NegbinChebStats(
        T=T, YT=YT, sumT=all_sum(torch.sum(T, dim=0), cells), hist=hist,
        vals=torch.arange(n_vals, dtype=dt, device=dev),
        nodes_t=mid + half * torch.cos(theta), theta=theta,
        tailT=all_sum(tailT, cells),
        tail_nodes_u=u_mid + u_half * torch.cos(tail_theta),
        tail_theta=tail_theta,
    )


def negbin_cheb_stats(data: NegbinData, degree: int = 12, hist_cap: int = 1024,
                      tail_degree: int = 16) -> NegbinChebStats:
    """The per-fit sufficient statistics of the Chebyshev VEM path, on the
    device that holds ``data``.

    Requires integer counts (the lgamma(y + phi) value histogram and the
    log-y tail expansion are exact or valid only on integers). ``hist_cap``
    bounds the exact histogram (values below it: almost all elements);
    larger values go through the degree-``tail_degree`` log-y expansion.
    On a mesh the statistics are every rank's sums (T stays on its rank)."""
    Y = data.Y
    ymax = float(torch.max(Y)) if Y.numel() else 0.0
    integer = all(bool(torch.equal(Y[i:j], torch.floor(Y[i:j]))) for i, j in _blocks(*Y.shape))
    ymax, fractional = world_max(np.array([ymax, not integer], np.float64), data.cells,
                                 data.genes)
    if fractional:
        raise ValueError(
            "likelihood_impl='cheb' requires integer counts (the "
            "gammaln(y + phi) histogram is exact only on integers); "
            "use the exact path for non-integer Y"
        )
    n_vals = min(int(ymax) + 1, int(hist_cap))
    return _cheb_stats_program(data, ymax, degree=int(degree), n_vals=n_vals,
                               tail_degree=int(tail_degree))


class _NBChebCoeffs(NamedTuple):
    """Chebyshev coefficients of the netted per-element functions of x =
    scaled log s (parameter-dependent; rebuilt each evaluation from
    O(G C D) node values)."""
    g0: torch.Tensor   # (G, D+1)    y-coeff of llk0:  log m0 - log(phi+m0)
    h0: torch.Tensor   # (G, D+1)    1-coeff of llk0:  -phi * log(phi+m0)
    yc: torch.Tensor   # (G, C, D+1) y-coeff of D_c:   q_c + u_c
    oc: torch.Tensor   # (G, C, D+1) 1-coeff of D_c:   phi * u_c


def _netted_cheb_coeffs(params: NegbinParams, data: NegbinData,
                        stats: NegbinChebStats) -> _NBChebCoeffs:
    phi = torch.exp(params.log_phi)                              # (G,)
    s_nodes = torch.exp(stats.nodes_t)                           # (D+1,)
    m0 = torch.exp(params.log_mu)[:, None] * s_nodes[None, :]    # (G, D+1)
    logpm0 = torch.log(phi[:, None] + m0)
    g0 = params.log_mu[:, None] + stats.nodes_t[None, :] - logpm0
    h0 = -phi[:, None] * logpm0
    k1 = torch.exp(params.log_beta)[:, None] * data.Lp           # (G, C)
    logpm1 = torch.log(phi[:, None, None] + k1[:, :, None] * s_nodes[None, None, :])
    u = logpm0[:, None, :] - logpm1                              # (G, C, D+1)
    q = params.log_beta[:, None] + torch.log(data.Lp) - params.log_mu[:, None]
    return _NBChebCoeffs(
        g0=_cheb_transform(g0, stats.theta),
        h0=_cheb_transform(h0, stats.theta),
        yc=_cheb_transform(q[:, :, None] + u, stats.theta),
        oc=_cheb_transform(phi[:, None, None] * u, stats.theta),
    )


class _NBGammaStats(NamedTuple):
    """Per-E-step statistics (posterior-dependent, parameter-independent:
    gamma is fixed through the following M-step's Adam steps)."""
    YGT: torch.Tensor  # (G, C, D+1) sum_n y_ng gamma_nc T_d(x_n)
    GT: torch.Tensor   # (C, D+1)    sum_n gamma_nc T_d(x_n)


def _gamma_stats(data: NegbinData, stats: NegbinChebStats, gamma) -> _NBGammaStats:
    N = data.Y.shape[0]
    C = gamma.shape[1]
    D1 = stats.T.shape[1]
    U = (gamma[:, :, None] * stats.T[:, None, :]).reshape(N, C * D1)
    with full_fp32_matmul():
        YGT = (data.Y.T @ U).reshape(-1, C, D1)
        GT = gamma.T @ stats.T
    return _NBGammaStats(YGT=all_sum(YGT, data.cells), GT=all_sum(GT, data.cells))


def _B_from_stats(coeffs: _NBChebCoeffs, ps: _NBGammaStats):
    """B_g = sum_nc gamma_nc D_c[n, g], assembled from statistics."""
    return (torch.einsum("gcd,gcd->g", coeffs.yc, ps.YGT)
            + torch.einsum("gcd,cd->g", coeffs.oc, ps.GT))


def _llk0_sum_cheb(params: NegbinParams, stats: NegbinChebStats, coeffs: _NBChebCoeffs,
                   consts: _NBConsts, N, data: Optional[NegbinData] = None):
    """The llk0 sum from the statistics; with ``data`` on a genes axis its
    per-gene sums are every gene block's."""
    phi = torch.exp(params.log_phi)
    hist_term = torch.sum(stats.hist * torch.lgamma(stats.vals[:, None] + phi[None, :]))
    # the tail of lgamma(y + phi): a per-gene Chebyshev series in log y
    # contracted against the tail basis sums (zero where no count reaches
    # the histogram's cap)
    tail_nodes = torch.lgamma(torch.exp(stats.tail_nodes_u)[None, :] + phi[:, None])
    tail_term = torch.sum(_cheb_transform(tail_nodes, stats.tail_theta) * stats.tailT)
    terms = [hist_term, tail_term, torch.sum(torch.lgamma(phi)),
             torch.sum(phi * params.log_phi), torch.sum(coeffs.g0 * stats.YT),
             torch.sum(coeffs.h0, dim=0) @ stats.sumT]
    if data is not None:  # every term a sum over genes
        terms = _gene_sum(torch.stack(terms), data).unbind()
    hist_term, tail_term, lgamma_phi, phi_log_phi, g0_term, h0_term = terms
    return (
        hist_term + tail_term
        - N * lgamma_phi
        - consts.lgamma_y1_sum
        + N * phi_log_phi
        + g0_term
        + h0_term
    )


def _estep_A_cheb(data: NegbinData, stats: NegbinChebStats, coeffs: _NBChebCoeffs, gene_w):
    """A[n, c] = sum_g gene_w_g D_c[n, g] through one thin (N, G) x
    (G, C (D+1)) product and a Chebyshev contraction per cell."""
    G, C, D1 = coeffs.yc.shape
    M = (gene_w[:, None, None] * coeffs.yc).reshape(G, C * D1)
    k = torch.einsum("g,gcd->cd", gene_w, coeffs.oc)             # (C, D+1)
    with full_fp32_matmul():
        YM = (data.Y @ M).reshape(-1, C, D1)                     # (N, C, D+1)
        return all_sum(torch.einsum("nd,ncd->nc", stats.T, YM) + stats.T @ k.T, data.genes)


def _mstep_objective_cheb(params: NegbinParams, data: NegbinData, stats: NegbinChebStats,
                          ps: _NBGammaStats, r, lam, consts: _NBConsts):
    """The penalized expected log-likelihood from sufficient statistics:
    O(G (V + C D)) an evaluation, no cell-indexed work."""
    coeffs = _netted_cheb_coeffs(params, data, stats)
    return (_llk0_sum_cheb(params, stats, coeffs, consts, _n_cells(data), data)
            + _r_dot(r, _B_from_stats(coeffs, ps), data)
            - _penalty(params.log_mu, params.log_beta, data.l_hat, lam, data))


# --- data and initialization ----------------------------------------------

def _host_or_tensor(x, dtype, device):
    """``x`` (a tensor or anything numpy reads) as a tensor on ``device``."""
    if torch.is_tensor(x):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def prepare_negbin_data(Y, L, s=None, *, device="cuda", dtype=torch.float32,
                        cells: Optional[Cells] = None,
                        genes: Optional[Genes] = None) -> NegbinData:
    """The device data of a fit. L becomes the script's Lp = L /
    colMeans(L) (reference inst/create_model3_synthetic.R:17) and the size
    factors default to the row sums over their mean (mu and beta absorb the
    global factor).

    ``Y`` may be a numpy array, a tensor (one already on ``device`` in
    ``dtype`` is kept as it is) or a scipy sparse matrix (read as a
    canonical CSR, ``api._canonical_csr``, so duplicate entries are summed).
    Its rows reach the device through ``models/multinomial.prepare_data``'s
    row-block loop, each block in its narrowest exact wire type, into one
    buffer in ``dtype``: a sparse matrix is never dense on the host.

    On a mesh (``cells``) Y (and a given ``s``) are this rank's rows: the
    size factors' scale is the mean of every rank's totals, and a cell
    without counts on any rank raises on every rank. With ``genes`` Y and L
    are this rank's gene block: the totals are every gene block's, and so
    are Lp's column means."""
    from ..api import _canonical_csr

    device = resolve_device(device)
    L_np = L.detach().cpu().numpy() if torch.is_tensor(L) else np.asarray(L)
    if is_scipy_sparse(Y):
        Y = _canonical_csr(Y)
    elif not torch.is_tensor(Y):
        Y = np.asarray(Y)
    if len(Y.shape) != 2 or L_np.ndim != 2 or Y.shape[1] != L_np.shape[0]:
        raise ValueError(
            f"Y must be (N, G) and L (G, C) with matching G; got "
            f"{tuple(Y.shape)} and {L_np.shape}"
        )
    md = mm.prepare_data(Y, L_np, device=device, dtype=dtype, check_feasible=False, cells=cells,
                         genes=genes)
    totals = md.s
    if bool(world_max(torch.any(totals == 0).to(torch.int64), cells, genes)):
        raise ValueError("all cells must have nonzero counts")
    Ld = torch.as_tensor(L_np, dtype=dtype, device=device)
    if genes is None:
        Lp = Ld / torch.mean(Ld, dim=0, keepdim=True)
    else:
        Lp = Ld / (all_sum(torch.sum(Ld, dim=0, keepdim=True), genes) / genes.g)
    # mean(s) = 1: mu then carries the magnitude (identifiable)
    if s is not None:
        s = _host_or_tensor(s, dtype, device)
    else:
        n = totals.shape[0] if cells is None else cells.n
        s = totals / (all_sum(torch.sum(totals), cells) / n)
    return NegbinData(Y=md.Y, Lp=Lp, s=s, l_hat=torch.mean(Lp, dim=1), cells=cells, genes=genes)


def init_negbin_params(data: NegbinData, dtype=None) -> NegbinParams:
    """Moment init: mu from size-factor-normalized gene means, beta = mu /
    l_hat (so the two branches start indistinguishable, like the script's
    beta <- mu), phi from the NB method of moments (var = m + m^2/phi).
    Two blocked passes over Y (on a mesh, over every rank's rows)."""
    Y, s = data.Y, data.s
    N, G = Y.shape
    with torch.no_grad():
        acc = torch.zeros(G, dtype=Y.dtype, device=Y.device)
        for i, j in _blocks(N, G):
            acc += torch.sum(Y[i:j] / s[i:j, None], dim=0)
        mu0 = torch.clamp(all_sum(acc, data.cells) / _n_cells(data), min=1e-6)
        m2 = torch.zeros_like(acc)
        resid = torch.zeros_like(acc)
        for i, j in _blocks(N, G):
            m = s[i:j, None] * mu0[None, :]
            m2 += torch.sum(m**2, dim=0)
            resid += torch.sum((Y[i:j] - m) ** 2 - m, dim=0)
        if data.cells is not None:
            m2, resid = all_sum(torch.stack([m2, resid]), data.cells).unbind()
        phi0 = torch.clamp(m2 / torch.clamp(resid, min=1e-6), 0.05, 1e4)
        dtype = Y.dtype if dtype is None else dtype
        C = data.Lp.shape[1]
        return NegbinParams(
            log_mu=torch.log(mu0).to(dtype),
            log_beta=torch.log(mu0 / torch.clamp(data.l_hat, min=1e-6)).to(dtype),
            log_phi=torch.log(phi0).to(dtype),
            alpha_logits=torch.zeros(C, dtype=dtype, device=Y.device),
        )


# --- the EM loop -------------------------------------------------------------

class NegbinResult(NamedTuple):
    params: NegbinParams
    post: NegbinPosterior
    elbo_trace: np.ndarray      # (max_iter + 1,), NaN after the last iteration
    n_iter: int
    final_elbo: float
    # Adam's state at exit: lets ``resume_from`` continue the trajectory
    opt_state: Optional[OptaxAdamState] = None
    # which loop made this result: None the exact clone scan, an int the
    # Chebyshev path of that degree (``resume_from`` refuses to mix them)
    cheb_degree: Optional[int] = None
    # wall seconds of the loop alone, after synchronizing the device
    loop_seconds: float = float("nan")


def _logit(p: float) -> float:
    return math.log(p) - math.log1p(-p)


def _mstep_alpha(params: NegbinParams, post: NegbinPosterior,
                 cells: Optional[Cells] = None) -> NegbinParams:
    """The closed-form M-step of the clone prior (on a mesh, gamma's mean
    over every rank's cells)."""
    n = post.gamma.shape[0] if cells is None else cells.n
    mean = all_sum(torch.sum(post.gamma, dim=0), cells) / n
    alpha = torch.clamp(mean, min=1e-12)
    return params._replace(alpha_logits=torch.log(alpha))


def _adam_steps(params: NegbinParams, opt: OptaxAdam, state: OptaxAdamState, m_steps: int,
                grad_fn):
    """``m_steps`` Adam steps on -objective over (log mu, log beta, log
    phi); ``grad_fn(rates)`` gives the objective's gradient."""
    rates = [params.log_mu, params.log_beta, params.log_phi]
    for _ in range(m_steps):
        rates, state = opt.step(state, rates, [-g for g in grad_fn(rates)])
    return params._replace(log_mu=rates[0], log_beta=rates[1], log_phi=rates[2]), state


def run_negbin_em(
    data: NegbinData,
    rho_init=None,
    stats: Optional[NegbinChebStats] = None,
    *,
    resume_from: Optional[NegbinResult] = None,
    max_iter: int = 100,
    rel_tol: float = 1e-6,
    lam: float = 1.0,
    rho_prior: float = 0.5,
    learning_rate: float = 0.05,
    m_steps: int = 5,
    window_size: int = 10,
    lr_decay_rate: float = 0.4,
    lr_decay_iters: int = 100,
) -> NegbinResult:
    """The full variational-EM fit, on the device that holds ``data``
    (:func:`prepare_negbin_data`), with one host sync an iteration: the
    stop test reads the new ELBO.

    Each iteration: ``m_steps`` Adam steps on (log mu, log beta, log phi)
    after the closed-form alpha, then the CAVI gamma update (from the
    current r) and the r update (from the new gamma). It stops when the
    mean |relative ELBO change| over ``window_size`` iterations drops below
    ``rel_tol`` (``infer.Monitor``), or at ``max_iter``. The initial ELBO
    follows one E-step under the moment initialization.

    The Adam step size decays smoothly over EM iterations i:
    ``learning_rate * lr_decay_rate ** (i / lr_decay_iters)`` (optax's
    ``exponential_decay`` over the ``m_steps * lr_decay_iters`` Adam steps);
    ``lr_decay_rate=1.0`` keeps it constant.

    ``resume_from``: a previous :class:`NegbinResult`, whose params,
    posterior and Adam state are carried on; its last iteration already ran
    its E-step, so none is rerun, and the ELBO is re-evaluated at its state.
    The window restarts, so a chained run takes the same steps as one long
    run and may stop at another iteration. The chained run must use the same
    loop (exact, or Chebyshev of the same degree).

    ``stats``: :func:`negbin_cheb_stats`' statistics switch the loop onto
    the Chebyshev path: Y is read twice an iteration and the Adam steps cost
    O(G (V + C D)). Its ``elbo_trace`` is then the Chebyshev objective;
    ``final_elbo`` is re-evaluated exactly at the last state, so it compares
    across loops.
    """
    degree = None if stats is None else int(stats.T.shape[1]) - 1
    if resume_from is not None:
        prev = getattr(resume_from, "cheb_degree", None)
        if prev != degree:
            def _impl(d):
                return "exact" if d is None else f"cheb (degree {d})"
            raise ValueError(
                "resume_from was produced by the "
                f"{_impl(prev)} backend but this call selects "
                f"{_impl(degree)}; resume chunks must keep the same impl "
                "(pass the same `stats` argument, or none, as the "
                "original run)"
            )
    # every product of the loop in full float32 (no TF32)
    with full_fp32_matmul():
        return _run_negbin_em_program(
            data, rho_init, stats, degree, resume_from=resume_from, max_iter=max_iter,
            rel_tol=rel_tol, lam=lam, rho_prior=rho_prior, learning_rate=learning_rate,
            m_steps=m_steps, window_size=window_size, lr_decay_rate=lr_decay_rate,
            lr_decay_iters=lr_decay_iters)


def _run_negbin_em_program(data, rho_init, stats, degree, *, resume_from, max_iter, rel_tol,
                           lam, rho_prior, learning_rate, m_steps, window_size, lr_decay_rate,
                           lr_decay_iters) -> NegbinResult:
    """The loops of :func:`run_negbin_em`, after its checks."""
    Y = data.Y
    dt, dev = Y.dtype, Y.device
    N, G = Y.shape
    C = data.Lp.shape[1]
    opt = OptaxAdam(learning_rate, transition_steps=m_steps * lr_decay_iters,
                    decay_rate=lr_decay_rate)
    if resume_from is None:
        params = init_negbin_params(data, dt)
        r0 = (torch.full((G,), 0.5, dtype=dt, device=dev) if rho_init is None
              else _host_or_tensor(rho_init, dt, dev))
        post = NegbinPosterior(gamma=torch.full((N, C), 1.0 / C, dtype=dt, device=dev), r=r0)
        opt_state = opt.init((params.log_mu, params.log_beta, params.log_phi))
    else:
        if rho_init is not None:
            raise ValueError(
                "rho_init conflicts with resume_from (the resumed "
                "posterior already carries r); pass one or the other"
            )
        if resume_from.opt_state is None:
            raise ValueError(
                "resume_from has no optimizer state (result predates "
                "resume support?)"
            )
        params, post, opt_state = resume_from.params, resume_from.post, resume_from.opt_state

    logit_prior = _logit(rho_prior)
    consts = _nb_constants(data)
    np_dtype = np.float64 if dt == torch.float64 else np.float32

    if stats is None:
        def estep(params, post):
            log_alpha = torch.log_softmax(params.alpha_logits, dim=0)
            A, _ = _scan(params, data, gene_w=post.r)
            gamma = torch.softmax(log_alpha[None, :] + A, dim=1)
            # r from the NEW gamma (CAVI order); B also assembles the ELBO,
            # so it is evaluated in float64 (see _elbo_with_B)
            _, B = _scan(params, data, cell_w=gamma, dtype=torch.float64)
            r = torch.sigmoid(logit_prior + B).to(dt)
            return NegbinPosterior(gamma=gamma, r=r), B, None

        def elbo(params, post, B, _ps):
            return _elbo_with_B(params, data, post, B, lam, rho_prior)

        def mstep(params, opt_state, post, _ps):
            params = _mstep_alpha(params, post, data.cells)
            return _adam_steps(params, opt, opt_state, m_steps,
                               lambda rates: _mstep_value_and_grad(rates, data, post, lam,
                                                                   consts)[1])

        if resume_from is None:
            post, B0, ps0 = estep(params, post)
        else:
            (_, B0), ps0 = _scan(params, data, cell_w=post.gamma, dtype=torch.float64), None
    else:
        def elbo(params, post, B, _ps):
            with torch.no_grad():
                coeffs = _netted_cheb_coeffs(params, data, stats)
                return (_llk0_sum_cheb(params, stats, coeffs, consts, _n_cells(data), data)
                        + _r_dot(post.r, B, data)
                        - _penalty(params.log_mu, params.log_beta, data.l_hat, lam, data)
                        + _elbo_extras(params, data, post, rho_prior, data.cells))

        def estep(params, post):
            with torch.no_grad():
                log_alpha = torch.log_softmax(params.alpha_logits, dim=0)
                coeffs = _netted_cheb_coeffs(params, data, stats)
                A = _estep_A_cheb(data, stats, coeffs, post.r)
                gamma = torch.softmax(log_alpha[None, :] + A, dim=1)
                # the statistics do not depend on the parameters: the next
                # M-step's Adam steps reuse them without a pass over Y
                ps = _gamma_stats(data, stats, gamma)
                B = _B_from_stats(coeffs, ps)
                return NegbinPosterior(gamma=gamma, r=torch.sigmoid(logit_prior + B)), B, ps

        def mstep(params, opt_state, post, ps):
            params = _mstep_alpha(params, post, data.cells)

            def grad(rates):
                rates = [t.detach().requires_grad_(True) for t in rates]
                with torch.enable_grad():
                    p = params._replace(log_mu=rates[0], log_beta=rates[1], log_phi=rates[2])
                    obj = _mstep_objective_cheb(p, data, stats, ps, post.r, lam, consts)
                    return torch.autograd.grad(obj, rates)

            return _adam_steps(params, opt, opt_state, m_steps, grad)

        if resume_from is None:
            post, B0, ps0 = estep(params, post)
        else:
            ps0 = _gamma_stats(data, stats, post.gamma)
            B0 = _B_from_stats(_netted_cheb_coeffs(params, data, stats), ps0)

    e0 = float(elbo(params, post, B0, ps0))
    mon = Monitor([e0], max_iter, rel_tol, window_size, np_dtype)
    lane = np.zeros(1, np.int64)
    ps = ps0
    synchronize(dev)
    t0 = time.perf_counter()
    while mon.live()[0]:
        params, opt_state = mstep(params, opt_state, post, ps)
        post, B, ps = estep(params, post)
        mon.record(lane, np.array([float(elbo(params, post, B, ps))]))  # the one host sync
    synchronize(dev)
    loop_seconds = time.perf_counter() - t0
    n_iter = int(mon.i[0])
    if stats is None:
        final = float(mon.trace[0, n_iter])
    else:
        # the exact ELBO at the last state (one exact clone scan), so that
        # fits compare across loops and against the golden pins
        final = float(np_dtype(float(_elbo(params, data, post, lam, rho_prior))))
    return NegbinResult(params=params, post=post, elbo_trace=mon.trace[0], n_iter=n_iter,
                        final_elbo=final, opt_state=opt_state, cheb_degree=degree,
                        loop_seconds=loop_seconds)


# --- Gibbs ---------------------------------------------------------------------

class GibbsDraws:
    """The random draws of a Gibbs chain, from one seeded
    ``torch.Generator`` on ``device``, in a fixed order: the initial clones
    (unless given), then per sweep the Gumbel noise of the clone draws (N,
    C) and the uniforms of the dosage draws (G,). A subclass can hand the
    chain the draws another program made in the same places: a categorical
    draw is ``argmax(logits + gumbel)`` and a Bernoulli draw ``uniform <
    p``, as ``jax.random`` makes them."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator(device=torch.device(device))
        self.generator.manual_seed(int(seed))

    def initial_clones(self, N: int, C: int, device) -> torch.Tensor:
        return torch.randint(0, C, (N,), generator=self.generator, device=device)

    def uniform(self, shape, dtype, device) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator, dtype=dtype, device=device)

    def gumbel(self, shape, dtype, device) -> torch.Tensor:
        u = self.uniform(shape, dtype, device)
        tiny = torch.finfo(dtype).tiny
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _params_on(params, device, dtype) -> NegbinParams:
    """``params`` (fields as tensors or arrays) as a NegbinParams on
    ``device`` in ``dtype``."""
    return NegbinParams(*(_host_or_tensor(getattr(params, f), dtype, device)
                          for f in NegbinParams._fields))


def gibbs_pi_rho(
    Y,
    L,
    *,
    params: Optional[NegbinParams] = None,
    n_iter: int = 20,
    rho_init=None,
    pi_init=None,
    rho_prior: float = 0.5,
    s=None,
    seed: int = 0,
    draws: Optional[GibbsDraws] = None,
    device="cuda",
    dtype: str = "float32",
):
    """Collapsed Gibbs sweeps over (pi_n, rho_g), the reference's deleted
    ``gibbs_pi_rho(rho, data, params, n_iter)`` (called at
    inst/create_model3_synthetic.R:45).

    Each sweep draws every cell's clone at once (one categorical over the
    rho-gated log-likelihood: cells are conditionally independent given
    rho) and then every gene's dosage indicator at once (Bernoulli given the
    new assignments): two clone scans a sweep. ``params`` defaults to the
    moment initialization; pass a :class:`NegbinParams` (tensors or arrays,
    e.g. from :func:`run_negbin_em`) to sample under fitted rates. The draws
    come from ``draws``, by default :class:`GibbsDraws` seeded with
    ``seed``.

    Returns ``{"pi_trace": (n_iter, N), "rho_trace": (n_iter, G)}`` as
    numpy arrays, the shape the script's trace consumers expect."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    data = prepare_negbin_data(Y, L, s=s, device=dev, dtype=dt)
    params = init_negbin_params(data, dt) if params is None else _params_on(params, dev, dt)
    draws = GibbsDraws(seed, dev) if draws is None else draws
    N = data.Y.shape[0]
    G, C = data.Lp.shape
    pi = (draws.initial_clones(N, C, dev) if pi_init is None
          else _host_or_tensor(pi_init, torch.int64, dev))
    rho = (torch.full((G,), 0.5, dtype=dt, device=dev) if rho_init is None
           else _host_or_tensor(rho_init, dt, dev))
    logit_prior = _logit(rho_prior)
    with torch.no_grad():
        log_alpha = torch.log_softmax(params.alpha_logits, dim=0)
        pi_trace, rho_trace = [], []
        for _ in range(int(n_iter)):
            # pi | rho: categorical over clones with the rho-gated likelihood
            A, _ = _scan(params, data, gene_w=rho)
            logits = log_alpha[None, :] + A
            pi = torch.argmax(draws.gumbel((N, C), dt, dev) + logits, dim=1)
            # rho | pi: per-gene Bernoulli with the pi-conditioned odds
            onehot = torch.nn.functional.one_hot(pi, C).to(dt)
            _, B = _scan(params, data, cell_w=onehot)
            p = torch.sigmoid(logit_prior + B)
            rho = (draws.uniform((G,), dt, dev) < p).to(dt)
            pi_trace.append(pi)
            rho_trace.append(rho)
    return {
        "pi_trace": torch.stack(pi_trace).cpu().numpy() if pi_trace else np.zeros((0, N), np.int64),
        "rho_trace": (torch.stack(rho_trace).cpu().numpy() if rho_trace
                      else np.zeros((0, G), mm._NUMPY[dt])),
    }


def clone_probs_from_gibbs(pi_trace, C: int, burn_in: int = 0) -> np.ndarray:
    """(N, C) clone frequencies over the trace (the reference's deleted
    ``clone_probs_from_gibbs(pi_traces, C)``,
    inst/create_model3_synthetic.R:46)."""
    pi_trace = np.asarray(pi_trace)[burn_in:]
    if pi_trace.ndim != 2 or pi_trace.shape[0] == 0:
        raise ValueError("pi_trace must be (n_iter, N) with n_iter > burn_in")
    return np.stack([(pi_trace == c).mean(axis=0) for c in range(C)], axis=1)


def rho_probs_from_gibbs(rho_trace, burn_in: int = 0) -> np.ndarray:
    """(G, 2) posterior [P(rho=0), P(rho=1)] over the trace (the
    reference's deleted ``rho_probs_from_gibbs(traces$rho_trace)``,
    inst/create_model3_synthetic.R:51; the script takes a per-gene
    ``which.max`` over its two columns)."""
    rho_trace = np.asarray(rho_trace)[burn_in:]
    if rho_trace.ndim != 2 or rho_trace.shape[0] == 0:
        raise ValueError("rho_trace must be (n_iter, G) with n_iter > burn_in")
    p1 = rho_trace.mean(axis=0)
    return np.stack([1 - p1, p1], axis=1)


# --- the fit object, the fit and serving ---------------------------------------

@dataclass
class ClonealignV1Fit:
    """Fit object of the legacy family, the v1 analog of ``ClonealignFit``
    (clone labels, posterior probabilities, ML parameters, convergence
    trace). Saved as the JAX package's ``.npz`` (``model="negbin_v1"``), so
    a file written by either package loads in the other. ``timings`` holds
    the wall seconds of the fit's phases (``setup``, ``loop``), measured
    after synchronizing the device; it is not saved."""
    clone: list
    clone_probs: np.ndarray         # (N, C)
    rho_probs: np.ndarray           # (G,) q(rho_g = 1)
    mu: np.ndarray
    beta: np.ndarray
    phi: np.ndarray
    alpha: np.ndarray
    elbo_trace: np.ndarray
    n_iter: int
    final_elbo: float
    clone_names: list = field(default_factory=list)
    # mean total counts of the training cells. The NB likelihood is
    # scale-sensitive in s, so serving puts new cells' size factors on the
    # fit's scale: s_new = totals_new / s_mean. NaN on fits saved before
    # this field existed.
    s_mean: float = float("nan")
    timings: Optional[dict] = None

    def __repr__(self):
        N, C = self.clone_probs.shape
        return (
            f"A clonealign_v1 (negative-binomial dosage mixture) fit for "
            f"{N} cells, {len(self.mu)} genes, and {C} clones\n"
            f"   converged in {self.n_iter} iterations, "
            f"final ELBO {self.final_elbo:.4f}"
        )

    def save(self, path) -> str:
        """Persist to .npz (the ``model`` tag lets loaders and the CLI
        dispatch on family). Returns the path written (np.savez appends
        ``.npz``)."""
        np.savez_compressed(
            path,
            model="negbin_v1",
            clone=np.asarray(self.clone, dtype=object),
            clone_probs=self.clone_probs,
            rho_probs=self.rho_probs,
            mu=self.mu, beta=self.beta, phi=self.phi, alpha=self.alpha,
            elbo_trace=self.elbo_trace,
            n_iter=self.n_iter, final_elbo=self.final_elbo,
            clone_names=np.asarray(self.clone_names, dtype=object),
            s_mean=self.s_mean,
        )
        return path if str(path).endswith(".npz") else f"{path}.npz"

    @classmethod
    def load(cls, path) -> "ClonealignV1Fit":
        with np.load(path, allow_pickle=True) as z:
            if "model" not in z.files or str(z["model"]) != "negbin_v1":
                tag = str(z["model"]) if "model" in z.files else "<absent>"
                raise ValueError(f"not a clonealign v1 fit: model tag {tag}")
            return cls(
                clone=[str(c) for c in z["clone"]],
                clone_probs=z["clone_probs"],
                rho_probs=z["rho_probs"],
                mu=z["mu"], beta=z["beta"], phi=z["phi"], alpha=z["alpha"],
                elbo_trace=z["elbo_trace"],
                n_iter=int(z["n_iter"]),
                final_elbo=float(z["final_elbo"]),
                clone_names=[str(c) for c in z["clone_names"]],
                s_mean=float(z["s_mean"]) if "s_mean" in z else float("nan"),
            )


def inference_em(
    Y,
    L,
    *,
    max_iter: int = 100,
    rel_tol: float = 1e-6,
    lam: float = 1.0,
    rho_init=None,
    rho_prior: float = 0.5,
    s=None,
    learning_rate: float = 0.05,
    m_steps: Optional[int] = None,
    clone_call_probability: float = 0.95,
    clone_names=None,
    dtype: str = "float32",
    verbose: bool = True,
    likelihood_impl: str = "exact",
    z_degree: int = 12,
    device="cuda",
) -> ClonealignV1Fit:
    """Fit the v1 negative-binomial dosage mixture (the function the
    reference's legacy script calls, inst/create_model3_synthetic.R:104-105
    ``inference_em(Y, Lp, rel_tol, max_iter, lambda, rho_init)``; deleted
    upstream, rebuilt as deterministic variational EM).

    Returns a :class:`ClonealignV1Fit` whose ``clone_probs`` / ``rho_probs``
    are the variational marginals (the analog of ``clone_probs_from_gibbs``
    / ``rho_probs_from_gibbs``, inst/create_model3_synthetic.R:46-52).

    ``likelihood_impl="cheb"`` switches the loop onto the Chebyshev
    sufficient-statistics path (see :func:`run_negbin_em`): the Adam steps
    stop touching Y, so ``m_steps`` defaults to 30 there (5 on the exact
    path, where each step costs a clone scan). It requires integer counts;
    ``z_degree`` sets the expansion's degree over the log size factors.
    """
    if likelihood_impl not in ("exact", "cheb"):
        raise ValueError(
            f"likelihood_impl must be 'exact' or 'cheb', got "
            f"{likelihood_impl!r}"
        )
    if m_steps is None:
        m_steps = 30 if likelihood_impl == "cheb" else 5
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    synchronize(dev)
    t0 = time.perf_counter()
    data = prepare_negbin_data(Y, L, s=s, device=dev, dtype=dt)
    stats = (negbin_cheb_stats(data, degree=int(z_degree))
             if likelihood_impl == "cheb" else None)
    synchronize(dev)
    setup_seconds = time.perf_counter() - t0
    C = data.Lp.shape[1]
    if clone_names is None:
        # default clone naming, as the v2 fit does (reference
        # R/clonealign.R:249-254)
        clone_names = (list(string.ascii_uppercase[:C]) if C <= 26
                       else [f"clone_{i}" for i in range(C)])
    if verbose:
        print("Optimizing ELBO (v1 negative-binomial family)")
    result = run_negbin_em(
        data, rho_init, stats,
        max_iter=int(max_iter), rel_tol=float(rel_tol), lam=float(lam),
        rho_prior=float(rho_prior), learning_rate=float(learning_rate),
        m_steps=int(m_steps),
    )
    from ..assign import clone_assignment

    gamma = result.post.gamma.double().cpu().numpy()
    clones = clone_assignment(gamma, clone_names, clone_call_probability)
    n_iter = int(result.n_iter)
    p = result.params
    return ClonealignV1Fit(
        clone=list(clones),
        clone_probs=gamma,
        rho_probs=result.post.r.double().cpu().numpy(),
        mu=torch.exp(p.log_mu).double().cpu().numpy(),
        beta=torch.exp(p.log_beta).double().cpu().numpy(),
        phi=torch.exp(p.log_phi).double().cpu().numpy(),
        alpha=torch.softmax(p.alpha_logits, dim=0).double().cpu().numpy(),
        elbo_trace=np.asarray(result.elbo_trace, np.float64)[: n_iter + 1],
        n_iter=n_iter,
        final_elbo=float(result.final_elbo),
        clone_names=[str(c) for c in clone_names],
        s_mean=float(torch.sum(data.Y, dim=1).mean()),
        timings={"setup": setup_seconds, "loop": result.loop_seconds},
    )


def _log_posteriors(fit: ClonealignV1Fit, Y_new, L, s=None, *, device, dtype):
    """The unnormalized clone log-posteriors log alpha_c + A[n, c] of new
    cells (N_new, C) on ``device``, A the gamma update's accumulator under
    the fitted rates with q(rho) as gene weights (one blocked clone scan)."""
    if s is None:
        if is_scipy_sparse(Y_new):
            totals = np.asarray(Y_new.sum(axis=1), np.float64).ravel()
        elif torch.is_tensor(Y_new):
            totals = torch.sum(Y_new, dim=1, dtype=torch.float64).cpu().numpy()
        else:
            totals = np.sum(np.asarray(Y_new), axis=1, dtype=np.float64)
        denom = fit.s_mean if np.isfinite(fit.s_mean) else totals.mean()
        s = totals / denom
    data = prepare_negbin_data(Y_new, L, s=s, device=device, dtype=dtype)
    if len(fit.mu) != data.Lp.shape[0]:
        raise ValueError(
            f"fit has {len(fit.mu)} genes but Y_new/L have "
            f"{data.Lp.shape[0]}; serve over the fit's genes, same order"
        )

    def log_of(x):
        return torch.log(torch.as_tensor(np.asarray(x), dtype=dtype, device=device))

    params = NegbinParams(log_mu=log_of(fit.mu), log_beta=log_of(fit.beta),
                          log_phi=log_of(fit.phi), alpha_logits=log_of(fit.alpha))
    r = torch.as_tensor(np.asarray(fit.rho_probs), dtype=dtype, device=device)
    return params.alpha_logits[None, :] + _accumulate_A(params, data, r)


def classify_cells(
    fit: ClonealignV1Fit,
    Y_new,
    L,
    s=None,
    clone_call_probability: float = 0.95,
    *,
    device="cuda",
    dtype: str = "float32",
):
    """Assign new cells under a fitted v1 model, without refitting (the v1
    analog of :func:`clonealign_torch.serve.assign_cells`).

    The clone posterior of an unseen cell is the CAVI gamma update under
    the fitted rates with the fitted dosage marginals q(rho) as gene
    weights: log q(pi=c) = log alpha_c + sum_g r_g D_c[n, g] + const, one
    clone scan over (N_new, G) in row blocks on ``device``.

    Size factors: the NB mean is s_n * rate, so s carries real scale. New
    cells default to s = totals / fit.s_mean, the training cells' mean
    total, so that a deeper-sequenced batch is not read as higher
    expression; pass ``s`` to override. Fits saved before ``s_mean``
    existed fall back to the batch's own mean.

    Returns ``(clones, clone_probs)`` like the v2 serving path."""
    from ..assign import clone_assignment

    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    with torch.no_grad():
        gamma = torch.softmax(_log_posteriors(fit, Y_new, L, s, device=dev, dtype=dt), dim=1)
    gamma = gamma.double().cpu().numpy()
    names = fit.clone_names or [f"clone_{i}" for i in range(gamma.shape[1])]
    return clone_assignment(gamma, names, clone_call_probability), gamma

"""Allele-specific (allelic-imbalance) likelihood (reference
R/allele-specific.R:17-71), counterpart of ``clonealign_tpu/models/allele.py``.

Per variant v and cell n, the alternative-allele count alt[v,n] out of
coverage cov[v,n] is beta-binomial distributed. Variants where the clone's
copy number is 2 are balanced, BetaBinomial(2, 2); otherwise imbalanced, an
equal mixture of BetaBinomial(0.1, 1.9) and BetaBinomial(1.9, 0.1). Summing
over variants gives an (N, C) clone log-likelihood that is added to the
expression term (reference R/inference-tflow.R:302-304). It does not depend
on any parameter, so a fit computes it once, at setup.

The per-variant mixture terms are (V, N) matrices; the clone selection and
the variant sum are two (N, V) x (V, C) products. The term is separable by
cell, so it is computed in blocks of cells: the (V, block) temporaries stay
bounded whatever N is, and the blocks change no value.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import full_fp32_matmul

# Elements of one (V, block) temporary: 2^22 (16 MB at float32). A block
# holds about ten of them.
_BLOCK_ELEMENTS = 1 << 22


def beta_binomial_log_prob(k, n, alpha: float, beta: float):
    """Beta-binomial log-pmf in lgamma form (reference
    R/allele-specific.R:52-58), its terms in the JAX package's order: in
    float32 the large lgamma terms cancel, so another association would
    round differently."""
    lg = torch.lgamma
    ll = lg(n + 1.0) - lg(k + 1.0) - lg(n - k + 1.0)
    ll = ll + lg(k + alpha) + lg(n - k + beta) - lg(alpha + beta + n)
    ll = ll - lg(torch.tensor(alpha, dtype=k.dtype)) - lg(torch.tensor(beta, dtype=k.dtype)) + lg(
        torch.tensor(alpha + beta, dtype=k.dtype)
    )
    return ll


def construct_ai_likelihood(clone_allele, alt, cov):
    """(N, C) beta-binomial clone log-likelihood, on the device and in the
    dtype of ``clone_allele``.

    Args:
      clone_allele: (V, C) tensor, copy number at each variant per clone.
      alt: (V, N) alternative-allele counts, a tensor or a host array.
      cov: (V, N) coverage counts, likewise.

    Blocks of ``_BLOCK_ELEMENTS // V`` cells; a host array is moved to the
    device one block at a time.

    The two products run in full float32 (no TF32), as the JAX package's
    XLA products do.
    """
    dtype, device = clone_allele.dtype, clone_allele.device
    V, N = alt.shape
    C = clone_allele.shape[1]
    block = max(1, _BLOCK_ELEMENTS // max(V, 1))
    log_half = torch.log(torch.tensor(0.5, dtype=dtype, device=device))
    is_cn2 = (clone_allele == 2).to(dtype)  # (V, C)
    out = torch.empty(N, C, dtype=dtype, device=device)
    for i in range(0, N, block):
        a = torch.as_tensor(alt[:, i : i + block], dtype=dtype, device=device)
        c = torch.as_tensor(cov[:, i : i + block], dtype=dtype, device=device)
        p1 = torch.logaddexp(log_half + beta_binomial_log_prob(a, c, 0.1, 1.9),
                             log_half + beta_binomial_log_prob(a, c, 1.9, 0.1))  # imbalanced
        p2 = beta_binomial_log_prob(a, c, 2.0, 2.0)  # balanced
        # sum over variants, selecting p2 where CN == 2 else p1
        with full_fp32_matmul():
            out[i : i + block] = p2.T @ is_cn2 + p1.T @ (1.0 - is_cn2)
    return out


def snv_clone_probs(v_log_prob):
    """Normalized clone probabilities from the SNV likelihood alone
    (reference R/inference-tflow.R:436-440)."""
    return torch.softmax(v_log_prob, dim=1)


def sanitize_allele_info(clone_allele, cov, ref, n_cells, n_clones):
    """Shape checks (reference R/allele-specific.R:61-71): ``cov``/``ref``
    are cell-by-variant as passed by the user."""
    V = clone_allele.shape[0]
    if clone_allele.shape[1] != n_clones:
        raise ValueError(
            f"clone_allele has {clone_allele.shape[1]} clones, expected {n_clones}"
        )
    for name, m in (("cov", cov), ("ref", ref)):
        if m.shape[0] != n_cells:
            raise ValueError(f"{name} must have {n_cells} rows (cells), got {m.shape[0]}")
        if m.shape[1] != V:
            raise ValueError(f"{name} must have {V} columns (variants), got {m.shape[1]}")
        if (np.asarray(m) < 0).any():
            raise ValueError(f"{name} must be non-negative counts")
    # alt = cov - ref must be non-negative; ref > cov means the ref/cov slots
    # were swapped (or alt counts were passed as ref), which would feed
    # lgamma negative counts
    if (np.asarray(ref) > np.asarray(cov)).any():
        raise ValueError(
            "ref counts exceed cov at some (cell, variant): cov must be the "
            "TOTAL coverage and ref the reference-allele subset of it"
        )
    return V

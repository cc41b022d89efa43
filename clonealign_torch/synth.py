"""Synthetic data generators for benchmarking and accuracy validation.

``simulate_model3`` reproduces the reference's legacy generative script
(reference inst/create_model3_synthetic.R:3-29) — negative-binomial counts
where a per-gene dosage indicator rho decides whether expression follows the
clone copy-number profile. The functions that script fed no longer exist in
the reference (SURVEY.md §2.2 item 14); here it serves as a
ground-truth-labelled benchmark generator, exactly as specified.

``simulate_multinomial`` draws from the v2 model itself (well-specified case)
for accuracy/recovery tests.

A numpy-only copy of ``clonealign_tpu/synth.py``: importing that module
would run the JAX package's ``__init__``, which imports jax. The two must
draw the same data from the same seed (tests/test_torch_restarts.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class SyntheticData(NamedTuple):
    Y: np.ndarray           # (N, G) counts
    L: np.ndarray           # (G, C) integer copy numbers
    L_normalized: np.ndarray  # (G, C) per-clone mean-normalized (script's Lp)
    clone_idx: np.ndarray   # (N,) ground-truth clone of each cell
    mu: np.ndarray          # (G,) per-gene base rate
    s: np.ndarray           # (N,) size factors / totals
    rho: Optional[np.ndarray] = None  # (G,) dosage indicator (model3 only)
    phi: Optional[np.ndarray] = None  # (G,) NB dispersion (model3 only)


def simulate_model3(
    N: int = 500,
    G: int = 200,
    C: int = 3,
    seed: int = 2345234,
    max_copy_number: Optional[int] = None,
    sampler: str = "nb",
) -> SyntheticData:
    """Negative-binomial clone mixture (reference inst/create_model3_synthetic.R:3-29).

    rho_g ~ Bernoulli(0.9/1.1)    (R: sample(c(0,1), prob=c(0.2, 0.9)))
    pi_n  ~ Uniform{1..C}
    mu_g  ~ U(1, 2); beta_g = mu_g; phi_g ~ Gamma(4, 1)
    L_gc  ~ Uniform{1..max_cn}; Lp = L / colMeans(L)
    s_n   ~ U(500, 10000)
    y_ng  ~ NB(mean = s_n((1-rho_g) mu_g + rho_g beta_g Lp[g, pi_n]), size = phi_g)

    ``sampler``: ``"nb"`` (default) draws through numpy's
    ``negative_binomial`` — bit-stable for the pinned-seed tests but
    ~0.4M draws/s with per-element parameters; ``"mixture"`` draws the
    exact gamma-Poisson mixture representation
    (NB(mean m, size phi) == Poisson(Gamma(shape=phi, scale=m/phi))),
    the identical distribution at ~10x the rate — use it for
    benchmark-scale N*G (different realized values for the same seed).
    """
    rng = np.random.default_rng(seed)
    max_cn = C if max_copy_number is None else max_copy_number

    rho = rng.choice([0, 1], G, p=[0.2 / 1.1, 0.9 / 1.1])
    pi = rng.integers(0, C, N)
    mu = rng.uniform(1, 2, G)
    beta = mu
    phi = rng.gamma(4, 1, G)

    L = rng.integers(1, max_cn + 1, (G, C)).astype(np.float64)
    Lp = L / L.mean(axis=0, keepdims=True)

    s = rng.uniform(500, 10_000, N)

    m = s[:, None] * ((1 - rho)[None, :] * mu[None, :] + (rho * beta)[None, :] * Lp[:, pi].T)
    if sampler == "mixture":
        lam = rng.gamma(np.broadcast_to(phi[None, :], m.shape), m / phi[None, :])
        Y = rng.poisson(lam).astype(np.float64)
    elif sampler == "nb":
        # NB with mean m, size phi: p = phi / (phi + m)
        p = phi[None, :] / (phi[None, :] + m)
        Y = rng.negative_binomial(np.broadcast_to(phi[None, :], m.shape), p).astype(np.float64)
    else:
        raise ValueError(f"sampler must be 'nb' or 'mixture'; got {sampler!r}")

    return SyntheticData(
        Y=Y, L=L, L_normalized=Lp, clone_idx=pi, mu=mu, s=s, rho=rho, phi=phi
    )


def simulate_multinomial(
    N: int = 500,
    G: int = 200,
    C: int = 3,
    K: int = 1,
    seed: int = 0,
    mean_total: float = 2000.0,
    clone_probs=None,
    latent_scale: float = 0.1,
) -> SyntheticData:
    """Draw from the v2 clonealign model itself
    (vignettes/introduction_to_clonealign.Rmd:51-59): expected counts
    proportional to mu_g * L[g, z_n] * exp(psi_n . w_g), multinomial given
    per-cell totals. ``clone_probs`` optionally skews the ground-truth clone
    prevalences (default uniform) — used by the parameter-recovery study.
    ``latent_scale`` is the sd of the gene loadings w (K > 0): larger values
    make the per-cell factor compete with the clone signal — used to stress
    the serving path's psi refinement."""
    rng = np.random.default_rng(seed)

    if clone_probs is None:
        pi = rng.integers(0, C, N)
    else:
        clone_probs = np.asarray(clone_probs, np.float64)
        if clone_probs.shape != (C,):
            raise ValueError(f"clone_probs must have shape ({C},)")
        pi = rng.choice(C, size=N, p=clone_probs / clone_probs.sum())
    mu = rng.lognormal(0.0, 0.5, G)
    L = rng.integers(1, 5, (G, C)).astype(np.float64)
    if K > 0:
        w = rng.normal(0, latent_scale, (G, K))
        psi = rng.normal(0, 1, (N, K))
        rfe = np.exp(psi @ w.T)
    else:
        rfe = np.ones((N, G))
    s = rng.poisson(mean_total, N).astype(np.float64) + 1

    rates = mu[None, :] * L[:, pi].T * rfe  # (N, G)
    probs = rates / rates.sum(axis=1, keepdims=True)
    Y = np.stack([rng.multinomial(int(s[n]), probs[n]) for n in range(N)]).astype(
        np.float64
    )

    return SyntheticData(
        Y=Y, L=L, L_normalized=L / L.mean(axis=0, keepdims=True),
        clone_idx=pi, mu=mu, s=s,
    )


def assignment_accuracy(fit_clones, clone_names, true_idx) -> float:
    """Fraction of *assigned* cells whose called clone matches ground truth."""
    name_to_idx = {str(c): i for i, c in enumerate(clone_names)}
    called = np.asarray([name_to_idx.get(str(c), -1) for c in fit_clones])
    mask = called >= 0
    if not mask.any():
        return 0.0
    return float((called[mask] == np.asarray(true_idx)[mask]).mean())

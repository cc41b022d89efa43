"""clonealign_torch.models.multinomial against clonealign_tpu's, in float64.

Both packages get the same numpy inputs; parameters made by the JAX package
cross over through ``clonealign_torch.convert`` and every Monte Carlo draw
is the one JAX's key produces, so the two compute on identical state.

Tolerance: rtol 1e-10 (atol 1e-10) for values, rtol 1e-9 (atol 1e-8) for
gradients, 1e-8 for PCA scores (QR and SVD in another LAPACK order). Both
sides are float64 and differ only in summation order (float64 rounding over
<=20,000-term sums is ~1e-12 relative); a wrong term or sign shows at 1e-3
and above.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clonealign_tpu.models import multinomial as jmm
from clonealign_torch import convert
from clonealign_torch.models import multinomial as tmm

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLE_SCE = REPO / "data" / "example_sce.npz"

TOL = dict(rtol=1e-10, atol=1e-10)
F64 = torch.float64


class _Draws:
    """A noise source that returns the arrays it was given, by name."""

    def __init__(self, **draws):
        self.draws = {k: list(v) for k, v in draws.items()}

    def normal(self, what, shape, dtype, device):
        out = torch.tensor(np.asarray(self.draws[what].pop(0)), dtype=dtype, device=device)
        assert tuple(out.shape) == tuple(shape), (what, out.shape, shape)
        return out


def _example():
    z = np.load(EXAMPLE_SCE)
    return z["counts"].astype(np.float64), z["copy_number"].astype(np.float64)


def _impossible_toy():
    """Cell 4 expresses gene 2, whose copy number is 0 in clone 0 only."""
    rng = np.random.default_rng(0)
    N, G, C = 30, 12, 3
    L = rng.integers(1, 4, size=(G, C)).astype(np.float64)
    z = rng.integers(0, C, size=N)
    Y = rng.poisson(L[:, z].T * 3.0).astype(np.float64)
    Y[Y.sum(axis=1) == 0, 0] = 1
    L[2, 0] = 0.0
    Y[:, 2] = 0
    Y[4, 2] = 3
    return Y, L


def _jax_state(Y, L, seed):
    """JAX data, random JAX params (so no gradient is trivially zero), and
    the port's copies of both."""
    rng = np.random.default_rng(seed)
    N, G = Y.shape
    C = L.shape[1]
    p = jmm.CloneAlignParams(
        W=jnp.asarray(rng.normal(0, 0.1, (G, 1))),
        chi_unconstr=jnp.asarray(rng.normal(0, 0.3, (1,))),
        psi=jnp.asarray(rng.normal(0, 1, (N, 1))),
        beta=jnp.zeros((G, 0)),
        alpha_unconstr=jnp.asarray(rng.normal(0, 0.5, (C,))),
        qmu_loc=jnp.asarray(rng.normal(0.5, 0.5, (G,))),
        qmu_log_scale=jnp.asarray(rng.normal(-1, 0.2, (G,))),
        gamma_logits=jnp.asarray(rng.normal(0, 2, (N, C))),
    )
    data = jmm.prepare_data(Y, L, dtype=jnp.float64)
    return data, p, tmm.prepare_data(Y, L, device="cpu", dtype=F64), convert.params_from_numpy(p, "cpu", F64)


_jax_log_p_y_on_c = jax.jit(jmm.log_p_y_on_c)
_jax_elbo_value_and_grad = jax.jit(jax.value_and_grad(jmm.elbo), static_argnums=3)
_jax_warm_start = jax.jit(jmm.gamma_warm_start_logits, static_argnums=(3, 4))


@pytest.mark.parametrize("which", ["example", "impossible"])
def test_prepare_data_statistics(which):
    Y, L = _example() if which == "example" else _impossible_toy()
    jd = jmm.prepare_data(Y, L, dtype=jnp.float64)
    td = tmm.prepare_data(Y, L, device="cpu", dtype=F64)
    for name in ("s", "log_binom", "YlogL", "colsum_Y"):
        np.testing.assert_allclose(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                   err_msg=name, **TOL)
    if which == "impossible":
        assert np.isneginf(td.YlogL[4, 0].item())


def test_pca_scores_match_up_to_sign():
    Y, _ = _example()
    key = jax.random.PRNGKey(3)
    want = np.asarray(jmm.pca_init_scores(Y, 1, key, jnp.float64))
    k_eff = min(1 + 8, *Y.shape)
    omega = np.asarray(jax.random.normal(key, (Y.shape[1], k_eff), jnp.float64))
    got = tmm.pca_init_scores(torch.from_numpy(Y), 1, _Draws(pca_omega=[omega]), F64).numpy()
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, rtol=1e-8, atol=1e-8)


def test_mu_guess_and_init_params():
    Y, L = _example()
    np.testing.assert_allclose(
        tmm.data_mu_guess(torch.from_numpy(Y), F64).numpy(),
        np.asarray(jmm.data_mu_guess(Y, jnp.float64)), **TOL,
    )
    # init_params from shared PCA scores and a shared jitter draw
    key = jax.random.PRNGKey(4)
    _, k_jitter = jax.random.split(key)
    pcs = np.asarray(jmm.pca_init_scores(Y, 1, key, jnp.float64))
    want = jmm.init_params(Y, L, key, K=1, dtype=jnp.float64, pca_scores=pcs)
    jitter = np.asarray(jax.random.normal(k_jitter, pcs.shape, jnp.float64))
    got = tmm.init_params(torch.from_numpy(Y), torch.from_numpy(L), _Draws(psi_jitter=[jitter]),
                          K=1, dtype=F64, pca_scores=torch.from_numpy(pcs))
    for name in ("W", "chi_unconstr", "psi", "alpha_unconstr", "qmu_loc", "qmu_log_scale",
                 "gamma_logits"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("x", [-40.0, -3.0, 0.0, 0.5, 19.0, 25.0, 60.0])
def test_softplus_is_exact_past_torch_threshold(x):
    got = tmm.softplus(torch.tensor([x], dtype=F64)).item()
    assert got == pytest.approx(float(jax.nn.softplus(jnp.float64(x))), rel=1e-15, abs=1e-300)


@pytest.mark.parametrize("which", ["example", "impossible"])
def test_log_p_y_on_c(which):
    Y, L = _example() if which == "example" else _impossible_toy()
    jd, jp, td, tp = _jax_state(Y, L, seed=5)
    mu_base = np.asarray(jp.qmu_loc)[None] + 0.3 * np.random.default_rng(1).normal(size=(2, Y.shape[1]))
    want = np.asarray(_jax_log_p_y_on_c(jp, jd, jnp.asarray(mu_base)))
    got = tmm.log_p_y_on_c(tp, td, torch.from_numpy(mu_base)).numpy()
    assert got.shape == want.shape == (2, L.shape[1], Y.shape[0])
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **TOL)


@pytest.mark.parametrize("which,fix_alpha,S", [("example", False, 1), ("example", True, 2),
                                               ("impossible", False, 1)])
def test_elbo_value_and_gradients(which, fix_alpha, S):
    Y, L = _example() if which == "example" else _impossible_toy()
    jd, jp, td, tp = _jax_state(Y, L, seed=6)
    if which == "impossible":
        # the warm start pins the impossible clone; the ELBO masks it
        jp = jp._replace(gamma_logits=jp.gamma_logits.at[4, 0].set(-1e30))
        tp = convert.params_from_numpy(jp, "cpu", F64)
    config = jmm.ModelConfig(K=1, P=0, mc_samples=S, fix_alpha=fix_alpha, likelihood_impl="xla")
    key = jax.random.PRNGKey(7)
    value, grads = _jax_elbo_value_and_grad(jp, jd, key, config)
    eps = np.asarray(jax.random.normal(key, (S, Y.shape[1]), jnp.float64))

    leaves = [t.clone().requires_grad_(True) for t in tp.tensors()]
    elbo = tmm.elbo(tmm.CloneAlignParams(*leaves), td, torch.from_numpy(eps),
                    tmm.ModelConfig(K=1, mc_samples=S, fix_alpha=fix_alpha))
    got = torch.autograd.grad(elbo, leaves, allow_unused=True)
    assert np.isfinite(float(value))
    np.testing.assert_allclose(elbo.item(), float(value), **TOL)
    for name, g in zip(("W", "chi_unconstr", "psi", "alpha_unconstr", "qmu_loc",
                        "qmu_log_scale", "gamma_logits"), got):
        g = np.zeros(getattr(tp, name).shape) if g is None else g.numpy()
        want = np.asarray(getattr(grads, name))
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, want, err_msg=name, rtol=1e-9, atol=1e-8)


@pytest.mark.parametrize("shrink", [0.0, 5.0, 10.0])
def test_warm_start_logits_pin_impossible_clones(shrink):
    Y, L = _impossible_toy()
    jd, jp, td, tp = _jax_state(Y, L, seed=8)
    config = jmm.ModelConfig(K=1, P=0, mc_samples=1, likelihood_impl="xla")
    key = jax.random.PRNGKey(9)
    want = np.asarray(_jax_warm_start(jp, jd, key, config, shrink))
    eps = np.asarray(jax.random.normal(key, (1, Y.shape[1]), jnp.float64))
    got = tmm.gamma_warm_start_logits(tp, td, torch.from_numpy(eps), shrink).numpy()
    assert got[4, 0] == want[4, 0] == -1e30
    assert (got == -1e30).sum() == (want == -1e30).sum() == 1
    np.testing.assert_allclose(got, want, **TOL)

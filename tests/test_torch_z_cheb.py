"""likelihood_impl="z_cheb" in clonealign_torch against clonealign_tpu's, in
float64: the Chebyshev evaluation and its residual-free backward, the
log-normalizer, the ELBO, the fit loop, and how "auto" resolves.

Tolerances: rtol 1e-10 where both sides compute the same float64 formula
(they differ only in summation order); rtol 1e-9 against the exact log Z at
degree 32 (the reference's own bar, tests/test_z_cheb.py); the loop bars of
test_torch_infer.py's test_loop_matches_jax.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_infer import JaxKeySchedule

import clonealign_torch as ct
from clonealign_tpu import infer as jinfer
from clonealign_tpu.models import multinomial as jmm
from clonealign_torch import api as tapi
from clonealign_torch import convert
from clonealign_torch import infer as tinfer
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.synth import simulate_multinomial

torch.set_num_threads(2)

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-10)
NAMES = ("W", "chi_unconstr", "psi", "alpha_unconstr", "qmu_loc", "qmu_log_scale", "gamma_logits")


@pytest.fixture(scope="module")
def state():
    """A 400 x 150 x 4 problem with psi and W spread, so the normalizer
    varies across cells (the reference test's setup)."""
    sim = simulate_multinomial(N=400, G=150, C=4, K=1, seed=2, mean_total=1500)
    rng = np.random.default_rng(3)
    N, G, C = 400, 150, 4
    jp = jmm.CloneAlignParams(
        W=jnp.asarray(rng.normal(0, 0.3, (G, 1))),
        chi_unconstr=jnp.asarray(rng.normal(0, 0.3, (1,))),
        psi=jnp.asarray(rng.normal(0, 2.0, (N, 1))),
        beta=jnp.zeros((G, 0)),
        alpha_unconstr=jnp.asarray(rng.normal(0, 0.5, (C,))),
        qmu_loc=jnp.asarray(rng.normal(0.5, 0.5, (G,))),
        qmu_log_scale=jnp.asarray(rng.normal(-1, 0.2, (G,))),
        gamma_logits=jnp.asarray(rng.normal(0, 2, (N, C))),
    )
    jd = jmm.prepare_data(sim.Y, sim.L, dtype=jnp.float64)
    td = tmm.prepare_data(sim.Y, sim.L, device="cpu", dtype=F64)
    return jd, jp, td, convert.params_from_numpy(jp, "cpu", F64)


@pytest.mark.parametrize("lead", [(), (3,)])
def test_cheb_eval_gradients_match_autograd_through_clenshaw(lead):
    rng = np.random.default_rng(0)
    coef = torch.tensor(rng.normal(size=(*lead, 2, 3, 17)), dtype=F64)
    x = torch.tensor(rng.uniform(-1, 1, size=(*lead, 30)), dtype=F64)
    cot = torch.tensor(rng.normal(size=(*lead, 2, 3, 30)), dtype=F64)

    def grads(fn):
        c, xx = coef.clone().requires_grad_(True), x.clone().requires_grad_(True)
        value = fn(c, xx)
        return (value, *torch.autograd.grad(torch.sum(cot * value), (c, xx)))

    got, want = grads(tmm.cheb_eval), grads(tmm._clenshaw)
    for g, w, name in zip(got, want, ("value", "dcoef", "dx")):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), err_msg=name,
                                   rtol=1e-10, atol=1e-12)


def test_cheb_eval_saves_only_coef_and_x():
    coef = torch.randn(1, 2, 9, dtype=F64, requires_grad=True)
    x = torch.rand(5, dtype=F64, requires_grad=True)
    out = tmm.cheb_eval(coef, x)
    assert len(out.grad_fn.saved_tensors) == 2
    assert {t.shape for t in out.grad_fn.saved_tensors} == {coef.shape, x.shape}


@pytest.mark.parametrize("degree", [16, 32])
def test_logZ_cheb_matches_jax_and_the_exact_normalizer(state, degree):
    jd, jp, td, tp = state
    mu = np.abs(np.random.default_rng(4).normal(size=(2, 150))) + 0.3
    want = np.asarray(jmm._compute_logZ_cheb(jp, jd, jnp.asarray(mu), degree))
    got = tmm._compute_logZ_cheb(tp, td, torch.tensor(mu), degree).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    if degree == 32:
        exact = tmm._likelihood_terms(tp, td, torch.tensor(mu), None, tmm.ModelConfig(K=1))[2]
        np.testing.assert_allclose(got, exact.numpy(), rtol=1e-9)


def test_logZ_cheb_lanes_are_the_lanes_alone(state):
    _, _, td, tp = state
    rng = np.random.default_rng(5)
    mus = torch.tensor(np.abs(rng.normal(size=(3, 1, 150))) + 0.3)
    lanes = tinfer.stack_lanes([tp.replace(psi=tp.psi * s) for s in (0.5, 1.0, 1.5)])
    got = tmm._compute_logZ_cheb(lanes, td, mus, 16)
    for r, s in enumerate((0.5, 1.0, 1.5)):
        want = tmm._compute_logZ_cheb(tp.replace(psi=tp.psi * s), td, mus[r], 16)
        np.testing.assert_allclose(got[r].numpy(), want.numpy(), **TOL)


_jax_elbo_value_and_grad = jax.jit(jax.value_and_grad(jmm.elbo), static_argnums=3)


def test_z_cheb_elbo_and_gradients_match_jax(state):
    jd, jp, td, tp = state
    key = jax.random.PRNGKey(7)
    value, grads = _jax_elbo_value_and_grad(
        jp, jd, key, jmm.ModelConfig(K=1, P=0, mc_samples=1, likelihood_impl="z_cheb"))
    eps = torch.tensor(np.asarray(jax.random.normal(key, (1, 150), jnp.float64)))
    leaves = [t.clone().requires_grad_(True) for t in tp.tensors()]
    elbo = tmm.elbo(tmm.CloneAlignParams(*leaves), td, eps,
                    tmm.ModelConfig(K=1, likelihood_impl="z_cheb"))
    np.testing.assert_allclose(elbo.item(), float(value), **TOL)
    # beta (G, 0) without covariates is not in the graph
    for name, g in zip(NAMES, torch.autograd.grad(elbo, leaves, allow_unused=True)):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(grads, name)), err_msg=name,
                                   rtol=1e-9, atol=1e-8)


def test_z_cheb_loop_matches_jax_and_reports_the_exact_elbo():
    sim = simulate_multinomial(N=200, G=80, C=3, seed=6, mean_total=800)
    k_init, k_fit = jax.random.split(jax.random.PRNGKey(9))
    params0 = jmm.init_params(sim.Y, sim.L, k_init, K=1, dtype=jnp.float64)
    jdata = jmm.prepare_data(sim.Y, sim.L, dtype=jnp.float64)
    loop = dict(max_iter=60, rel_tol=1e-2, elbo_eval="fresh")
    config = jmm.ModelConfig(K=1, P=0, mc_samples=1, likelihood_impl="z_cheb")
    res = jax.jit(lambda p, k: jinfer.run_inference(p, jdata, k, config, **loop))(params0, k_fit)

    tdata = tmm.prepare_data(sim.Y, sim.L, device="cpu", dtype=F64)
    noise = JaxKeySchedule(k_fit)
    got = tinfer.run_inference(convert.params_from_numpy(params0, "cpu", F64), tdata, noise,
                               tmm.ModelConfig(K=1, likelihood_impl="z_cheb"), **loop)
    n = int(res.n_iters)
    assert got.n_iters == n < loop["max_iter"]
    np.testing.assert_allclose(got.elbo_trace[: n + 1], np.asarray(res.elbo_trace)[: n + 1],
                               rtol=1e-6)
    np.testing.assert_allclose(torch.softmax(got.params.gamma_logits, dim=1).numpy(),
                               np.asarray(jax.nn.softmax(res.params.gamma_logits, axis=1)),
                               atol=1e-5)
    np.testing.assert_allclose(got.final_elbo, float(res.final_elbo), rtol=1e-6)
    # the final ELBO is the exact normalizer's at the same 20 draws
    finals = [jax.random.normal(k, (1, 80), jnp.float64)
              for k in jax.random.split(jax.random.fold_in(noise.kk, 7), 20)]
    exact = [tmm.elbo(got.params, tdata, torch.tensor(np.asarray(e)), tmm.ModelConfig(K=1)).item()
             for e in finals]
    np.testing.assert_allclose(got.final_elbo, np.mean(exact), rtol=1e-12)


@pytest.mark.parametrize("K,S,dtype,n", [
    (1, 1, torch.float32, 999_999),
    (1, 1, torch.float32, 1_000_000),   # the JAX package's gate
    (1, 1, torch.float32, 500_000_000),  # 100,000 x 5,000
    (2, 1, torch.float32, 5_000_000),
    (1, 2, torch.float32, 5_000_000),
    (1, 1, torch.float64, 5_000_000),
])
def test_auto_impl_stays_exact(K, S, dtype, n):
    """On the card z_cheb is the slower single fit at full width, so "auto"
    is the exact likelihood on both sides of the JAX package's 1M-element
    gate and off its corner (api._resolve_auto_impl)."""
    assert tapi._resolve_auto_impl(K, S, dtype, n) == "xla"


def test_setup_resolves_the_likelihood():
    rng = np.random.default_rng(0)
    Y = rng.poisson(1.0, (1000, 1000)).astype(np.int16)
    L = rng.integers(1, 4, (1000, 2)).astype(np.float64)
    kw = dict(verbose=False, device="cpu")
    assert tapi.setup_fit(Y, L, **kw).config.likelihood_impl == "xla"
    assert tapi.setup_fit(Y, L, likelihood_impl="z_cheb", **kw).config.likelihood_impl == "z_cheb"


def test_z_cheb_off_k1_raises():
    sim = simulate_multinomial(N=20, G=10, C=2, seed=1)
    with pytest.raises(ValueError, match="K=1"):
        ct.clonealign(sim.Y, sim.L, K=2, likelihood_impl="z_cheb", device="cpu", verbose=False)
    with pytest.raises(ValueError, match="likelihood_impl"):
        ct.clonealign(sim.Y, sim.L, likelihood_impl="fused", device="cpu", verbose=False)

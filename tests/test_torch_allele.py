"""The allele-specific SNV term (``clone_allele``, ``cov``, ``ref``) in
clonealign_torch against the JAX package, on identical numpy inputs.

The term is a beta-binomial (N, C) clone log-likelihood made once at setup
(``models/allele.py``) and added to every clone log-likelihood of the ELBO
and the warm start. Held here in float64 unless stated: the lgamma form, the
term and its softmax, the input checks, the ELBO and every gradient with
the term (exact and z_cheb), the loop, lanes against the sequential sweep,
``clonealign`` against ``clonealign_tpu.clonealign`` and the saved fit.

Tolerances: the beta-binomial log-pmf is a sum of large lgamma terms that
cancel, and the two packages' lgamma differ by ulps, so it is held at rtol
1e-12 (float64) and 1e-5 (float32) of the sum of its terms' absolute
values; the term itself, a sum of log-probabilities (no cancellation), at
rtol 1e-12. The ELBO, gradients, loop and lanes take the bars of
test_torch_covariates.py: values rtol 1e-10, gradients rtol 1e-9 / atol
1e-8, the loop's ELBO trace rtol 1e-6, lanes rtol 1e-12 with iterations and
labels exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln
from test_torch_infer import JaxKeySchedule

import clonealign_tpu as ca
import clonealign_torch as ct
from clonealign_tpu import infer as jinfer
from clonealign_tpu.models import allele as jal
from clonealign_tpu.models import multinomial as jmm
from clonealign_torch import api as tapi
from clonealign_torch import convert
from clonealign_torch import infer as tinfer
from clonealign_torch import restarts as trestarts
from clonealign_torch.assign import clone_assignment
from clonealign_torch.fit import ClonealignFit
from clonealign_torch.models import allele as tal
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.synth import simulate_multinomial
from clonealign_torch.utils.noise import Noise

torch.set_num_threads(2)

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-10)
GRAD_TOL = dict(rtol=1e-9, atol=1e-8)
NAMES = ("W", "chi_unconstr", "psi", "alpha_unconstr", "qmu_loc", "qmu_log_scale",
         "gamma_logits", "beta")
# loose tolerance, so that lanes stop early and at different iterations
LOOP = dict(max_iter=120, rel_tol=0.02, learning_rate=0.1)
PAIRS = ((0.1, 1.9), (1.9, 0.1), (2.0, 2.0))


def _sim(N=60, G=40, C=3, V=25, seed=0):
    """Counts and copy numbers, and V variants made by the golden oracle's
    recipe (tests/golden/make_tpu_parity_oracle.py): clone copy numbers
    1-3, Poisson(8) coverage, alternative counts binomial at 0.5 where the
    true clone's copy number is 2, else 0.05 or 0.95; ``ref = cov - alt``."""
    sim = simulate_multinomial(N=N, G=G, C=C, seed=seed, mean_total=400)
    rng = np.random.default_rng(seed + 100)
    clone_allele = rng.integers(1, 4, (V, C)).astype(np.float64)
    cov = rng.poisson(8.0, (N, V)).astype(np.float64)
    cn = clone_allele[:, np.asarray(sim.clone_idx)]  # (V, N)
    p = np.where(cn == 2, 0.5, np.where(rng.random(cn.shape) < 0.5, 0.05, 0.95))
    alt = rng.binomial(cov.T.astype(np.int64), p).astype(np.float64)
    return sim.Y, sim.L, dict(clone_allele=clone_allele, cov=cov, ref=cov - alt.T)


def _term(allele, dtype=F64):
    """The (N, C) term from the port's setup, and the JAX package's."""
    N, C = allele["cov"].shape[0], allele["clone_allele"].shape[1]
    got, probs = tapi._setup_allele(**allele, N=N, C=C, dtype=dtype, device=torch.device("cpu"),
                                    verbose=False)
    cov_vn = allele["cov"].T
    want = jal.construct_ai_likelihood(jnp.asarray(allele["clone_allele"]),
                                       jnp.asarray(cov_vn - allele["ref"].T), jnp.asarray(cov_vn))
    return got, probs, np.asarray(want)


def _bb_counts():
    """Coverage and alternative counts with k = 0, k = n and n = 0 among them."""
    rng = np.random.default_rng(0)
    n = rng.poisson(8.0, (40, 30)).astype(np.float64)
    k = rng.binomial(n.astype(np.int64), 0.3).astype(np.float64)
    n[0, :4] = k[0, :4] = 0.0            # n = 0
    k[1, :6] = 0.0                       # k = 0
    k[2, :6] = n[2, :6]                  # k = n
    n[3, :3] = k[3, :3] = 60.0           # large counts: large cancelling terms
    return k, n


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("alpha,beta", PAIRS)
def test_beta_binomial_log_prob_matches_jax(alpha, beta, dtype, rtol):
    k, n = _bb_counts()
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    want = np.asarray(jal.beta_binomial_log_prob(jnp.asarray(k, jd), jnp.asarray(n, jd),
                                                 alpha, beta), np.float64)
    got = tal.beta_binomial_log_prob(torch.tensor(k, dtype=dtype), torch.tensor(n, dtype=dtype),
                                     alpha, beta)
    assert got.dtype == dtype
    got = got.double().numpy()
    # the sum of the terms' absolute values, in float64
    scale = sum(np.abs(gammaln(t)) for t in (n + 1, k + 1, n - k + 1, k + alpha, n - k + beta,
                                               alpha + beta + n))
    scale = scale + abs(gammaln(alpha)) + abs(gammaln(beta)) + abs(gammaln(alpha + beta))
    assert np.all(np.abs(got - want) <= rtol * scale), np.max(np.abs(got - want) / scale)
    # n = 0 is a certain event; k > 0 has some mass
    np.testing.assert_allclose(got[0, :4], 0.0, atol=rtol * scale[0, :4].max())
    assert np.all(got < 1e-6)


def test_ai_likelihood_and_snv_probs_match_jax():
    _, _, allele = _sim(N=70, V=31, seed=3)
    got, probs, want = _term(allele)
    assert got.shape == (70, 3) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(probs, np.asarray(jal.snv_clone_probs(jnp.asarray(want))),
                               rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-12)


@pytest.mark.parametrize("block", [7, 70, 1000])
def test_ai_likelihood_blocks_change_no_value(monkeypatch, block):
    """Blocks of 7 cells (not dividing N = 70), one block, and more cells a
    block than N; from host arrays and from tensors."""
    _, _, allele = _sim(N=70, V=31, seed=3)
    ca_t = torch.tensor(allele["clone_allele"])
    cov_vn = allele["cov"].T
    alt_vn = cov_vn - allele["ref"].T
    whole = tal.construct_ai_likelihood(ca_t, torch.tensor(alt_vn), torch.tensor(cov_vn))
    monkeypatch.setattr(tal, "_BLOCK_ELEMENTS", 31 * block)
    host = tal.construct_ai_likelihood(ca_t, alt_vn, cov_vn)
    dev = tal.construct_ai_likelihood(ca_t, torch.tensor(alt_vn), torch.tensor(cov_vn))
    np.testing.assert_array_equal(host.numpy(), whole.numpy())
    np.testing.assert_array_equal(dev.numpy(), whole.numpy())


def test_ai_likelihood_float32_matches_jax():
    """The fit's compute dtype on the card: float32 terms and products."""
    _, _, allele = _sim(N=70, V=31, seed=3)
    got, probs, _ = _term(allele, torch.float32)
    cov_vn = allele["cov"].T
    want = jal.construct_ai_likelihood(*(jnp.asarray(a, jnp.float32) for a in (
        allele["clone_allele"], cov_vn - allele["ref"].T, cov_vn)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(probs, np.asarray(jal.snv_clone_probs(want)), rtol=1e-3, atol=1e-4)


def _refusal(case):
    V, N, C = 4, 6, 2
    clone_allele, cov, ref = np.ones((V, C)), np.full((N, V), 3.0), np.ones((N, V))
    if case == "clones":
        clone_allele = np.ones((V, 3))
    elif case == "rows":
        cov = np.ones((N + 1, V))
    elif case == "columns":
        ref = np.ones((N, V + 1))
    elif case == "negative":
        cov[2, 1] = -1.0
    elif case == "ref_over_cov":
        ref[1, 3] = 4.0
    return clone_allele, cov, ref, N, C


@pytest.mark.parametrize("case", ["clones", "rows", "columns", "negative", "ref_over_cov"])
def test_sanitize_refuses_as_the_jax_package(case):
    args = _refusal(case)
    with pytest.raises(ValueError) as want:
        jal.sanitize_allele_info(*args)
    with pytest.raises(ValueError) as got:
        tal.sanitize_allele_info(*args)
    assert str(got.value) == str(want.value)
    # and through the entry point, before the fit starts
    clone_allele, cov, ref, N, C = args
    Y, L, _ = _sim(N=N, G=8, C=C)
    with pytest.raises(ValueError) as api:
        tapi.setup_fit(Y, L, clone_allele=clone_allele, cov=cov, ref=ref, device="cpu",
                       verbose=False)
    assert str(api.value) == str(want.value)


def test_missing_allele_input_means_no_term():
    _, _, allele = _sim(N=20, V=5)
    for missing in allele:
        kw = dict(allele, **{missing: None})
        assert tapi._setup_allele(**kw, N=20, C=3, dtype=F64, device=torch.device("cpu"),
                                  verbose=True) == (None, None)


def _random_params(N, G, C, K, seed):
    rng = np.random.default_rng(seed)
    return jmm.CloneAlignParams(
        W=jnp.asarray(rng.normal(0, 0.3, (G, K))),
        chi_unconstr=jnp.asarray(rng.normal(0, 0.3, (K,))),
        psi=jnp.asarray(rng.normal(0, 1, (N, K))),
        beta=jnp.zeros((G, 0)),
        alpha_unconstr=jnp.asarray(rng.normal(0, 0.5, (C,))),
        qmu_loc=jnp.asarray(rng.normal(0.5, 0.5, (G,))),
        qmu_log_scale=jnp.asarray(rng.normal(-1, 0.2, (G,))),
        gamma_logits=jnp.asarray(rng.normal(0, 2, (N, C))),
    )


_jax_elbo_value_and_grad = jax.jit(jax.value_and_grad(jmm.elbo), static_argnums=3)


@pytest.mark.parametrize("K,S,impl", [(1, 1, "xla"), (1, 3, "xla"), (1, 1, "z_cheb")])
def test_elbo_value_and_gradients_with_the_term_match_jax(K, S, impl):
    Y, L, allele = _sim()
    (N, G), C = Y.shape, L.shape[1]
    extra, _, extra_j = _term(allele)
    jp = _random_params(N, G, C, K, seed=S)
    jd = jmm.prepare_data(Y, L, dtype=jnp.float64)
    td = tmm.prepare_data(Y, L, device="cpu", dtype=F64)
    config = jmm.ModelConfig(K=K, mc_samples=S, likelihood_impl=impl)
    key = jax.random.PRNGKey(7)
    value, grads = _jax_elbo_value_and_grad(jp, jd, key, config, jnp.asarray(extra_j))
    without = float(jmm.elbo(jp, jd, key, config))
    eps = np.asarray(jax.random.normal(key, (S, G), jnp.float64))

    leaves = [t.clone().requires_grad_(True)
              for t in convert.params_from_numpy(jp, "cpu", F64).tensors()]
    elbo = tmm.elbo(tmm.CloneAlignParams(*leaves), td, torch.from_numpy(eps),
                    tmm.ModelConfig(K=K, mc_samples=S, likelihood_impl=impl), extra)
    got = torch.autograd.grad(elbo, leaves, allow_unused=True)
    assert np.isfinite(float(value)) and abs(float(value) - without) > 1.0  # the term counts
    np.testing.assert_allclose(elbo.item(), float(value), **TOL)
    for name, g, leaf in zip(NAMES, got, leaves):
        g = np.zeros(leaf.shape) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(getattr(grads, name)), err_msg=name, **GRAD_TOL)


def test_warm_start_and_log_lik_with_the_term_match_jax():
    Y, L, allele = _sim()
    (N, G), C = Y.shape, L.shape[1]
    extra, _, extra_j = _term(allele)
    jp = _random_params(N, G, C, 1, seed=4)
    jd = jmm.prepare_data(Y, L, dtype=jnp.float64)
    td = tmm.prepare_data(Y, L, device="cpu", dtype=F64)
    tp = convert.params_from_numpy(jp, "cpu", F64)
    config = jmm.ModelConfig(K=1, mc_samples=2, likelihood_impl="xla")
    tconfig = tmm.ModelConfig(K=1, mc_samples=2)
    key = jax.random.PRNGKey(3)
    eps = torch.from_numpy(np.asarray(jax.random.normal(key, (2, G), jnp.float64)))
    mu_base = jmm.sample_mu_base(jp, key, 2)
    want = jmm.log_p_y_on_c(jp, jd, mu_base, jnp.asarray(extra_j), config)
    got = tmm.log_p_y_on_c(tp, td, tmm.sample_mu_base(tp, eps), tconfig, extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jmm.gamma_warm_start_logits(jp, jd, key, config, 7.0, jnp.asarray(extra_j))
    got = tmm.gamma_warm_start_logits(tp, td, eps, 7.0, tconfig, extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", ["xla", "z_cheb"])
def test_loop_with_the_term_matches_jax(impl):
    """From the JAX package's initial parameters with the JAX key schedule's
    draws: the same iterations and the ELBO trace; under z_cheb the final
    ELBO runs the exact path with the term."""
    Y, L, allele = _sim(N=80, G=50, seed=2)
    extra, _, extra_j = _term(allele)
    k_init, k_fit = jax.random.split(jax.random.PRNGKey(11))
    params0 = jmm.init_params(Y, L, k_init, K=1, dtype=jnp.float64)
    jdata = jmm.prepare_data(Y, L, dtype=jnp.float64)
    config = jmm.ModelConfig(K=1, mc_samples=1, likelihood_impl=impl)
    res = jax.jit(lambda p, d, k, e: jinfer.run_inference(
        p, d, k, config, max_iter=40, rel_tol=0.0, extra_log_lik=e))(
            params0, jdata, k_fit, jnp.asarray(extra_j))

    got = tinfer.run_inference(
        convert.params_from_numpy(params0, "cpu", F64),
        tmm.prepare_data(Y, L, device="cpu", dtype=F64),
        JaxKeySchedule(k_fit), tmm.ModelConfig(K=1, likelihood_impl=impl), max_iter=40,
        rel_tol=0.0, extra_log_lik=extra,
    )
    n = int(res.n_iters)
    assert got.n_iters == n == 40
    np.testing.assert_allclose(got.elbo_trace[: n + 1], np.asarray(res.elbo_trace)[: n + 1],
                               rtol=1e-6)
    np.testing.assert_allclose(torch.softmax(got.params.gamma_logits, dim=1).numpy(),
                               np.asarray(jax.nn.softmax(res.params.gamma_logits, axis=1)),
                               atol=1e-5)
    np.testing.assert_allclose(got.final_elbo, float(res.final_elbo), rtol=1e-6)


def _port_lanes(Y, L, R, seed=0):
    data = tmm.prepare_data(Y, L, device="cpu", dtype=F64)
    noises = [Noise(seed + r, "cpu") for r in range(R)]
    pca = tmm.pca_init_scores(data.Y, 1, noises[0], F64)
    mu = tmm.data_mu_guess(data.Y, F64)
    params = [tmm.init_params(data.Y, data.L, n, K=1, dtype=F64, pca_scores=pca, mu_guess=mu)
              for n in noises]
    return data, params, noises


def test_lanes_with_the_term_equal_the_sequential_sweep():
    Y, L, allele = _sim(N=50, G=40, C=2, V=15)
    extra, _, _ = _term(allele)
    R, shrinks = 4, [0.0, 5.0, 10.0, 5.0]
    config = tmm.ModelConfig(K=1)
    data, params, noises = _port_lanes(Y, L, R)
    lanes = tinfer.run_inference_lanes(tinfer.stack_lanes(params), data, noises, config,
                                       initial_shrinks=shrinks, extra_log_lik=extra, **LOOP)
    data, params, noises = _port_lanes(Y, L, R)
    singles = [tinfer.run_inference(p, data, n, config, initial_shrink=s, extra_log_lik=extra,
                                    **LOOP)
               for p, n, s in zip(params, noises, shrinks)]
    iters = [one.n_iters for one in singles]
    assert len(set(iters)) >= 2 and max(iters) < LOOP["max_iter"], iters
    names = ["c0", "c1"]
    for r, one in enumerate(singles):
        assert int(lanes.n_iters[r]) == one.n_iters
        tb, ts = lanes.elbo_trace[r], one.elbo_trace
        np.testing.assert_array_equal(np.isnan(tb), np.isnan(ts))
        np.testing.assert_allclose(tb[~np.isnan(tb)], ts[~np.isnan(ts)], rtol=1e-12)
        np.testing.assert_allclose(lanes.final_elbo[r], one.final_elbo, rtol=1e-12)
        assert clone_assignment(torch.softmax(lanes.params.gamma_logits[r], -1).numpy(), names) \
            == clone_assignment(torch.softmax(one.params.gamma_logits, -1).numpy(), names)


def test_run_clonealign_with_the_term_lanes_equal_map():
    Y, L, allele = _sim(N=50, G=40, C=2, V=15)
    kw = dict(initial_shrinks=(0, 5), n_repeats=2, seed=2, device="cpu", dtype="float64",
              print_elbos=False, verbose=False, **allele, **LOOP)
    seq = ct.run_clonealign(Y, L, restart_batching="map", **kw)
    got = ct.run_clonealign(Y, L, restart_batching="vmap", **kw)
    assert got.timings["iterations"] == seq.timings["iterations"]
    np.testing.assert_allclose(got.multirun_info["elbos"], seq.multirun_info["elbos"], rtol=1e-12)
    assert got.clone == seq.clone
    np.testing.assert_array_equal(got.clone_probs_from_snv, seq.clone_probs_from_snv)
    assert got.clone_probs_from_snv.shape == (50, 2)


def test_clonealign_with_allele_data_matches_jax(tmp_path):
    """K = 0, so that the fit draws only the loop's noise, which the port
    replays from the JAX package's key: the same iterations, final ELBO,
    labels and SNV clone probabilities. A gene without counts is filtered
    (the term is per cell, untouched). The fit saves and loads the SNV
    probabilities."""
    Y, L, allele = _sim(N=80, G=50, seed=8)
    Y = Y.copy()
    Y[:, 7] = 0
    kw = dict(K=0, max_iter=60, dtype="float64", verbose=False, **allele)
    want = ca.clonealign(Y, L, seed=3, **kw)
    k_fit = jax.random.split(jax.random.PRNGKey(3))[1]
    got = ct.clonealign(Y, L, noise=JaxKeySchedule(k_fit), device="cpu", **kw)
    assert got.convergence_info.n_iters == want.convergence_info.n_iters
    np.testing.assert_allclose(got.convergence_info.elbo, want.convergence_info.elbo, rtol=1e-6)
    np.testing.assert_allclose(got.convergence_info.final_elbo,
                               want.convergence_info.final_elbo, rtol=1e-6)
    assert got.clone == want.clone
    np.testing.assert_allclose(got.clone_probs_from_snv, want.clone_probs_from_snv,
                               rtol=1e-12, atol=1e-300)
    back = ClonealignFit.load(got.save(str(tmp_path / "fit")))
    np.testing.assert_array_equal(back.clone_probs_from_snv, got.clone_probs_from_snv)
    no_snv = ClonealignFit.load(ct.clonealign(Y, L, device="cpu", max_iter=3, verbose=False)
                                .save(str(tmp_path / "plain")))
    assert no_snv.clone_probs_from_snv is None


def test_allele_fit_under_z_cheb_runs_and_reports_the_exact_elbo():
    """The z_cheb gate (K = 1, P = 0) does not refuse allele data."""
    Y, L, allele = _sim(N=60, G=40, seed=5)
    kw = dict(max_iter=15, seed=1, device="cpu", verbose=False, **allele)
    cheb = ct.clonealign(Y, L, likelihood_impl="z_cheb", **kw)
    exact = ct.clonealign(Y, L, likelihood_impl="xla", **kw)
    assert np.isfinite(cheb.convergence_info.elbo).all()
    assert cheb.clone_probs_from_snv is not None
    np.testing.assert_allclose(cheb.convergence_info.final_elbo,
                               exact.convergence_info.final_elbo, rtol=1e-3)


def test_sweep_bytes_count_one_shared_allele_term():
    N, G, C, R = 100_000, 5_000, 10, 10
    base = dict(N=N, G=G, C=C, K=1, S=1, itemsize=4, device_type="cuda", y_itemsize=1)
    plain = trestarts._sweep_bytes(n_lanes=R, **base)
    assert trestarts._sweep_bytes(n_lanes=R, allele=True, **base) - plain == 4 * N * C
    one = trestarts._sweep_bytes(n_lanes=1, allele=True, **base)
    assert trestarts._sweep_bytes(n_lanes=2, allele=True, **base) - one \
        == trestarts._sweep_bytes(n_lanes=2, **base) - trestarts._sweep_bytes(n_lanes=1, **base)

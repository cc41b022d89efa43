"""clonealign_torch.models.negbin against clonealign_tpu.models.negbin: the
legacy v1 negative-binomial family on identical numpy inputs, in float64
on the CPU, with every blocked pass over Y run in several row blocks
(``_BLOCK_ELEMENTS`` and ``models/multinomial._CHUNK_ELEMENTS`` patched
small).

Tolerances. The objectives, accumulators and gradients: rtol 1e-10 of
each array's largest entry (their entries are sums whose terms cancel, so
a small entry carries the rounding of its big terms); the log phi gradient
~10 ulps of its largest term (``_phi_grad_atol``); probabilities (softmax
and sigmoid of such sums) absolutely, within 1e-10 (1e-11 in serving). The Chebyshev
statistics: the histogram exactly. The optax-form Adam against optax over
12 steps: rtol 1e-12. The EM loops over 10 iterations are compared from a
JAX run carried across mid-trajectory: from the moment initialization the
first Adam steps are sign steps on gradients near zero, where rounding in
the last place decides their sign (the JAX package's own trajectory
departs at the first iteration when the size factors change in the last
place), so a fresh run is held to JAX on its first ELBO (rtol 1e-10) and
to the golden pin's bar. Carried across, the parameters
and posteriors agree within rtol 1e-8; the exact loop's ELBO trace within
rtol 1e-7 (measured 2.9e-8: the lambda penalty sum_g (mu_g - beta_g
l_g)^2 moves by ~1e5 per unit of log mu at mu ~ 5e3, so 1e-10 in the
parameters is ~1e-3 in the ELBO); the Chebyshev loop's within 1e-10.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import scipy.stats
import torch

import clonealign_torch as ct
from clonealign_torch import convert
from clonealign_torch.infer import OptaxAdam
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.models import negbin as tn
from clonealign_torch.synth import simulate_model3
from clonealign_tpu.models import negbin as jn

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64
# the JAX package's golden pin (tests/test_negbin.py:325-344): the ELBO of
# simulate_model3(N=100, G=60, C=3, seed=99) at iteration 0 and after 30
PIN = (-56595.67761509307, -56266.79825854022)


def _phi_grad_atol(tp, N):
    """The log phi gradient's entries are differences of N-fold sums of
    phi psi(y + phi) and N phi (log phi + 1), terms of ~1e7 where the moment
    initialization puts phi at its cap of 1e4 (Poisson counts), so their
    float64 rounding reaches ~1e-8 in either package. The tolerance is
    2e-15 of the largest such term: ~10 ulps."""
    phi = torch.exp(tp.log_phi)
    return 2e-15 * N * float(torch.max(phi * (torch.log(phi).abs() + 1)))


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    """Several row blocks in every pass over Y (N = 100: blocks of 23 rows)."""
    monkeypatch.setattr(tn, "_BLOCK_ELEMENTS", 23 * 60)
    monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 31 * 60)


def _random_problem(seed=0, N=120, G=60, C=3, count_scale=1.0):
    """tests/test_negbin_cheb.py's generator: Poisson counts around clone
    profiles with log-normal size factors."""
    rng = np.random.default_rng(seed)
    L = rng.integers(1, 5, (G, C)).astype(float)
    mu = np.exp(rng.normal(0, 0.5, G)) * count_scale
    z = rng.integers(0, C, N)
    s = np.exp(rng.normal(0, 0.6, N))
    rates = s[:, None] * mu[None, :] * (L / L.mean(0)).T[z]
    Y = rng.poisson(rates).astype(float)
    Y[Y.sum(1) == 0, 0] = 1
    return Y, L


def _both(Y, L, s=None):
    return (jn.prepare_negbin_data(Y, L, s=s, dtype=jnp.float64),
            tn.prepare_negbin_data(Y, L, s=s, device="cpu", dtype=F64))


def _point(jd, seed=1):
    """A (params, posterior) point away from any optimum (test_negbin_cheb's
    ``_point``), as JAX tuples and as the port's."""
    G, C = jd.Lp.shape
    N = jd.Y.shape[0]
    params = jn.init_negbin_params(jd, jnp.float64)
    rng = np.random.default_rng(seed)
    params = params._replace(log_mu=params.log_mu + 0.1 * rng.standard_normal(G),
                             log_beta=params.log_beta - 0.05,
                             log_phi=params.log_phi + 0.2)
    gamma = jax.nn.softmax(jnp.asarray(rng.standard_normal((N, C))), axis=1)
    post = jn.NegbinPosterior(gamma=gamma, r=jax.nn.sigmoid(jnp.asarray(rng.standard_normal(G))))
    tparams = convert.negbin_params_from_numpy(params, "cpu", F64)
    tpost = tn.NegbinPosterior(gamma=torch.tensor(np.asarray(post.gamma)),
                               r=torch.tensor(np.asarray(post.r)))
    return params, post, tparams, tpost


def _close(got, want, rtol=1e-10):
    """``got`` within rtol of ``want``'s largest entry, entry by entry."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _grads(fn, p3):
    return jax.grad(fn)(p3)


@pytest.fixture(scope="module")
def golden():
    return simulate_model3(N=100, G=60, C=3, seed=99)  # the golden pin's data


# --- the NB log-pmf, the data and the initialization -----------------------

def test_nb_log_prob_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2000, 500).astype(float)
    mean = rng.uniform(0.5, 3000, 500)
    phi = rng.gamma(4, 1, 500) + 0.05
    got = tn.nb_log_prob(*(torch.tensor(a) for a in (y, mean, phi))).numpy()
    want = np.asarray(jn.nb_log_prob(*(jnp.asarray(a) for a in (y, mean, phi))))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    ref = scipy.stats.nbinom.logpmf(y, phi, phi / (phi + mean))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("form", ["dense", "csr", "noncanonical_csr", "tensor", "given_s"])
def test_prepare_and_init_match_jax(golden, form):
    Y, L = golden.Y, golden.L
    want = jn.prepare_negbin_data(Y, L, dtype=jnp.float64,
                                  s=golden.s / golden.s.mean() if form == "given_s" else None)
    if form == "csr":
        Yin = sp.csr_matrix(Y.astype(np.int32))
    elif form == "noncanonical_csr":
        # every count split into two stored entries at the same (cell, gene):
        # read by the summed counts
        csr = sp.csr_matrix(Y)
        half = np.floor(csr.data / 2)
        data = np.stack([half, csr.data - half], axis=1).ravel()
        Yin = sp.csr_matrix((data, np.repeat(csr.indices, 2), 2 * csr.indptr), shape=Y.shape)
        assert not Yin.has_canonical_format
    elif form == "tensor":
        Yin = torch.tensor(Y)
    else:
        Yin = Y
    got = tn.prepare_negbin_data(Yin, L, device="cpu", dtype=F64,
                                 s=golden.s / golden.s.mean() if form == "given_s" else None)
    for name, a, b in zip(tn.NegbinData._fields, got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, err_msg=name)
    if form == "tensor":  # kept as it is
        assert got.Y.data_ptr() == Yin.data_ptr()
    for name, a, b in zip(tn.NegbinParams._fields, tn.init_negbin_params(got),
                          jn.init_negbin_params(want, jnp.float64)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-15, err_msg=name)


def test_prepare_refusals():
    Y, L = _random_problem(N=30)
    with pytest.raises(ValueError, match="matching G"):
        tn.prepare_negbin_data(Y, L[:-1], device="cpu", dtype=F64)
    Y0 = Y.copy()
    Y0[3] = 0
    with pytest.raises(ValueError, match="nonzero counts"):
        tn.prepare_negbin_data(Y0, L, device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="nonzero counts"):
        tn.prepare_negbin_data(sp.csr_matrix(Y0), L, device="cpu", dtype=F64)


# --- the exact clone scan and its objectives ---------------------------------

def test_accumulators_and_objectives_match_jax():
    Y, L = _random_problem(seed=3)
    jd, td = _both(Y, L)
    jp, jpost, tp, tpost = _point(jd, seed=4)
    jc, tc = jn._nb_constants(jd), tn._nb_constants(td)
    _close(tc.lgamma_y1_sum, jc.lgamma_y1_sum, 1e-13)
    A, B = jn._accumulate(jp, jd, jpost.r, jpost.gamma)
    tA, tB = tn._accumulate(tp, td, tpost.r, tpost.gamma)
    _close(tA, A)
    _close(tB, B)
    _close(tn._accumulate_A(tp, td, tpost.r), jn._accumulate_A(jp, jd, jpost.r))
    _close(tn._llk0_sum(tp, td, tc), jn._llk0_sum(jp, jd, jc))
    _close(tn._llk0_netted_sum(tp, td), jn._llk0_netted_sum(jp, jd))
    _close(tn._llk0(tp, td).sum(), jn._llk0(jp, jd).sum())
    _close(tn._expected_llk(tp, td, tpost, tc), jn._expected_llk(jp, jd, jpost, jc))
    _close(tn._elbo_with_B(tp, td, tpost, tB, 1.0, 0.5),
           jn._elbo_with_B(jp, jd, jpost, B, 1.0, 0.5))
    _close(tn._elbo(tp, td, tpost, 0.7, 0.3), jn._elbo(jp, jd, jpost, 0.7, 0.3))
    _close(tn._elbo_extras(tp, td, tpost, 0.3), jn._elbo_extras(jp, jd, jpost, 0.3))


@pytest.mark.parametrize("lam", [1.0, 0.0])
def test_mstep_objective_and_gradient_match_jax(lam):
    Y, L = _random_problem(seed=5)
    jd, td = _both(Y, L)
    jp, jpost, tp, tpost = _point(jd, seed=6)
    jc, tc = jn._nb_constants(jd), tn._nb_constants(td)

    def obj(p3):
        return jn._mstep_objective(jp._replace(log_mu=p3[0], log_beta=p3[1], log_phi=p3[2]),
                                   jd, jpost, lam, jc)

    p3 = (jp.log_mu, jp.log_beta, jp.log_phi)
    value, grads = tn._mstep_value_and_grad((tp.log_mu, tp.log_beta, tp.log_phi), td, tpost,
                                            lam, tc)
    _close(value, obj(p3))
    _close(tn._mstep_objective(tp, td, tpost, lam, tc), obj(p3))
    for name, g, want in zip(("log_mu", "log_beta", "log_phi"), grads, _grads(obj, p3)):
        if name == "log_phi":
            np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                                       atol=_phi_grad_atol(tp, Y.shape[0]))
        else:
            _close(g, want)
        assert g.shape == (60,), name


# --- the Chebyshev path ----------------------------------------------------------

@pytest.mark.parametrize("count_scale,degree", [(1.0, 12), (3000.0, 12), (1.0, 8)])
def test_cheb_stats_coefficients_and_objective_match_jax(count_scale, degree):
    Y, L = _random_problem(seed=7, count_scale=count_scale)
    jd, td = _both(Y, L)
    js = jn.negbin_cheb_stats(jd, degree=degree)
    ts = tn.negbin_cheb_stats(td, degree=degree)
    if count_scale > 1:  # the tail expansion is engaged
        assert Y.max() > 10_000 and ts.hist.shape[0] == 1024
        assert float(ts.tailT[:, 0].sum()) > 0
    np.testing.assert_array_equal(ts.hist.numpy(), np.asarray(js.hist))
    assert float(ts.hist.sum() + ts.tailT[:, 0].sum()) == Y.size
    for name, a, b in zip(tn.NegbinChebStats._fields, ts, js):
        _close(a, b, 1e-12)
    jp, jpost, tp, tpost = _point(jd, seed=8)
    jcoef = jn._netted_cheb_coeffs(jp, jd, js)
    tcoef = tn._netted_cheb_coeffs(tp, td, ts)
    for name, a, b in zip(tn._NBChebCoeffs._fields, tcoef, jcoef):
        _close(a, b)
    jps, tps = jn._gamma_stats(jd, js, jpost.gamma), tn._gamma_stats(td, ts, tpost.gamma)
    _close(tps.YGT, jps.YGT)
    _close(tps.GT, jps.GT)
    _close(tn._B_from_stats(tcoef, tps), jn._B_from_stats(jcoef, jps))
    _close(tn._estep_A_cheb(td, ts, tcoef, tpost.r), jn._estep_A_cheb(jd, js, jcoef, jpost.r))
    jc, tc = jn._nb_constants(jd), tn._nb_constants(td)
    _close(tn._llk0_sum_cheb(tp, ts, tcoef, tc, Y.shape[0]),
           jn._llk0_sum_cheb(jp, js, jcoef, jc, Y.shape[0]))

    def obj(p3):
        return jn._mstep_objective_cheb(jp._replace(log_mu=p3[0], log_beta=p3[1], log_phi=p3[2]),
                                        jd, js, jps, jpost.r, 1.0, jc)

    p3 = (jp.log_mu, jp.log_beta, jp.log_phi)
    rates = [t.clone().requires_grad_(True) for t in (tp.log_mu, tp.log_beta, tp.log_phi)]
    value = tn._mstep_objective_cheb(tp._replace(log_mu=rates[0], log_beta=rates[1],
                                                 log_phi=rates[2]),
                                     td, ts, tps, tpost.r, 1.0, tc)
    _close(value, obj(p3))
    g_mu, g_beta, g_phi = torch.autograd.grad(value, rates)
    want = _grads(obj, p3)
    _close(g_mu, want[0])
    _close(g_beta, want[1])
    np.testing.assert_allclose(g_phi.numpy(), np.asarray(want[2]), rtol=0,
                               atol=_phi_grad_atol(tp, Y.shape[0]))


def test_cheb_refuses_non_integer_counts():
    Y, L = _random_problem(seed=9)
    td = tn.prepare_negbin_data(Y + 0.5, L, device="cpu", dtype=F64)
    msg = ("likelihood_impl='cheb' requires integer counts (the gammaln(y + phi) histogram is "
           "exact only on integers); use the exact path for non-integer Y")
    with pytest.raises(ValueError) as err:
        tn.negbin_cheb_stats(td)
    assert str(err.value) == msg
    with pytest.raises(ValueError, match="integer counts"):
        ct.inference_em(Y + 0.5, L, verbose=False, likelihood_impl="cheb", device="cpu",
                        dtype="float64")


# --- the optimizer -------------------------------------------------------------

@pytest.mark.parametrize("decay_rate,transition_steps", [(0.4, 500), (1.0, 500), (0.4, 3000)])
def test_optax_form_adam_matches_optax(decay_rate, transition_steps):
    rng = np.random.default_rng(11)
    p0 = [rng.standard_normal(9) for _ in range(3)]
    lr = (0.05 if decay_rate == 1.0 else
          optax.exponential_decay(0.05, transition_steps=transition_steps, decay_rate=decay_rate))
    opt = optax.adam(lr)
    jparams = tuple(jnp.asarray(p) for p in p0)
    jstate = opt.init(jparams)
    topt = OptaxAdam(0.05, transition_steps=transition_steps, decay_rate=decay_rate)
    tparams = [torch.tensor(p) for p in p0]
    tstate = topt.init(tparams)
    for _ in range(12):
        g = [rng.standard_normal(9) * 10 ** rng.uniform(-3, 1) for _ in range(3)]
        updates, jstate = opt.update(tuple(jnp.asarray(x) for x in g), jstate)
        jparams = optax.apply_updates(jparams, updates)
        tparams, tstate = topt.step(tstate, tparams, [torch.tensor(x) for x in g])
    for a, b in zip(tparams, jparams):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    adam, schedule = jstate
    assert tstate.count == int(adam.count) == 12
    assert tstate.schedule_count == (None if decay_rate == 1.0 else int(schedule.count))
    for a, b in zip(tstate.mu + tstate.nu, adam.mu + adam.nu):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    # a state carried across from optax continues the same steps
    carried = convert.negbin_result_from_numpy(
        jn.NegbinResult(params=jn.NegbinParams(*jparams, jnp.zeros(3)),
                        post=jn.NegbinPosterior(jnp.zeros((2, 3)), jnp.zeros(9)),
                        elbo_trace=jnp.zeros(1), n_iter=0, final_elbo=0.0, opt_state=jstate),
        "cpu", F64).opt_state
    g = [torch.tensor(rng.standard_normal(9)) for _ in range(3)]
    a, _ = topt.step(carried, tparams, g)
    b, _ = topt.step(tstate, tparams, g)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# --- the EM loops -----------------------------------------------------------------

def test_golden_pinned_trajectory(golden):
    """The JAX package's golden pin (tests/test_negbin.py:325-344)."""
    data = tn.prepare_negbin_data(golden.Y, golden.L, device="cpu", dtype=F64)
    r = tn.run_negbin_em(data, max_iter=30, rel_tol=0.0)
    np.testing.assert_allclose(r.elbo_trace[0], PIN[0], rtol=1e-9)
    np.testing.assert_allclose(r.final_elbo, PIN[1], rtol=1e-3)
    assert r.n_iter == 30 and r.final_elbo == r.elbo_trace[30]


def test_golden_pin_holds_in_float32(golden):
    """The monitored ELBO (and the E-step's B scan that feeds it) is
    evaluated in float64 element by element, so a float32 fit meets the
    pin's 1e-5 bar at iteration 0; the JAX package's float32 run, whose
    ELBO elements are float32, misses it."""
    data = tn.prepare_negbin_data(golden.Y, golden.L, device="cpu", dtype=torch.float32)
    r = tn.run_negbin_em(data, max_iter=30, rel_tol=0.0)
    assert r.elbo_trace.dtype == np.float32
    assert abs(r.elbo_trace[0] - PIN[0]) < 1e-5 * abs(PIN[0])
    assert abs(r.final_elbo - PIN[1]) < 1e-3 * abs(PIN[1])
    jdata = jn.prepare_negbin_data(golden.Y, golden.L, dtype=jnp.float32)
    j0 = float(jn.run_negbin_em(jdata, max_iter=0, rel_tol=0.0).elbo_trace[0])
    assert abs(j0 - PIN[0]) > 1e-5 * abs(PIN[0])


@pytest.fixture(scope="module")
def jax_runs(golden):
    """JAX runs on the golden data: each loop 10 iterations from the
    moment initialization, then 10 more and 40 more resumed from there."""
    data = jn.prepare_negbin_data(golden.Y, golden.L, dtype=jnp.float64)
    out = {}
    for impl in ("exact", "cheb"):
        stats = jn.negbin_cheb_stats(data) if impl == "cheb" else None
        kw = dict(m_steps=30) if impl == "cheb" else {}
        base = jn.run_negbin_em(data, None, stats, max_iter=10, rel_tol=0.0, **kw)
        cont = jn.run_negbin_em(data, None, stats, max_iter=10, rel_tol=0.0, resume_from=base, **kw)
        stop = jn.run_negbin_em(data, None, stats, max_iter=40, rel_tol=2e-5, resume_from=base,
                                **kw)
        out[impl] = dict(base=base, cont=cont, stop=stop)
    return out


def _port_data(golden, impl):
    data = tn.prepare_negbin_data(golden.Y, golden.L, device="cpu", dtype=F64)
    return data, (tn.negbin_cheb_stats(data) if impl == "cheb" else None)


@pytest.mark.parametrize("impl", ["exact", "cheb"])
def test_fresh_run_starts_as_jax(golden, jax_runs, impl):
    data, stats = _port_data(golden, impl)
    kw = dict(m_steps=30) if impl == "cheb" else {}
    r = tn.run_negbin_em(data, None, stats, max_iter=10, rel_tol=0.0, **kw)
    want = jax_runs[impl]["base"]
    np.testing.assert_allclose(r.elbo_trace[0], float(want.elbo_trace[0]), rtol=1e-10)
    assert r.n_iter == int(want.n_iter) == 10
    assert r.cheb_degree == (None if impl == "exact" else 12)
    assert np.isfinite(r.elbo_trace).all() and np.isfinite(r.final_elbo)
    assert r.opt_state.count == int(want.opt_state[0].count) == 10 * (30 if impl == "cheb" else 5)


@pytest.mark.parametrize("impl", ["exact", "cheb"])
def test_jax_run_carried_across_continues_its_trajectory(golden, jax_runs, impl):
    data, stats = _port_data(golden, impl)
    kw = dict(m_steps=30) if impl == "cheb" else {}
    start = convert.negbin_result_from_numpy(jax_runs[impl]["base"], "cpu", F64)
    got = tn.run_negbin_em(data, None, stats, max_iter=10, rel_tol=0.0, resume_from=start, **kw)
    want = jax_runs[impl]["cont"]
    np.testing.assert_allclose(got.elbo_trace, np.asarray(want.elbo_trace),
                               rtol=1e-7 if impl == "exact" else 1e-10)
    for name, a, b in zip(tn.NegbinParams._fields, got.params, want.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(got.post.gamma.numpy(), np.asarray(want.post.gamma), atol=1e-10)
    np.testing.assert_allclose(got.post.r.numpy(), np.asarray(want.post.r), atol=1e-8)
    np.testing.assert_allclose(got.final_elbo, float(want.final_elbo), rtol=1e-9)
    assert got.n_iter == 10 and got.opt_state.count == int(want.opt_state[0].count)
    assert got.opt_state.schedule_count == int(want.opt_state[1].count)


@pytest.mark.parametrize("impl", ["exact", "cheb"])
def test_stopping_rule_fires_at_the_jax_iteration(golden, jax_runs, impl):
    data, stats = _port_data(golden, impl)
    kw = dict(m_steps=30) if impl == "cheb" else {}
    start = convert.negbin_result_from_numpy(jax_runs[impl]["base"], "cpu", F64)
    got = tn.run_negbin_em(data, None, stats, max_iter=40, rel_tol=2e-5, resume_from=start, **kw)
    want = jax_runs[impl]["stop"]
    assert got.n_iter == int(want.n_iter) < 40
    n = got.n_iter
    assert np.isnan(got.elbo_trace[n + 1:]).all()
    np.testing.assert_allclose(got.elbo_trace[: n + 1], np.asarray(want.elbo_trace)[: n + 1],
                               rtol=1e-7)


@pytest.mark.parametrize("impl", ["exact", "cheb"])
def test_resume_chained_equals_single_run(golden, impl):
    data, stats = _port_data(golden, impl)
    kw = dict(m_steps=10) if impl == "cheb" else {}
    full = tn.run_negbin_em(data, None, stats, max_iter=8, rel_tol=0.0, **kw)
    half = tn.run_negbin_em(data, None, stats, max_iter=4, rel_tol=0.0, **kw)
    cont = tn.run_negbin_em(data, None, stats, max_iter=4, rel_tol=0.0, resume_from=half, **kw)
    for a, b in zip(cont.params, full.params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    np.testing.assert_allclose(cont.post.gamma.numpy(), full.post.gamma.numpy(), atol=1e-12)
    np.testing.assert_allclose(cont.final_elbo, full.final_elbo, rtol=1e-12)
    np.testing.assert_allclose(cont.elbo_trace[0], half.final_elbo if impl == "exact"
                               else half.elbo_trace[4], rtol=1e-12)


def test_resume_refusals(golden):
    data, stats = _port_data(golden, "cheb")
    r_exact = tn.run_negbin_em(data, max_iter=2, rel_tol=0.0)
    r_cheb = tn.run_negbin_em(data, None, stats, max_iter=2, rel_tol=0.0)
    with pytest.raises(ValueError) as err:
        tn.run_negbin_em(data, None, stats, max_iter=2, resume_from=r_exact)
    assert str(err.value) == (
        "resume_from was produced by the exact backend but this call selects cheb (degree "
        "12); resume chunks must keep the same impl (pass the same `stats` argument, or none, "
        "as the original run)")
    with pytest.raises(ValueError, match="cheb \\(degree 12\\) backend but this call selects"):
        tn.run_negbin_em(data, max_iter=2, resume_from=r_cheb)
    with pytest.raises(ValueError, match="degree 8"):
        tn.run_negbin_em(data, None, tn.negbin_cheb_stats(data, degree=8), max_iter=2,
                         resume_from=r_cheb)
    with pytest.raises(ValueError, match="rho_init conflicts with resume_from"):
        tn.run_negbin_em(data, np.full(60, 0.5), max_iter=2, resume_from=r_exact)
    with pytest.raises(ValueError, match="optimizer state"):
        tn.run_negbin_em(data, max_iter=2, resume_from=r_exact._replace(opt_state=None))
    with pytest.raises(ValueError, match="lr_decay_rate must match"):
        tn.run_negbin_em(data, max_iter=2, resume_from=r_exact, lr_decay_rate=1.0)


# --- Gibbs -------------------------------------------------------------------------

class _JaxDraws(tn.GibbsDraws):
    """Replays gibbs_pi_rho's jax.random draws: the initial clones from the
    first split of the key, then per sweep the Gumbel noise and the
    uniforms of that sweep's two keys (jax.random.categorical and
    bernoulli)."""

    def __init__(self, seed, n_iter, N, C, dtype):
        key, k_pi0 = jax.random.split(jax.random.PRNGKey(seed))
        self.pi0 = np.asarray(jax.random.randint(k_pi0, (N,), 0, C))
        self.keys = [jax.random.split(k) for k in jax.random.split(key, n_iter)]
        self.dtype, self.sweep = dtype, 0

    def initial_clones(self, N, C, device):
        return torch.tensor(self.pi0, dtype=torch.int64)

    def gumbel(self, shape, dtype, device):
        return torch.tensor(np.asarray(jax.random.gumbel(self.keys[self.sweep][0], shape,
                                                          self.dtype)))

    def uniform(self, shape, dtype, device):
        u = np.asarray(jax.random.uniform(self.keys[self.sweep][1], shape, self.dtype))
        self.sweep += 1
        return torch.tensor(u)


def test_gibbs_replays_jax_draws(golden):
    Y, L = golden.Y, golden.L
    jdata = jn.prepare_negbin_data(Y, L, dtype=jnp.float64)
    fitted = jn.run_negbin_em(jdata, max_iter=5, rel_tol=0.0).params
    for params in (None, fitted):
        want = jn.gibbs_pi_rho(Y, L, params=params, n_iter=5, seed=3, dtype=jnp.float64)
        got = ct.gibbs_pi_rho(Y, L, params=params, n_iter=5, seed=3, device="cpu",
                              dtype="float64", draws=_JaxDraws(3, 5, 100, 3, jnp.float64))
        np.testing.assert_array_equal(got["pi_trace"], want["pi_trace"])
        np.testing.assert_array_equal(got["rho_trace"], want["rho_trace"])
        assert got["pi_trace"].shape == (5, 100) and got["rho_trace"].shape == (5, 60)
    # the port's own draws: seeded, and every sweep a valid state
    a = ct.gibbs_pi_rho(Y, L, n_iter=3, seed=1, device="cpu", dtype="float64")
    b = ct.gibbs_pi_rho(Y, L, n_iter=3, seed=1, device="cpu", dtype="float64")
    np.testing.assert_array_equal(a["pi_trace"], b["pi_trace"])
    assert set(np.unique(a["rho_trace"])) <= {0.0, 1.0} and a["pi_trace"].max() < 3


def test_gibbs_trace_helpers_match_jax():
    rng = np.random.default_rng(2)
    pi = rng.integers(0, 4, (9, 30))
    rho = (rng.uniform(size=(9, 20)) < 0.3).astype(float)
    for burn in (0, 4):
        np.testing.assert_array_equal(ct.clone_probs_from_gibbs(pi, 4, burn),
                                      jn.clone_probs_from_gibbs(pi, 4, burn))
        np.testing.assert_array_equal(ct.rho_probs_from_gibbs(rho, burn),
                                      jn.rho_probs_from_gibbs(rho, burn))
    with pytest.raises(ValueError, match="pi_trace must be \\(n_iter, N\\) with n_iter > burn_in"):
        ct.clone_probs_from_gibbs(pi, 4, burn_in=9)
    with pytest.raises(ValueError, match="rho_trace must be \\(n_iter, G\\) with n_iter > burn_in"):
        ct.rho_probs_from_gibbs(rho[0])


# --- the fit, serving and the .npz ------------------------------------------------

@pytest.fixture(scope="module")
def fits(golden):
    """JAX v1 fits on the golden data: at the first E-step (max_iter=0) and
    after 30 iterations."""
    return {n: jn.inference_em(golden.Y, golden.L, max_iter=n, rel_tol=0.0, verbose=False,
                               dtype=jnp.float64) for n in (0, 30)}


def test_inference_em_matches_jax(golden, fits, capsys):
    got = ct.inference_em(golden.Y, golden.L, max_iter=0, rel_tol=0.0, device="cpu",
                          dtype="float64")
    assert capsys.readouterr().out == "Optimizing ELBO (v1 negative-binomial family)\n"
    want = fits[0]
    assert got.clone == want.clone and got.clone_names == want.clone_names == ["A", "B", "C"]
    for name in ("clone_probs", "rho_probs"):  # probabilities: absolutely
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0,
                                   atol=1e-10, err_msg=name)
    for name in ("mu", "beta", "phi", "alpha", "elbo_trace"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-10,
                                   err_msg=name)
    assert got.n_iter == want.n_iter == 0
    np.testing.assert_allclose(got.final_elbo, want.final_elbo, rtol=1e-10)
    np.testing.assert_allclose(got.s_mean, want.s_mean, rtol=1e-13)
    assert set(got.timings) == {"setup", "loop"}
    assert repr(got) == repr(want)
    # 30 iterations: the golden pin's bar on the final ELBO, the same calls
    got = ct.inference_em(golden.Y, golden.L, max_iter=30, rel_tol=0.0, verbose=False,
                          device="cpu", dtype="float64")
    np.testing.assert_allclose(got.final_elbo, fits[30].final_elbo, rtol=1e-3)
    assert got.clone == fits[30].clone
    assert (np.argmax(got.clone_probs, 1) == golden.clone_idx).mean() == 1.0


def test_inference_em_options_and_messages(golden, monkeypatch):
    with pytest.raises(ValueError) as err:
        ct.inference_em(golden.Y, golden.L, likelihood_impl="fast", device="cpu")
    assert str(err.value) == "likelihood_impl must be 'exact' or 'cheb', got 'fast'"
    seen = []
    real = tn.run_negbin_em

    def spy(data, rho_init, stats, **kw):
        seen.append((stats is not None, kw["m_steps"], rho_init))
        return real(data, rho_init, stats, **kw)

    monkeypatch.setattr(tn, "run_negbin_em", spy)
    rho = np.linspace(0.1, 0.9, 60)
    for impl in ("exact", "cheb"):
        fit = ct.inference_em(golden.Y, golden.L, max_iter=1, verbose=False, device="cpu",
                              dtype="float64", likelihood_impl=impl, rho_init=rho,
                              clone_names=["x", "y", "z"])
        assert fit.clone_names == ["x", "y", "z"]
    assert [s[:2] for s in seen] == [(False, 5), (True, 30)]
    assert seen[0][2] is rho
    many = ct.inference_em(golden.Y, np.tile(golden.L, (1, 9))[:, :27], max_iter=0,
                           verbose=False, device="cpu", dtype="float64")
    assert many.clone_names == [f"clone_{i}" for i in range(27)]


def test_classify_cells_matches_jax(golden, fits):
    jfit = fits[30]
    tfit = convert.v1_fit_from_numpy(jfit)
    sim = simulate_model3(N=80, G=60, C=3, seed=5)  # other cells, other depth
    Y, L = sim.Y, golden.L
    for s in (None, sim.s / sim.s.mean()):
        want_c, want_p = jn.classify_cells(jfit, Y, L, s=s, dtype=jnp.float64)
        got_c, got_p = tn.classify_cells(tfit, Y, L, s=s, device="cpu", dtype="float64")
        np.testing.assert_allclose(got_p, want_p, rtol=1e-10, atol=1e-11)
        assert got_c == want_c
    # a fit saved before s_mean existed: the batch's own mean
    old = convert.v1_fit_from_numpy(jfit)
    old.s_mean = float("nan")
    jold = convert.v1_fit_from_numpy(jfit)
    jold.s_mean = float("nan")
    np.testing.assert_allclose(tn.classify_cells(old, Y, L, device="cpu", dtype="float64")[1],
                               jn.classify_cells(jold, Y, L, dtype=jnp.float64)[1],
                               rtol=1e-10, atol=1e-11)
    # sparse and tensor input give the dense answer
    dense = tn.classify_cells(tfit, Y, L, device="cpu", dtype="float64")[1]
    for Yin in (sp.csr_matrix(Y), torch.tensor(Y)):
        np.testing.assert_allclose(tn.classify_cells(tfit, Yin, L, device="cpu",
                                                     dtype="float64")[1], dense, rtol=1e-12)
    with pytest.raises(ValueError) as err:
        tn.classify_cells(tfit, Y[:, :50], L[:50], device="cpu", dtype="float64")
    assert str(err.value) == ("fit has 60 genes but Y_new/L have 50; serve over the fit's "
                              "genes, same order")


def test_v1_fit_npz_loads_in_both_packages(golden, fits, tmp_path):
    jfit = fits[30]
    tfit = convert.v1_fit_from_numpy(jfit)
    path = tfit.save(tmp_path / "port")
    assert path.endswith(".npz")
    back = jn.ClonealignV1Fit.load(path)
    path2 = jfit.save(str(tmp_path / "jax.npz"))
    forth = ct.ClonealignV1Fit.load(path2)
    for a in (back, forth):
        assert a.clone == jfit.clone and a.clone_names == jfit.clone_names
        for name in ("clone_probs", "rho_probs", "mu", "beta", "phi", "alpha", "elbo_trace"):
            np.testing.assert_array_equal(getattr(a, name), getattr(jfit, name))
        assert (a.n_iter, a.final_elbo, a.s_mean) == (jfit.n_iter, jfit.final_elbo, jfit.s_mean)
    np.savez(tmp_path / "v2.npz", model="multinomial", clone=np.array(["A"]))
    with pytest.raises(ValueError, match="not a clonealign v1 fit: model tag multinomial"):
        ct.ClonealignV1Fit.load(tmp_path / "v2.npz")
    np.savez(tmp_path / "untagged.npz", clone=np.array(["A"]))
    with pytest.raises(ValueError, match="model tag <absent>"):
        ct.ClonealignV1Fit.load(tmp_path / "untagged.npz")


def test_cuda_without_a_gpu_raises(golden, fits, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Y, L = golden.Y, golden.L
    for call in (lambda: ct.inference_em(Y, L, verbose=False),
                 lambda: ct.gibbs_pi_rho(Y, L),
                 lambda: tn.classify_cells(convert.v1_fit_from_numpy(fits[30]), Y, L),
                 lambda: tn.prepare_negbin_data(Y, L)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_port_runs_with_jax_blocked():
    """The v1 family imports nothing of JAX: with ``jax`` blocked in
    sys.modules, a tiny fit, Gibbs sweep and serving call run."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['clonealign_tpu'] = None\n"
        "import numpy as np, clonealign_torch as ct\n"
        "from clonealign_torch.models import negbin\n"
        "from clonealign_torch import convert\n"
        "from clonealign_torch.synth import simulate_model3\n"
        "sim = simulate_model3(N=40, G=20, C=2, seed=1)\n"
        "fit = ct.inference_em(sim.Y, sim.L, max_iter=2, verbose=False, device='cpu')\n"
        "ct.gibbs_pi_rho(sim.Y, sim.L, n_iter=1, device='cpu')\n"
        "negbin.classify_cells(fit, sim.Y, sim.L, device='cpu')\n"
        "print(sorted(m for m in sys.modules if (m == 'jax' or m.startswith('jax.') "
        "or m.startswith('clonealign_tpu')) and sys.modules[m] is not None))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"

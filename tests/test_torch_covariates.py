"""Covariates (``x``, the coefficients beta) in clonealign_torch against the
JAX package, on identical numpy inputs.

The covariates fold into the fused likelihood by concatenation,
``log_rfe = [psi, X] [W, beta]^T``, so the op runs at Kf = K + P columns.
The model's ELBO, its gradients (beta's included) and the training loop are
held to the JAX package in float64, the model's call of the fused op at
Kf = 3 and 4 to the JAX Pallas kernel (interpret mode) in float32, the
lane-batched sweep to the sequential one, and ``clonealign(x=...)`` to
``clonealign_tpu.clonealign(x=...)`` with the JAX key schedule's draws.

Tolerances are those of the files each test mirrors: values rtol 1e-10,
gradients rtol 1e-9 / atol 1e-8 (test_torch_multinomial.py: float64 sums
in another order); the loop's ELBO trace rtol 1e-6 and gamma atol 1e-5
(test_torch_infer.py: two autodiff systems, Adam amplifying ulp-level
differences); lanes against the sequential sweep rtol 1e-12 with
iterations and labels exact (test_torch_restarts.py); the fused op's values
rtol 2e-5 / atol 1e-4 and VJP rtol 3e-5 / atol 1e-4
(test_torch_fused_likelihood.py: float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_api import _setup_passes_the_contract_on_cuda
from test_torch_infer import JaxKeySchedule

import clonealign_tpu as ca
import clonealign_torch as ct
from clonealign_tpu import infer as jinfer
from clonealign_tpu.models import multinomial as jmm
from clonealign_tpu.ops import fused_likelihood as jfl
from clonealign_torch import api as tapi
from clonealign_torch import convert
from clonealign_torch import infer as tinfer
from clonealign_torch import restarts as trestarts
from clonealign_torch.assign import clone_assignment
from clonealign_torch.fit import ClonealignFit
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.ops import fused_likelihood as tfl
from clonealign_torch.synth import simulate_multinomial
from clonealign_torch.utils.noise import Noise

torch.set_num_threads(2)

F64 = torch.float64
TOL = dict(rtol=1e-10, atol=1e-10)
GRAD_TOL = dict(rtol=1e-9, atol=1e-8)
VALUE_TOL = dict(rtol=2e-5, atol=1e-4)
VJP_TOL = dict(rtol=3e-5, atol=1e-4)
NAMES = ("W", "chi_unconstr", "psi", "alpha_unconstr", "qmu_loc", "qmu_log_scale",
         "gamma_logits", "beta")
# loose tolerance, so that lanes stop early and at different iterations
LOOP = dict(max_iter=120, rel_tol=0.02, learning_rate=0.1)


def _sim(N=60, G=40, C=3, seed=0, P=2):
    """Counts, copy numbers and P covariate columns (a 0/1 batch over halves
    of the cells, then standard normals), all made with numpy."""
    sim = simulate_multinomial(N=N, G=G, C=C, seed=seed, mean_total=400)
    rng = np.random.default_rng(seed + 100)
    cols = [(np.arange(N) >= N // 2).astype(np.float64)]
    cols += [rng.normal(size=N) for _ in range(P - 1)]
    return sim.Y, sim.L, np.stack(cols[:P], axis=1)


def _random_params(N, G, C, K, P, seed):
    """JAX parameters with every leaf random, so no gradient is trivially 0."""
    rng = np.random.default_rng(seed)
    return jmm.CloneAlignParams(
        W=jnp.asarray(rng.normal(0, 0.1, (G, K))),
        chi_unconstr=jnp.asarray(rng.normal(0, 0.3, (K,))),
        psi=jnp.asarray(rng.normal(0, 1, (N, K))),
        beta=jnp.asarray(rng.normal(0, 0.1, (G, P))),
        alpha_unconstr=jnp.asarray(rng.normal(0, 0.5, (C,))),
        qmu_loc=jnp.asarray(rng.normal(0.5, 0.5, (G,))),
        qmu_log_scale=jnp.asarray(rng.normal(-1, 0.2, (G,))),
        gamma_logits=jnp.asarray(rng.normal(0, 2, (N, C))),
    )


_jax_elbo_value_and_grad = jax.jit(jax.value_and_grad(jmm.elbo), static_argnums=3)


@pytest.mark.parametrize("K,P,S,fix_alpha", [(1, 2, 1, False), (0, 1, 1, False),
                                             (2, 2, 3, True)])
def test_elbo_value_and_gradients_match_jax(K, P, S, fix_alpha):
    """(2, 2, 3, True) is the golden oracle's rich configuration: Kf = 4,
    S x C = 9."""
    Y, L, X = _sim(P=P)
    (N, G), C = Y.shape, L.shape[1]
    jp = _random_params(N, G, C, K, P, seed=K + 10 * P)
    jd = jmm.prepare_data(Y, L, x=X, dtype=jnp.float64)
    td = tmm.prepare_data(Y, L, X, device="cpu", dtype=F64)
    config = jmm.ModelConfig(K=K, P=P, mc_samples=S, fix_alpha=fix_alpha, likelihood_impl="xla")
    key = jax.random.PRNGKey(7)
    value, grads = _jax_elbo_value_and_grad(jp, jd, key, config)
    eps = np.asarray(jax.random.normal(key, (S, G), jnp.float64))

    leaves = [t.clone().requires_grad_(True) for t in convert.params_from_numpy(jp, "cpu", F64).tensors()]
    elbo = tmm.elbo(tmm.CloneAlignParams(*leaves), td, torch.from_numpy(eps),
                    tmm.ModelConfig(K=K, P=P, mc_samples=S, fix_alpha=fix_alpha))
    got = torch.autograd.grad(elbo, leaves, allow_unused=True)
    assert np.isfinite(float(value))
    np.testing.assert_allclose(elbo.item(), float(value), **TOL)
    for name, g, leaf in zip(NAMES, got, leaves):
        g = np.zeros(leaf.shape) if g is None else g.numpy()
        want = np.asarray(getattr(grads, name))
        assert g.shape == want.shape and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, want, err_msg=name, **GRAD_TOL)
    assert np.abs(np.asarray(grads.beta)).max() > 1e-3  # beta's gradient is not trivially 0


@pytest.mark.parametrize("K,P,S,C", [(1, 2, 1, 4), (2, 2, 3, 3)])
def test_likelihood_terms_match_the_pallas_kernel(K, P, S, C):
    """The model's call of the fused op at Kf = K + P (float32, the kernels'
    contract) against the JAX Pallas kernel on the concatenated operands,
    values and gradients: psi and W take the first K columns of the op's
    psi_ext and W_ext gradients, beta the last P of W_ext's; X's columns of
    the psi_ext gradient are dropped."""
    Y, L, X = _sim(N=45, G=70, C=C, seed=3, P=P)
    N, G = Y.shape
    p = _random_params(N, G, C, K, P, seed=4)
    rng = np.random.default_rng(5)
    mu = rng.lognormal(0, 0.5, (S, G))
    f32 = np.float32
    muL = (mu[:, None, :] * L.T[None]).transpose(2, 0, 1).reshape(G, S * C)
    psi_ext = np.concatenate([np.asarray(p.psi), X], 1).astype(f32)
    W_ext = np.concatenate([np.asarray(p.W), np.asarray(p.beta)], 1).astype(f32)
    ops = (Y.astype(f32), psi_ext, W_ext, np.log(mu).astype(f32), muL.astype(f32))
    (A1, A2, Z), vjp = jax.vjp(jfl.fused_likelihood_terms, *map(jnp.asarray, ops))
    cot = (rng.normal(0, 1, N).astype(f32), rng.normal(0, 1, (N, S)).astype(f32),
           rng.normal(0, 1, (N, S * C)).astype(f32))
    _, d_psi_ext, d_W_ext, _, _ = vjp(tuple(map(jnp.asarray, cot)))

    data = tmm.prepare_data(Y, L, X, device="cpu", dtype=torch.float32)
    tp = convert.params_from_numpy(p, "cpu", torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (tp.psi, tp.W, tp.beta)]
    params = tp.replace(psi=leaves[0], W=leaves[1], beta=leaves[2])
    mu_t = torch.from_numpy(mu.astype(f32))
    gA1, gA2, glogZ = tmm._likelihood_terms(params, data, mu_t, torch.log(mu_t))
    np.testing.assert_allclose(gA1.detach().numpy(), np.asarray(A1), err_msg="A1", **VALUE_TOL)
    np.testing.assert_allclose(gA2.detach().numpy(), np.asarray(A2), err_msg="A2", **VALUE_TOL)
    # log Z as (S, C, N) from the op's Z (N, S*C)
    want_Z = np.asarray(Z).reshape(N, S, C).transpose(1, 2, 0)
    np.testing.assert_allclose(torch.exp(glogZ).detach().numpy(), want_Z, err_msg="Z",
                               **VALUE_TOL)

    dZ = torch.from_numpy(cot[2]).reshape(N, S, C).permute(1, 2, 0) * torch.exp(glogZ).detach()
    got = torch.autograd.grad((gA1, gA2, glogZ), leaves,
                              grad_outputs=(torch.from_numpy(cot[0]), torch.from_numpy(cot[1]), dZ))
    want = (np.asarray(d_psi_ext)[:, :K], np.asarray(d_W_ext)[:, :K], np.asarray(d_W_ext)[:, K:])
    for name, g, w in zip(("psi", "W", "beta"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **VJP_TOL)


def test_loop_matches_jax():
    """K = 1, P = 2 from the JAX package's initial parameters, with the JAX
    key schedule's draws: the same iterations and the ELBO trace."""
    Y, L, X = _sim(N=80, G=50, seed=2)
    k_init, k_fit = jax.random.split(jax.random.PRNGKey(11))
    params0 = jmm.init_params(Y, L, k_init, K=1, P=2, dtype=jnp.float64)
    assert np.asarray(params0.beta).shape == (50, 2) and not np.asarray(params0.beta).any()
    jdata = jmm.prepare_data(Y, L, x=X, dtype=jnp.float64)
    config = jmm.ModelConfig(K=1, P=2, mc_samples=1, likelihood_impl="xla")
    res = jax.jit(lambda p, d, k: jinfer.run_inference(p, d, k, config, max_iter=40,
                                                        rel_tol=0.0))(params0, jdata, k_fit)

    got = tinfer.run_inference(
        convert.params_from_numpy(params0, "cpu", F64),
        tmm.prepare_data(Y, L, X, device="cpu", dtype=F64),
        JaxKeySchedule(k_fit), tmm.ModelConfig(K=1, P=2), max_iter=40, rel_tol=0.0,
    )
    n = int(res.n_iters)
    assert got.n_iters == n == 40
    np.testing.assert_allclose(got.elbo_trace[: n + 1], np.asarray(res.elbo_trace)[: n + 1],
                               rtol=1e-6)
    np.testing.assert_allclose(torch.softmax(got.params.gamma_logits, dim=1).numpy(),
                               np.asarray(jax.nn.softmax(res.params.gamma_logits, axis=1)),
                               atol=1e-5)
    assert np.abs(got.params.beta.numpy()).max() > 0.01  # beta moved
    np.testing.assert_allclose(got.final_elbo, float(res.final_elbo), rtol=1e-6)


def _port_lanes(Y, L, X, R, seed=0):
    """R lanes as run_clonealign makes them: shared PCA and mu guess, each
    lane's jitter from Noise(seed + r), beta (G, P) each."""
    data = tmm.prepare_data(Y, L, X, device="cpu", dtype=F64)
    noises = [Noise(seed + r, "cpu") for r in range(R)]
    pca = tmm.pca_init_scores(data.Y, 1, noises[0], F64)
    mu = tmm.data_mu_guess(data.Y, F64)
    params = [tmm.init_params(data.Y, data.L, n, K=1, dtype=F64, pca_scores=pca, mu_guess=mu,
                              P=X.shape[1])
              for n in noises]
    return data, params, noises


def test_lanes_equal_the_sequential_sweep():
    Y, L, X = _sim(N=50, G=40, C=2)
    R, shrinks = 4, [0.0, 5.0, 10.0, 5.0]
    config = tmm.ModelConfig(K=1, P=2)
    data, params, noises = _port_lanes(Y, L, X, R)
    lanes = tinfer.run_inference_lanes(tinfer.stack_lanes(params), data, noises, config,
                                       initial_shrinks=shrinks, **LOOP)
    assert lanes.params.beta.shape == (R, 40, 2)
    data, params, noises = _port_lanes(Y, L, X, R)
    singles = [tinfer.run_inference(p, data, n, config, initial_shrink=s, **LOOP)
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
        np.testing.assert_allclose(lanes.params.beta[r].numpy(), one.params.beta.numpy(),
                                   rtol=1e-12, atol=1e-14)
        assert clone_assignment(torch.softmax(lanes.params.gamma_logits[r], -1).numpy(), names) \
            == clone_assignment(torch.softmax(one.params.gamma_logits, -1).numpy(), names)


def test_run_clonealign_lanes_equal_map_with_x():
    Y, L, X = _sim(N=50, G=40, C=2)
    kw = dict(initial_shrinks=(0, 5), n_repeats=2, seed=2, device="cpu", dtype="float64",
              print_elbos=False, verbose=False, x=X, **LOOP)
    seq = ct.run_clonealign(Y, L, restart_batching="map", **kw)
    got = ct.run_clonealign(Y, L, restart_batching="vmap", **kw)
    assert got.timings["iterations"] == seq.timings["iterations"]
    assert got.multirun_info["best_run"] == seq.multirun_info["best_run"]
    np.testing.assert_allclose(got.multirun_info["elbos"], seq.multirun_info["elbos"], rtol=1e-12)
    assert got.clone == seq.clone
    assert got.ml_params["beta"].shape == (40, 2)
    np.testing.assert_allclose(got.ml_params["beta"], seq.ml_params["beta"], rtol=1e-12,
                               atol=1e-14)


def test_clonealign_x_matches_jax():
    """K = 0, so that the covariates carry the whole of log_rfe (Kf = P = 2)
    and the fit draws only the loop's noise, which the port replays from
    the JAX package's key: the same iterations, final ELBO, labels and
    beta. A gene without counts is filtered: beta is (G', P)."""
    Y, L, X = _sim(N=80, G=50, seed=8)
    Y = Y.copy()
    Y[:, 7] = 0
    kw = dict(K=0, x=X, max_iter=60, dtype="float64", verbose=False)
    want = ca.clonealign(Y, L, seed=3, **kw)
    k_fit = jax.random.split(jax.random.PRNGKey(3))[1]
    got = ct.clonealign(Y, L, noise=JaxKeySchedule(k_fit), device="cpu", **kw)
    assert got.ml_params["beta"].shape == want.ml_params["beta"].shape == (49, 2)
    assert got.convergence_info.n_iters == want.convergence_info.n_iters
    np.testing.assert_allclose(got.convergence_info.elbo, want.convergence_info.elbo, rtol=1e-6)
    np.testing.assert_allclose(got.convergence_info.final_elbo,
                               want.convergence_info.final_elbo, rtol=1e-6)
    assert got.clone == want.clone
    np.testing.assert_allclose(got.ml_params["beta"], want.ml_params["beta"], atol=1e-5)
    assert np.abs(want.ml_params["beta"]).max() > 0.05


def test_one_column_x_fits_and_beta_is_saved(tmp_path):
    Y, L, X = _sim(N=40, G=30, seed=4, P=1)
    fit = ct.clonealign(Y, L, x=X[:, 0], device="cpu", max_iter=5, seed=1, verbose=False)
    assert fit.ml_params["beta"].shape == (30, 1)
    back = ClonealignFit.load(fit.save(str(tmp_path / "fit")))
    np.testing.assert_array_equal(back.ml_params["beta"], fit.ml_params["beta"])
    no_x = ct.clonealign(Y, L, device="cpu", max_iter=5, seed=1, verbose=False)
    assert "beta" not in no_x.ml_params


def test_convert_round_trip_with_beta_and_x():
    Y, L, X = _sim(N=30, G=20, P=3)
    jp = _random_params(30, 20, 3, 1, 3, seed=1)
    jd = jmm.prepare_data(Y, L, x=X, dtype=jnp.float64)
    tp = convert.params_from_numpy(jp, "cpu", F64)
    td = convert.data_from_numpy(jd, "cpu", F64)
    np.testing.assert_array_equal(tp.beta.numpy(), np.asarray(jp.beta))
    np.testing.assert_array_equal(td.X.numpy(), X)
    np.testing.assert_array_equal(td.Y.numpy(), Y)
    without = convert.data_from_numpy(jmm.prepare_data(Y, L, dtype=jnp.float64), "cpu", F64)
    assert without.X is None
    # a dict without beta is a fit without covariates
    d = {k: np.asarray(v) for k, v in jp._asdict().items() if k != "beta"}
    assert convert.params_from_numpy(d, "cpu", F64).beta.shape == (20, 0)


def test_z_cheb_with_covariates_raises_as_the_reference():
    Y, L, X = _sim(N=30, G=20)
    with pytest.raises(ValueError, match=r"K=1, P=2"):
        ct.clonealign(Y, L, x=X, likelihood_impl="z_cheb", device="cpu", verbose=False)
    with pytest.raises(ValueError, match=r"K=1, P=2"):
        ca.clonealign(Y, L, x=X, likelihood_impl="z_cheb", verbose=False)


def test_x_with_the_wrong_rows_raises():
    Y, L, X = _sim(N=30, G=20)
    with pytest.raises(ValueError, match="30 rows"):
        ct.clonealign(Y, L, x=X[:-1], device="cpu", verbose=False)


@pytest.mark.parametrize("K,P,wide", [(1, 3, False), (2, 2, False), (0, 4, False),
                                      (1, 4, True), (3, 2, True)])
def test_k_plus_p_over_the_kernels_is_refused_at_setup_on_cuda(monkeypatch, K, P, wide):
    """K + P > 4 goes to the wide family: on CUDA the contract takes it
    (it refuses only K + P past the wide family's 64,
    tests/test_torch_wide.py), and setup_fit with it."""
    tapi._check_kernel_contract(torch.device("cpu"), K, 1, 3, P)  # the CPU takes any width
    tapi._check_kernel_contract(torch.device("cuda"), K, 1, 3, P)
    assert tfl.wide_route(K + P, 1, 3) is wide
    Y, L, X = _sim(N=30, G=20, P=P)
    _setup_passes_the_contract_on_cuda(monkeypatch, Y, L, x=X, K=K)


def test_sweep_bytes_count_covariates_and_no_narrow_block_for_the_exact_sweep():
    """On the card the exact kernels read int8 Y as it is stored: no
    converted row block; beta and its optimizer state (9 G P a lane), the
    fused op's wider YW and saved [psi, X], [W, beta] ((2 N + G) P a lane),
    the shared X (N P), and the gene part's scratch and sums at Kf = 1 + P
    in place of Kf = 1 (held once; a z_cheb sweep holds none)."""
    N, G, C, R = 100_000, 5_000, 10, 10
    base = dict(N=N, G=G, C=C, K=1, S=1, itemsize=4, device_type="cuda")
    exact_i8 = trestarts._sweep_bytes(n_lanes=R, y_itemsize=1, **base)
    assert exact_i8 == trestarts._sweep_bytes(n_lanes=R, **base) - 3 * N * G
    cheb_i8 = trestarts._sweep_bytes(n_lanes=R, y_itemsize=1, z_cheb=True, **base)
    exact_scratch = 4 * (tfl.gene_scratch(N, G, 1, 0, C) + (1 + C) * G)
    assert cheb_i8 - exact_i8 == 4 * tmm._CHUNK_ELEMENTS - exact_scratch
    P = 2
    with_x = trestarts._sweep_bytes(n_lanes=R, y_itemsize=1, P=P, **base)
    Kf = 1 + P
    per_lane = 9 * G * P + N * P + (N + G) * Kf
    scratch = (tfl.gene_scratch(N, G, Kf, 0, C) + (Kf + C) * G
               - tfl.gene_scratch(N, G, 1, 0, C) - (1 + C) * G)
    assert with_x - exact_i8 == 4 * (N * P + R * per_lane + scratch)
    assert trestarts._auto_restart_batching(n_lanes=R, y_itemsize=1, P=P, **base) == "vmap"

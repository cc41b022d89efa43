"""Lane-batched restarts (clonealign_torch.infer.run_inference_lanes and
run_clonealign's "vmap") against the sequential sweep and against the JAX
package's vmapped loop, in float64 on the CPU.

Lanes against the sequential sweep: the lane loop calls the same likelihood
per lane and batches only elementwise work and per-lane sums, so the lanes
agree with the one-at-a-time fits to float64 rounding (rtol 1e-12, the bar
tests/test_lane_freeze.py holds JAX's vmap to) and exactly in iterations
and labels. Lanes against JAX: the bars of test_torch_infer.py's
test_loop_matches_jax (trace rtol 1e-6, gamma atol 1e-5, final ELBO rtol
1e-6), two autodiff systems with Adam amplifying ulp-level differences.
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
from clonealign_tpu.synth import simulate_multinomial as jax_simulate
from clonealign_torch import convert
from clonealign_torch import infer as tinfer
from clonealign_torch import restarts as trestarts
from clonealign_torch.assign import clone_assignment
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.synth import simulate_multinomial
from clonealign_torch.utils.noise import Noise

torch.set_num_threads(2)

F64 = torch.float64
# loose tolerance, so that lanes stop early and at different iterations
LOOP = dict(max_iter=120, rel_tol=0.02, learning_rate=0.1)


def _sim():
    sim = simulate_multinomial(N=50, G=40, C=2, seed=0, mean_total=400)
    return sim.Y, sim.L


def _port_lanes(Y, L, R, seed=0):
    """R lanes as run_clonealign makes them: shared PCA and mu guess, each
    lane's jitter from Noise(seed + r)."""
    data = tmm.prepare_data(Y, L, device="cpu", dtype=F64)
    noises = [Noise(seed + r, "cpu") for r in range(R)]
    pca = tmm.pca_init_scores(data.Y, 1, noises[0], F64)
    mu = tmm.data_mu_guess(data.Y, F64)
    params = [tmm.init_params(data.Y, data.L, n, K=1, dtype=F64, pca_scores=pca, mu_guess=mu)
              for n in noises]
    return data, params, noises


def _labels(gamma_logits, C):
    names = [f"c{c}" for c in range(C)]
    return clone_assignment(torch.softmax(gamma_logits, dim=-1).numpy(), names)


def test_synth_copy_draws_the_jax_package_data():
    got, want = simulate_multinomial(N=30, G=20, C=3, seed=4), jax_simulate(N=30, G=20, C=3, seed=4)
    for name in ("Y", "L", "clone_idx", "mu", "s"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def _check_lanes_equal_singles(lanes, singles, C):
    for r, one in enumerate(singles):
        assert int(lanes.n_iters[r]) == one.n_iters
        tb, ts = lanes.elbo_trace[r], one.elbo_trace
        np.testing.assert_array_equal(np.isnan(tb), np.isnan(ts))
        np.testing.assert_allclose(tb[~np.isnan(tb)], ts[~np.isnan(ts)], rtol=1e-12)
        np.testing.assert_allclose(lanes.final_elbo[r], one.final_elbo, rtol=1e-12)
        np.testing.assert_allclose(lanes.params.qmu_loc[r].numpy(), one.params.qmu_loc.numpy(),
                                   rtol=1e-12)
        assert _labels(lanes.params.gamma_logits[r], C) == _labels(one.params.gamma_logits, C)


@pytest.mark.parametrize("elbo_eval", ["fresh", "reuse"])
def test_lanes_equal_the_sequential_sweep(elbo_eval):
    Y, L = _sim()
    R, shrinks = 4, [0.0, 5.0, 10.0, 5.0]
    data, params, noises = _port_lanes(Y, L, R)
    lanes = tinfer.run_inference_lanes(
        tinfer.stack_lanes(params), data, noises, tmm.ModelConfig(K=1),
        initial_shrinks=shrinks, elbo_eval=elbo_eval, **LOOP,
    )
    data, params, noises = _port_lanes(Y, L, R)
    singles = [
        tinfer.run_inference(p, data, n, tmm.ModelConfig(K=1), initial_shrink=s,
                             elbo_eval=elbo_eval, **LOOP)
        for p, n, s in zip(params, noises, shrinks)
    ]
    iters = [one.n_iters for one in singles]
    assert len(set(iters)) >= 2 and max(iters) < LOOP["max_iter"], iters
    _check_lanes_equal_singles(lanes, singles, L.shape[1])


def test_diverged_lane_stays_in_its_lane():
    """A lane whose ELBO is NaN from the start stops after one iteration;
    the other lanes are the fits they would be alone."""
    Y, L = _sim()
    R = 3
    data, params, noises = _port_lanes(Y, L, R, seed=5)
    params[1].qmu_loc[0] = float("nan")
    lanes = tinfer.run_inference_lanes(
        tinfer.stack_lanes(params), data, noises, tmm.ModelConfig(K=1),
        initial_shrinks=[5.0] * R, **LOOP,
    )
    data, params, noises = _port_lanes(Y, L, R, seed=5)
    params[1].qmu_loc[0] = float("nan")
    singles = [tinfer.run_inference(p, data, n, tmm.ModelConfig(K=1), **LOOP)
               for p, n in zip(params, noises)]
    assert singles[1].n_iters == 1 and np.isnan(singles[1].final_elbo)
    assert np.isfinite(lanes.params.qmu_loc[[0, 2]].numpy()).all()
    _check_lanes_equal_singles(lanes, singles, L.shape[1])


def test_lanes_match_jax_vmapped_loop():
    Y, L = _sim()
    R = 4
    jdata = jmm.prepare_data(Y, L, dtype=jnp.float64)
    config = jmm.ModelConfig(K=1, mc_samples=1, likelihood_impl="xla")
    k_init, k_fit = jax.vmap(jax.random.split)(jax.random.split(jax.random.PRNGKey(42), R)).transpose(1, 0, 2)
    params0 = jax.vmap(lambda k: jmm.init_params(jdata.Y, jdata.L, k, K=1, dtype=jnp.float64))(k_init)
    res = jax.jit(jax.vmap(lambda p, k: jinfer.run_inference(p, jdata, k, config, **LOOP)))(
        params0, k_fit)

    got = tinfer.run_inference_lanes(
        convert.params_from_numpy(params0, "cpu", F64),
        tmm.prepare_data(Y, L, device="cpu", dtype=F64),
        [JaxKeySchedule(k) for k in k_fit], tmm.ModelConfig(K=1),
        initial_shrinks=[5.0] * R, **LOOP,
    )
    n = np.asarray(res.n_iters)
    np.testing.assert_array_equal(got.n_iters, n)
    assert len(set(n.tolist())) >= 2, n
    for r in range(R):
        trace = np.asarray(res.elbo_trace[r])
        np.testing.assert_allclose(got.elbo_trace[r, : n[r] + 1], trace[: n[r] + 1], rtol=1e-6)
        assert np.isnan(got.elbo_trace[r, n[r] + 1:]).all()
        np.testing.assert_allclose(
            torch.softmax(got.params.gamma_logits[r], dim=1).numpy(),
            np.asarray(jax.nn.softmax(res.params.gamma_logits[r], axis=1)), atol=1e-5)
        np.testing.assert_allclose(got.final_elbo[r], float(res.final_elbo[r]), rtol=1e-6)


def test_params_from_numpy_keeps_the_lane_axis():
    rng = np.random.default_rng(1)
    shapes = dict(W=(40, 1), chi_unconstr=(1,), psi=(50, 1), beta=(40, 0), alpha_unconstr=(2,),
                  qmu_loc=(40,), qmu_log_scale=(40,), gamma_logits=(50, 2))
    params0 = jmm.CloneAlignParams(**{k: jnp.asarray(rng.normal(size=(3, *s)))
                                      for k, s in shapes.items()})
    got = convert.params_from_numpy(params0, "cpu", F64)
    assert got.psi.shape == (3, 50, 1) and got.gamma_logits.shape == (3, 50, 2)
    for r in range(3):
        one = convert.params_from_numpy(jax.tree.map(lambda a: a[r], params0), "cpu", F64)
        for a, b in zip(one.tensors(), got.tensors()):
            assert torch.equal(a, b[r])


@pytest.mark.parametrize("batching", ["vmap", "auto"])
def test_run_clonealign_vmap_equals_map(batching):
    Y, L = _sim()
    kw = dict(initial_shrinks=(0, 5), n_repeats=2, seed=2, device="cpu", dtype="float64",
              print_elbos=False, verbose=False, **LOOP)
    seq = ct.run_clonealign(Y, L, restart_batching="map", **kw)
    got = ct.run_clonealign(Y, L, restart_batching=batching, **kw)
    assert got.timings["iterations"] == seq.timings["iterations"]
    assert got.multirun_info["best_run"] == seq.multirun_info["best_run"]
    np.testing.assert_allclose(got.multirun_info["elbos"], seq.multirun_info["elbos"], rtol=1e-12)
    assert got.clone == seq.clone
    assert got.multirun_info["clone_prevalences_at_different_shrinks"] == \
        seq.multirun_info["clone_prevalences_at_different_shrinks"]


# The card's peak allocated bytes in the inference of chip_smoke.py's sweeps
# (run_sweep, from inference_peaks) at 100,000 x 5,000 x 10, K = 1, 100
# iterations, "reuse", Y int8 ("auto") unless named: ten restarts (a) one
# after another, (b) as lanes, also with float32 Y, (c) z_cheb as lanes, (d)
# with two covariates as lanes; and the wide sweep, three lanes of K = 1,
# P = 4, mc_samples = 8. One NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py
# (PERF.md §5). Each entry: _sweep_bytes' keywords, the peak in bytes.
SWEEP_PEAKS = {
    "(a) map": (dict(S=1, n_lanes=10, y_itemsize=1, batching="map"), 0.7310e9),
    "(b) vmap": (dict(S=1, n_lanes=10, y_itemsize=1), 1.2814e9),
    "(b) vmap float32": (dict(S=1, n_lanes=10, y_itemsize=4), 2.7829e9),
    "(c) z_cheb vmap": (dict(S=1, n_lanes=10, y_itemsize=1, z_cheb=True), 2.0043e9),
    "(d) covariates vmap": (dict(S=1, n_lanes=10, y_itemsize=1, P=2), 1.3068e9),
    "wide vmap": (dict(S=8, n_lanes=3, y_itemsize=1, P=4), 1.0752e9),
}


@pytest.mark.parametrize("name", sorted(SWEEP_PEAKS))
def test_sweep_bytes_hold_the_measured_peaks(name):
    """_sweep_bytes never reckons a sweep the card measured under its peak,
    and at most 1.3 times it, so that "auto" takes "vmap" wherever the
    lanes fit with that margin."""
    kw, peak = SWEEP_PEAKS[name]
    got = trestarts._sweep_bytes(100_000, 5_000, 10, 1, itemsize=4, device_type="cuda", **kw)
    assert peak <= got <= 1.3 * peak, (got, peak)


def test_auto_batching_follows_the_working_set():
    # 100,000 x 5,000 x 10, float32 on the card: ten lanes fit, thousands do not
    full = dict(N=100_000, G=5_000, C=10, K=1, S=1, itemsize=4, device_type="cuda")
    assert trestarts._auto_restart_batching(n_lanes=10, **full) == "vmap"
    assert trestarts._auto_restart_batching(n_lanes=2_000, **full) == "map"
    per_lane = (trestarts._sweep_bytes(n_lanes=2, **full)
                - trestarts._sweep_bytes(n_lanes=1, **full))
    fit = (trestarts.SWEEP_BUDGET_BYTES - trestarts._sweep_bytes(n_lanes=0, **full)) // per_lane
    assert trestarts._auto_restart_batching(n_lanes=fit, **full) == "vmap"
    assert trestarts._auto_restart_batching(n_lanes=fit + 1, **full) == "map"
    # the CPU's plain likelihood holds N x G temporaries besides Y
    cpu = dict(full, device_type="cpu")
    assert trestarts._sweep_bytes(n_lanes=10, **cpu) > trestarts._sweep_bytes(n_lanes=10, **full)

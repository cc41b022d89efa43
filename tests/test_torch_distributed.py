"""The distributed fit on two gloo CPU ranks (tests/_torch_dist_worker.py,
spawned once for the module with every mode in one run) against the
port's one-process fits and the JAX package's sharded fits on the 8
virtual CPU devices (tests/conftest.py), in float64.

Tolerances, set from float64 and the sums the split reorders:
- against the port's one-process fits: final ELBOs and traces rtol 1e-10,
  the same iterations and clone calls, the per-cell outputs rtol 1e-8
  (the ranks sum every reduction over cells in another order; Adam
  carries those ulps along the trajectory);
- distributed_fit from each rank's rows against sharded_fit from the whole
  matrix: the same fit, rtol 1e-12;
- against the JAX package's sharded_fit on its replayed draws: the bars of
  tests/test_torch_infer.py::test_loop_matches_jax (trace and final ELBO
  rtol 1e-6, gamma atol 1e-5): two autodiff systems;
- sharded_negbin_fit against the port's one-process fit and the JAX
  package's sharded fit: the JAX package's own bars for its mesh fit
  (tests/test_sharding.py::test_sharded_negbin_fit_matches_single_device):
  the first E-step's ELBO rtol 1e-9, then the converged state (clone
  calls, the dosage mask, gamma atol 1e-5, final ELBO rtol 1e-4), since
  Adam's first step, m / (sqrt(v) + eps), turns reassociation-level
  differences of near-zero gradients into different steps.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_dist_worker as worker
import clonealign_torch as ct
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.models import negbin as tnb
from clonealign_torch.parallel import sharding
from clonealign_torch.synth import simulate_model3, simulate_multinomial
from clonealign_tpu.models import multinomial as jmm
from clonealign_tpu.parallel import sharding as jsharding

torch.set_num_threads(2)

WORLD = 2
TIMEOUT = 240  # seconds for the whole two-rank run; the group's own timeout is 60 s
HERE = os.path.dirname(os.path.abspath(__file__))


def _inputs():
    """Every input of the worker's modes, made from numpy seeds."""
    sim = simulate_multinomial(N=64, G=40, C=3, seed=7, mean_total=300)
    odd = simulate_multinomial(N=61, G=40, C=3, seed=8, mean_total=300)
    rng = np.random.default_rng(9)
    N = odd.Y.shape[0]
    # three genes the filter (threshold 2) must treat alike on both ranks
    # (rank 0 holds rows 0-29, rank 1 rows 30-60): A, counts on rank 1
    # only, total 3, kept; B, total 2 on rank 1, dropped; C, 2 on rank 0
    # and 1 on rank 1, kept though each rank's own total is at most 2
    extra = np.zeros((N, 3))
    extra[40, 0] = 3
    extra[45, 1] = 2
    extra[5, 2], extra[50, 2] = 2, 1
    clone_allele = rng.integers(1, 4, (25, 3)).astype(np.float64)
    cov = rng.poisson(8.0, (N, 25)).astype(np.float64)
    cn = clone_allele[:, odd.clone_idx]
    p = np.where(cn == 2, 0.5, np.where(rng.random(cn.shape) < 0.5, 0.05, 0.95))
    alt = rng.binomial(cov.T.astype(np.int64), p).astype(np.float64)
    wide = odd.Y.copy()
    wide[50, 3] = 200  # above int8 on rank 1 only: Y is int16 on both ranks
    nb = simulate_model3(N=64, G=48, C=4, seed=21)
    cheb = dict(cheb_psi=np.sort(1.5 * rng.standard_normal(N))[:, None],
                cheb_W=0.5 * rng.standard_normal((odd.Y.shape[1], 1)),
                cheb_mu=np.exp(rng.standard_normal((1, odd.Y.shape[1]))))
    return dict(Y=sim.Y, L=sim.L, Y_genes=np.hstack([odd.Y, extra]),
                L_genes=np.vstack([odd.L, np.full((3, 3), 2.0)]), x=rng.normal(size=(N, 2)),
                clone_allele=clone_allele, cov=cov, ref=cov - alt.T, Y_wide_counts=wide,
                L_odd=odd.L, Y_nb=nb.Y, L_nb=nb.L, **cheb)


def _jax_sweep(z):
    """The JAX package's sharded_fit on the 8 virtual devices, and every
    draw it made, as the worker's NpzNoise reads them."""
    key = jax.random.PRNGKey(5)
    kw = {k: v for k, v in worker.JAX_SWEEP.items() if k != "n_restarts"}
    R = worker.JAX_SWEEP["n_restarts"]
    res = jsharding.sharded_fit(z["Y"], z["L"], jsharding.make_mesh(), n_restarts=R, key=key,
                                dtype=jnp.float64, config=jmm.ModelConfig(K=1), **kw)
    (N, G), k_eff = z["Y"].shape, min(1 + 8, min(z["Y"].shape))

    def normal(k, shape):
        return np.asarray(jax.random.normal(k, shape, jnp.float64))

    draws = {}
    for r, lane_key in enumerate(jax.random.split(key, R)):
        k_init, k_fit = jax.random.split(lane_key)
        k_pca, k_jitter = jax.random.split(k_init)
        if r == 0:
            draws["jax0_pca_omega"] = normal(k_pca, (G, k_eff))
            draws["jax_pca"] = np.asarray(jmm.pca_init_scores(jnp.asarray(z["Y"]), 1, k_pca,
                                                              jnp.float64))
        draws[f"jax{r}_psi_jitter"] = normal(k_jitter, (N, 1))
        kk, k_warm, k_init_eval = jax.random.split(k_fit, 3)
        draws[f"jax{r}_warm"] = normal(k_warm, (1, 1, G))
        draws[f"jax{r}_init_eval"] = normal(k_init_eval, (1, 1, G))
        train, evals = [], []
        for _ in range(int(res.n_iters[r])):
            kk, k, k_eval = jax.random.split(kk, 3)
            train.append(normal(k, (1, G)))
            evals.append(normal(k_eval, (1, G)))
        draws[f"jax{r}_train"] = np.stack(train)
        draws[f"jax{r}_eval"] = np.stack(evals)
        draws[f"jax{r}_final"] = np.stack([normal(k, (1, G)) for k in
                                           jax.random.split(jax.random.fold_in(kk, 7), 20)])
    return res, draws


def _spawn(tmp, inputs):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), HERE] + ([os.environ["PYTHONPATH"]] if "PYTHONPATH" in os.environ
                                         else [])))
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
                               str(r), str(WORLD), str(port), inputs, outs[r]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the JAX package's sweep and draws, and both ranks' results."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    z = _inputs()
    jax_res, draws = _jax_sweep(z)
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **z, **draws)
    return z, jax_res, _spawn(tmp, path)


def _rows(ranks, name):
    """A per-cell result of every rank, rows in order."""
    for prev, nxt in zip(ranks, ranks[1:]):
        assert prev[name.split("_")[0] + "_rows"][1] == nxt[name.split("_")[0] + "_rows"][0]
    return np.concatenate([r[name] for r in ranks], axis=-2)


def _same_sweep(ranks, prefix, want, rtol):
    for r in ranks:
        np.testing.assert_array_equal(r[f"{prefix}_n_iters"], want.n_iters)
        np.testing.assert_allclose(r[f"{prefix}_final_elbo"], want.final_elbo, rtol=rtol)
        np.testing.assert_allclose(r[f"{prefix}_trace"], want.elbo_trace, rtol=rtol)
        np.testing.assert_allclose(r[f"{prefix}_qmu_loc"], want.params.qmu_loc.numpy(), rtol=1e-8)
    gamma = _rows(ranks, f"{prefix}_gamma_logits")
    np.testing.assert_array_equal(gamma.argmax(-1), want.params.gamma_logits.numpy().argmax(-1))
    np.testing.assert_allclose(torch.softmax(torch.tensor(gamma), -1).numpy(),
                               torch.softmax(want.params.gamma_logits, -1).numpy(), atol=1e-8)
    np.testing.assert_allclose(_rows(ranks, f"{prefix}_psi"), want.params.psi.numpy(), rtol=1e-8,
                               atol=1e-12)


def _one_process_mesh():
    return sharding.make_mesh(devices="cpu")


def test_sharded_fit_equals_the_one_process_sweep(run):
    """In one process without a group the mesh is a world of one, and
    sharded_fit is the plain lane loop."""
    z, _, ranks = run
    want = sharding.sharded_fit(z["Y"], z["L"], _one_process_mesh(), seed=3, **worker.SWEEP)
    _same_sweep(ranks, "sharded", want, rtol=1e-10)


def test_distributed_fit_from_local_rows_equals_sharded_fit(run):
    _, _, ranks = run
    for r in ranks:
        for name in ("final_elbo", "trace", "gamma_logits", "psi", "qmu_loc"):
            np.testing.assert_allclose(r[f"distributed_{name}"], r[f"sharded_{name}"], rtol=1e-12,
                                       err_msg=name)
        np.testing.assert_array_equal(r["distributed_n_iters"], r["sharded_n_iters"])


def test_sharded_fit_matches_the_jax_sharded_fit(run):
    z, want, ranks = run
    assert ranks[0]["jax_pca_err"] < 1e-8 and ranks[1]["jax_pca_err"] < 1e-8
    n = np.asarray(want.n_iters)
    gamma = torch.softmax(torch.tensor(_rows(ranks, "jax_gamma_logits")), -1).numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["jax_n_iters"], n)
        np.testing.assert_allclose(r["jax_final_elbo"], np.asarray(want.final_elbo), rtol=1e-6)
        for lane in range(len(n)):
            np.testing.assert_allclose(r["jax_trace"][lane, : n[lane] + 1],
                                       np.asarray(want.elbo_trace[lane])[: n[lane] + 1],
                                       rtol=1e-6)
    np.testing.assert_allclose(gamma, np.asarray(jax.nn.softmax(want.params.gamma_logits, -1)),
                               atol=1e-5)


def _same_fit(ranks, prefix, want):
    """Every rank's fit is the one-process fit."""
    for r in ranks:
        assert list(r[f"{prefix}_clone"]) == want.clone
        assert list(r[f"{prefix}_retained"]) == [str(g) for g in want.retained_genes]
        np.testing.assert_allclose(r[f"{prefix}_elbo"], want.convergence_info.elbo, rtol=1e-10)
        np.testing.assert_allclose(r[f"{prefix}_final_elbo"], want.convergence_info.final_elbo,
                                   rtol=1e-10)
        np.testing.assert_allclose(r[f"{prefix}_correlations"], want.correlations, rtol=1e-8,
                                   equal_nan=True)
        for name, value in want.ml_params.items():
            np.testing.assert_allclose(r[f"{prefix}_ml_{name}"], value, rtol=1e-8, atol=1e-12,
                                       err_msg=name)
        if want.clone_probs_from_snv is not None:
            np.testing.assert_allclose(r[f"{prefix}_snv"], want.clone_probs_from_snv, rtol=1e-12)
        if want.multirun_info is not None:
            got, info = json.loads(str(r[f"{prefix}_multirun"])), want.multirun_info
            np.testing.assert_allclose(got["elbos"], info["elbos"], rtol=1e-10)
            assert got["prevalences"] == info["clone_prevalences_at_different_shrinks"]
            assert got["best_run"] == info["best_run"]
            np.testing.assert_allclose(got["median_correlations"], info["median_correlations"],
                                       rtol=1e-8)


def test_run_clonealign_on_a_mesh_with_covariates_allele_and_csr(run):
    """61 cells (30 and 31 a rank), CSR counts stored int8, two covariate
    columns, the allele term, and genes whose counts lie on one rank: the
    filter keeps A and C and drops B on both ranks, as the one-process fit
    does."""
    z, _, ranks = run
    want = ct.run_clonealign(sp.csr_matrix(z["Y_genes"]), z["L_genes"], x=z["x"],
                             clone_allele=z["clone_allele"], cov=z["cov"], ref=z["ref"],
                             gene_filter_threshold=worker.GENE_FILTER_THRESHOLD, device="cpu",
                             **worker.RUN)
    G = z["Y"].shape[1]
    assert [str(g) for g in want.retained_genes][-2:] == [str(G), str(G + 2)]
    for r in ranks:
        assert str(r["rich_storage"]) == "torch.int8"
        assert int(r["rich_local_genes"]) == len(want.retained_genes)
    _same_fit(ranks, "rich", want)


def test_decisions_that_read_every_cell_agree(run):
    """Y's storage (a count of 200 on rank 1 only), the likelihood ("auto"
    set to pick z_cheb from the global N x G up) and the restart batching (a
    budget between the two ranks' needs) are every rank's alike; the z_cheb
    fit's Chebyshev range is every rank's psi, so it is the one-process
    z_cheb fit."""
    z, _, ranks = run
    for r in ranks:
        assert str(r["cheb_storage"]) == "torch.int16"
        assert str(r["cheb_impl"]) == "z_cheb"
    assert ranks[0]["cheb_batching"] == ranks[1]["cheb_batching"]
    # the Chebyshev table is fitted to every rank's psi (rank 0's are the
    # smaller ones): each rank's log Z is the one-process table's
    data = tmm.prepare_data(z["Y_wide_counts"], z["L_odd"], device="cpu", dtype=torch.float64)
    params = worker.cheb_params(torch.tensor(z["cheb_psi"]), torch.tensor(z["cheb_W"]))
    want = tmm._compute_logZ_cheb(params, data, torch.tensor(z["cheb_mu"]), 16).numpy()
    np.testing.assert_allclose(np.concatenate([r["cheb_logz"] for r in ranks], axis=-1), want,
                               rtol=1e-13)
    want = ct.run_clonealign(z["Y_wide_counts"], z["L_odd"], likelihood_impl="z_cheb", device="cpu",
                             **worker.RUN)
    _same_fit(ranks, "cheb", want)


def test_fit_streaming_on_a_mesh(run):
    z, _, ranks = run
    want = ct.fit_streaming(z["Y"], z["L"], device="cpu", **worker.STREAM)
    _same_fit(ranks, "stream", want)


@pytest.mark.parametrize("impl", ["exact", "cheb"])
def test_sharded_negbin_fit(run, impl):
    """Against the port's one-process fit (both loops) and, for the exact
    loop, the JAX package's sharded_negbin_fit."""
    z, _, ranks = run
    data = tnb.prepare_negbin_data(z["Y_nb"], z["L_nb"], device="cpu", dtype=torch.float64)
    stats = tnb.negbin_cheb_stats(data) if impl == "cheb" else None
    kw = {k: v for k, v in worker.NEGBIN.items() if k != "dtype"}
    wants = [tnb.run_negbin_em(data, None, stats, **kw)]
    if impl == "exact":
        wants.append(jsharding.sharded_negbin_fit(z["Y_nb"], z["L_nb"], jsharding.make_mesh(),
                                                  dtype=jnp.float64, **kw))
    gamma = np.concatenate([r[f"nb_{impl}_gamma"] for r in ranks])
    for want in wants:
        g_want = np.asarray(want.post.gamma)
        np.testing.assert_array_equal(gamma.argmax(1), g_want.argmax(1))
        np.testing.assert_allclose(gamma, g_want, atol=1e-5)
        for r in ranks:
            np.testing.assert_allclose(r[f"nb_{impl}_trace"][0], float(want.elbo_trace[0]),
                                       rtol=1e-9)
            np.testing.assert_array_equal(r[f"nb_{impl}_r"] > 0.5, np.asarray(want.post.r) > 0.5)
            np.testing.assert_allclose(r[f"nb_{impl}_final_elbo"], float(want.final_elbo),
                                       rtol=1e-4)


def test_failures_raise_on_every_rank(run):
    """Fewer cells than ranks raise a ValueError on both ranks, from the
    whole matrix and from each rank's own rows (one rank given none); a
    check that raises on one rank only (a KeyError) raises that error there
    and a RuntimeError naming it on the other, so that neither waits on a
    collective for the group's timeout."""
    _, _, ranks = run
    for r in ranks:
        for name in ("refuse_block", "refuse_fit", "refuse_local"):
            assert str(r[name]).startswith("ValueError: "), (name, str(r[name]))
            assert "at least one cell" in str(r[name])
        assert str(r["agree_value"]) == "returned"
    assert str(ranks[1]["refuse_agree"]).startswith("KeyError: ")
    assert str(ranks[0]["refuse_agree"]).startswith("RuntimeError: ")
    assert "rank(s) [1]" in str(ranks[0]["refuse_agree"])

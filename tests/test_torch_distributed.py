"""The distributed fit on two gloo CPU ranks, and on four as a 2 x 2
(cells, genes) mesh (tests/_torch_dist_worker.py, each spawned once for
the module with every mode in one run), against the port's one-process
fits and the JAX package's sharded fits on the 8 virtual CPU devices
(tests/conftest.py; its (4, 2) mesh for the genes axis), in float64.

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

The 2 x 2 run holds the same bars (sharded_fit against the one-process
fit rtol 1e-10, distributed_fit against sharded_fit 1e-12, the JAX
package's (4, 2) mesh fit: traces 1e-6, gamma 1e-5), and the fused op's
values and gradients on a rank's tile against the whole op's at 1e-12:
float64 sums over genes split in two, nothing else. Every gene rank of a
cell block holds the same per-cell results, to the bit.
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
GENES_WORLD = 4  # the 2 x 2 mesh's ranks
GENES_TIMEOUT = 300  # seconds for the whole four-rank run
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


def _genes_inputs():
    """The four-rank run's inputs: 48 genes for the JAX package's mesh
    (which splits them evenly), the first 47 for the ragged split, and the
    48 with the last one's counts removed, which the filter drops before
    the kept 47 are split; covariates, allele counts and the fused op's
    check's parameters and cotangents."""
    sim = simulate_multinomial(N=64, G=48, C=3, seed=11, mean_total=300)
    rng = np.random.default_rng(12)
    N, G, C = 64, 47, 3
    Yg_f = sim.Y.copy()
    Yg_f[:, -1] = 0
    clone_allele = rng.integers(1, 4, (25, C)).astype(np.float64)
    cov = rng.poisson(8.0, (N, 25)).astype(np.float64)
    cn = clone_allele[:, sim.clone_idx]
    p = np.where(cn == 2, 0.5, np.where(rng.random(cn.shape) < 0.5, 0.05, 0.95))
    alt = rng.binomial(cov.T.astype(np.int64), p).astype(np.float64)
    R, S = worker.OP_LANES, worker.OP_S
    nb = simulate_model3(N=64, G=48, C=4, seed=21)
    return dict(Y_nb=nb.Y, L_nb=nb.L, Yg48=sim.Y, Lg48=sim.L, Yg=sim.Y[:, :G], Lg=sim.L[:G],
                Yg_f=Yg_f, Lg_f=sim.L,
                xg=rng.normal(size=(N, 2)), covg=cov, refg=cov - alt.T,
                clone_allele=clone_allele,
                op_psi=np.sort(rng.standard_normal((R, N, 1)), axis=1),
                op_W=0.3 * rng.standard_normal((R, G, 1)),
                op_mu=np.exp(0.5 * rng.standard_normal((R, S, G))),
                op_c1=rng.standard_normal((R, N)), op_c2=rng.standard_normal((R, N, S)),
                op_c3=rng.standard_normal((R, S, C, N)))


def _jax_sweep(Y, L, mesh, prefix="jax"):
    """The JAX package's sharded_fit on ``mesh`` of the 8 virtual devices,
    and every draw it made, named as the worker's NpzNoise reads them."""
    key = jax.random.PRNGKey(5)
    kw = {k: v for k, v in worker.JAX_SWEEP.items() if k != "n_restarts"}
    R = worker.JAX_SWEEP["n_restarts"]
    res = jsharding.sharded_fit(Y, L, mesh, n_restarts=R, key=key,
                                dtype=jnp.float64, config=jmm.ModelConfig(K=1), **kw)
    (N, G), k_eff = Y.shape, min(1 + 8, min(Y.shape))

    def normal(k, shape):
        return np.asarray(jax.random.normal(k, shape, jnp.float64))

    draws = {}
    for r, lane_key in enumerate(jax.random.split(key, R)):
        k_init, k_fit = jax.random.split(lane_key)
        k_pca, k_jitter = jax.random.split(k_init)
        if r == 0:
            draws[f"{prefix}0_pca_omega"] = normal(k_pca, (G, k_eff))
            draws[f"{prefix}_pca"] = np.asarray(jmm.pca_init_scores(jnp.asarray(Y), 1, k_pca,
                                                                    jnp.float64))
        draws[f"{prefix}{r}_psi_jitter"] = normal(k_jitter, (N, 1))
        kk, k_warm, k_init_eval = jax.random.split(k_fit, 3)
        draws[f"{prefix}{r}_warm"] = normal(k_warm, (1, 1, G))
        draws[f"{prefix}{r}_init_eval"] = normal(k_init_eval, (1, 1, G))
        train, evals = [], []
        for _ in range(int(res.n_iters[r])):
            kk, k, k_eval = jax.random.split(kk, 3)
            train.append(normal(k, (1, G)))
            evals.append(normal(k_eval, (1, G)))
        draws[f"{prefix}{r}_train"] = np.stack(train)
        draws[f"{prefix}{r}_eval"] = np.stack(evals)
        draws[f"{prefix}{r}_final"] = np.stack([normal(k, (1, G)) for k in
                                                jax.random.split(jax.random.fold_in(kk, 7), 20)])
    return res, draws


def _spawn(tmp, inputs, world=WORLD, genes=1, timeout=TIMEOUT):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), HERE] + ([os.environ["PYTHONPATH"]] if "PYTHONPATH" in os.environ
                                         else [])))
    outs = [os.path.join(tmp, f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
                               str(r), str(world), str(port), inputs, outs[r], str(genes)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
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
    jax_res, draws = _jax_sweep(z["Y"], z["L"], jsharding.make_mesh())
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **z, **draws)
    return z, jax_res, _spawn(tmp, path)


@pytest.fixture(scope="module")
def run_genes(tmp_path_factory):
    """The 2 x 2 run: its inputs, the JAX package's sweep on its (4, 2)
    mesh and draws, and the four ranks' results (rank r at cell block
    r // 2 and gene block r % 2)."""
    tmp = str(tmp_path_factory.mktemp("dist_genes"))
    z = _genes_inputs()
    jmesh = jsharding.make_mesh(cell_parallelism=4, gene_parallelism=2)
    jax_res, draws = _jax_sweep(z["Yg48"], z["Lg48"], jmesh, prefix="jg")
    path = os.path.join(tmp, "inputs.npz")
    np.savez(path, **z, **draws)
    return z, jax_res, _spawn(tmp, path, GENES_WORLD, worker.GENES, GENES_TIMEOUT)


def _rows(ranks, name, genes=1):
    """A per-cell result of every rank, rows in order: each cell block's
    from its first gene rank, after checking that the block's other gene
    ranks hold the same, to the bit."""
    for block in range(0, len(ranks), genes):
        for sibling in ranks[block + 1 : block + genes]:
            np.testing.assert_array_equal(sibling[name], ranks[block][name], err_msg=name)
    ranks = ranks[::genes]
    key = next(name[: -len(f)] for f in ("gamma_logits", "psi") if name.endswith(f)) + "rows"
    for prev, nxt in zip(ranks, ranks[1:]):
        assert prev[key][1] == nxt[key][0]
    return np.concatenate([r[name] for r in ranks], axis=-2)


def _same_sweep(ranks, prefix, want, rtol, genes=1):
    for r in ranks:
        np.testing.assert_array_equal(r[f"{prefix}_n_iters"], want.n_iters)
        np.testing.assert_allclose(r[f"{prefix}_final_elbo"], want.final_elbo, rtol=rtol)
        np.testing.assert_allclose(r[f"{prefix}_trace"], want.elbo_trace, rtol=rtol)
        np.testing.assert_allclose(r[f"{prefix}_qmu_loc"], want.params.qmu_loc.numpy(), rtol=1e-8)
    gamma = _rows(ranks, f"{prefix}_gamma_logits", genes)
    np.testing.assert_array_equal(gamma.argmax(-1), want.params.gamma_logits.numpy().argmax(-1))
    np.testing.assert_allclose(torch.softmax(torch.tensor(gamma), -1).numpy(),
                               torch.softmax(want.params.gamma_logits, -1).numpy(), atol=1e-8)
    np.testing.assert_allclose(_rows(ranks, f"{prefix}_psi", genes), want.params.psi.numpy(),
                               rtol=1e-8, atol=1e-12)


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


# --- the 2 x 2 (cells, genes) mesh --------------------------------------------

def test_genes_axis_sharded_fit_equals_the_one_process_sweep(run_genes):
    """47 genes, 23 and 24 a gene block: the sums over genes split in two,
    the draws over genes made whole and sliced."""
    z, _, ranks = run_genes
    assert sorted(int(r["g_local_genes"]) for r in ranks) == [23, 23, 24, 24]
    want = sharding.sharded_fit(z["Yg"], z["Lg"], _one_process_mesh(), seed=3, **worker.SWEEP)
    _same_sweep(ranks, "g_sharded", want, rtol=1e-10, genes=worker.GENES)


def test_genes_axis_distributed_fit_equals_sharded_fit(run_genes):
    _, _, ranks = run_genes
    for r in ranks:
        for name in ("final_elbo", "trace", "gamma_logits", "psi", "qmu_loc"):
            np.testing.assert_allclose(r[f"g_distributed_{name}"], r[f"g_sharded_{name}"],
                                       rtol=1e-12, err_msg=name)
        np.testing.assert_array_equal(r["g_distributed_n_iters"], r["g_sharded_n_iters"])


def test_genes_axis_matches_the_jax_mesh_fit(run_genes):
    """Against the JAX package's sharded_fit on make_mesh(cell_parallelism=4,
    gene_parallelism=2), its draws replayed."""
    _, want, ranks = run_genes
    assert all(r["g_jax_pca_err"] < 1e-8 for r in ranks)
    n = np.asarray(want.n_iters)
    gamma = _rows(ranks, "g_jax_gamma_logits", worker.GENES)
    gamma = torch.softmax(torch.tensor(gamma), -1).numpy()
    for r in ranks:
        np.testing.assert_array_equal(r["g_jax_n_iters"], n)
        np.testing.assert_allclose(r["g_jax_final_elbo"], np.asarray(want.final_elbo), rtol=1e-6)
        np.testing.assert_allclose(r["g_jax_qmu_loc"], np.asarray(want.params.qmu_loc),
                                   rtol=1e-5)
        for lane in range(len(n)):
            np.testing.assert_allclose(r["g_jax_trace"][lane, : n[lane] + 1],
                                       np.asarray(want.elbo_trace[lane])[: n[lane] + 1],
                                       rtol=1e-6)
    np.testing.assert_allclose(gamma, np.asarray(jax.nn.softmax(want.params.gamma_logits, -1)),
                               atol=1e-5)


@pytest.mark.parametrize("batching", ["vmap", "map"])
def test_genes_axis_run_clonealign_with_csr_int8_covariates_and_allele(run_genes, batching):
    """The filter drops the 48th gene (no counts) on every rank before the
    kept 47 are split; Y is stored int8 on each rank's tile."""
    z, _, ranks = run_genes
    want = ct.run_clonealign(sp.csr_matrix(z["Yg_f"]), z["Lg_f"], x=z["xg"],
                             clone_allele=z["clone_allele"], cov=z["covg"], ref=z["refg"],
                             restart_batching=batching, device="cpu", **worker.RUN)
    assert len(want.retained_genes) == 47
    for rank, r in enumerate(ranks):
        assert str(r["g_rich_storage"]) == "torch.int8"
        assert list(r["g_rich_tile"]) == [32, 23 if rank % 2 == 0 else 24]
    _same_fit(ranks, f"g_rich_{batching}", want)


def test_genes_axis_z_cheb_fit(run_genes):
    z, _, ranks = run_genes
    want = ct.run_clonealign(z["Yg_f"], z["Lg_f"], likelihood_impl="z_cheb", device="cpu",
                             **worker.RUN)
    _same_fit(ranks, "g_cheb", want)


def test_genes_axis_fit_streaming(run_genes):
    z, _, ranks = run_genes
    want = ct.fit_streaming(z["Yg_f"], z["Lg_f"], device="cpu", **worker.STREAM)
    _same_fit(ranks, "g_stream", want)


@pytest.mark.parametrize("impl", ["exact", "cheb"])
def test_genes_axis_sharded_negbin_fit(run_genes, impl):
    """The v1 fit on the 2 x 2 mesh (48 genes, 24 a block) against the
    port's one-process fit and, exact, the JAX package's on its (4, 2)
    mesh: the JAX package's mesh bars."""
    z, _, ranks = run_genes
    data = tnb.prepare_negbin_data(z["Y_nb"], z["L_nb"], device="cpu", dtype=torch.float64)
    stats = tnb.negbin_cheb_stats(data) if impl == "cheb" else None
    kw = {k: v for k, v in worker.NEGBIN.items() if k != "dtype"}
    wants = [tnb.run_negbin_em(data, None, stats, **kw)]
    if impl == "exact":
        jmesh = jsharding.make_mesh(cell_parallelism=4, gene_parallelism=2)
        wants.append(jsharding.sharded_negbin_fit(z["Y_nb"], z["L_nb"], jmesh,
                                                  dtype=jnp.float64, **kw))
    for r in ranks:
        np.testing.assert_array_equal(r[f"g_nb_{impl}_n_iter"], ranks[0][f"g_nb_{impl}_n_iter"])
    for block in (0, 2):
        np.testing.assert_array_equal(ranks[block + 1][f"g_nb_{impl}_gamma"],
                                      ranks[block][f"g_nb_{impl}_gamma"])
    gamma = np.concatenate([r[f"g_nb_{impl}_gamma"] for r in ranks[::2]])
    for want in wants:
        g_want = np.asarray(want.post.gamma)
        np.testing.assert_array_equal(gamma.argmax(1), g_want.argmax(1))
        np.testing.assert_allclose(gamma, g_want, atol=1e-5)
        for r in ranks:
            np.testing.assert_allclose(r[f"g_nb_{impl}_trace"][0], float(want.elbo_trace[0]),
                                       rtol=1e-9)
            np.testing.assert_array_equal(r[f"g_nb_{impl}_r"] > 0.5,
                                          np.asarray(want.post.r) > 0.5)
            np.testing.assert_allclose(r[f"g_nb_{impl}_final_elbo"], float(want.final_elbo),
                                       rtol=1e-4)


def test_genes_axis_negbin_resume(run_genes):
    """sharded_negbin_fit(resume_from=) on the 2 x 2 mesh: the first run's
    per-gene fields come back whole (48 genes) and are cut to each gene
    block for the second, which takes the steps of one run of both runs'
    iterations (rtol 1e-12: the same sums in the same order)."""
    _, _, ranks = run_genes
    k = worker.NEGBIN_RESUME["max_iter"]
    for r in ranks:
        assert r["g_nb_resume_log_mu"].shape == r["g_nb_resume_nu"].shape == (48,)
        np.testing.assert_allclose(r["g_nb_resume_trace"][: k + 1],
                                   r["g_nb_one_run_trace"][k : 2 * k + 1], rtol=1e-12)
        np.testing.assert_allclose(r["g_nb_resume_gamma"], r["g_nb_one_run_gamma"], rtol=1e-12,
                                   atol=1e-15)


@pytest.mark.parametrize("impl", ["xla", "z_cheb"])
def test_genes_axis_fused_op_on_gene_blocks(run_genes, impl):
    """A1, A2, log Z and the gradients of psi, W and the mu samples on each
    rank's tile (two lanes, two mu samples) against the whole op's: psi's
    gradient summed over the gene blocks by the op's f, W's and mu's
    summed over the cell blocks by the test."""
    _, _, ranks = run_genes
    for r in ranks:
        for name in ("A1", "A2", "logZ", "dpsi", "dW", "dmu"):
            want = r[f"g_op_{impl}_{name}_want"]
            np.testing.assert_allclose(r[f"g_op_{impl}_{name}"], want, rtol=1e-12,
                                       atol=1e-12 * np.max(np.abs(want)), err_msg=name)


def test_genes_axis_fewer_kept_genes_than_blocks_raise_on_every_rank(run_genes):
    _, _, ranks = run_genes
    for r in ranks:
        assert str(r["g_refuse_genes"]).startswith("ValueError: "), str(r["g_refuse_genes"])
        assert "1 genes cannot be split over 2 blocks" in str(r["g_refuse_genes"])

"""clonealign_torch.stream (the streaming fit) and the ELBO split it rests
on, against the port's in-core fit and against clonealign_tpu.

Tolerances:
- the split, float64: sum over chunks of elbo_cell_terms plus
  elbo_global_terms equals elbo to rtol 1e-12 (the sums only change
  order); each half against the JAX function on the same parameters and
  draw at rtol 1e-12 in float64 and 1e-5 in float32;
- streamed against in-core, float64 and the same seed: the JAX package's own
  bars (tests/test_stream.py): the same iterations and labels, the trace
  and final ELBO at rtol 1e-11, the parameters and correlations at rtol
  1e-8;
- streamed against the JAX stream on its replayed draws: the bars of
  tests/test_torch_infer.py::test_loop_matches_jax (trace and final ELBO
  rtol 1e-6, gamma atol 1e-5, labels identical): two autodiff systems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from test_torch_infer import JaxKeySchedule

import clonealign_torch as ct
from clonealign_torch import convert
from clonealign_torch import stream as tstream
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.synth import simulate_multinomial
from clonealign_tpu import stream as jstream
from clonealign_tpu.models import multinomial as jmm

torch.set_num_threads(2)

KW64 = dict(max_iter=12, rel_tol=1e-8, dtype="float64", seed=11, verbose=False, device="cpu")
# the in-core fit monitors the training evaluation, as the stream does by default
CORE64 = dict(KW64, elbo_eval="reuse")
PARAMS = ("mu", "clone_probs", "s", "alpha", "psi", "W", "chi")


def _sim(N=75, G=40, C=3, seed=5):
    return simulate_multinomial(N=N, G=G, C=C, seed=seed, mean_total=400)


def _same_fit(strm, core, params=PARAMS, rtol_trace=1e-11):
    assert strm.convergence_info.n_iters == core.convergence_info.n_iters
    np.testing.assert_allclose(strm.convergence_info.elbo, core.convergence_info.elbo,
                               rtol=rtol_trace)
    np.testing.assert_allclose(strm.convergence_info.final_elbo,
                               core.convergence_info.final_elbo, rtol=rtol_trace)
    assert strm.clone == core.clone
    for name in params:
        np.testing.assert_allclose(strm.ml_params[name], core.ml_params[name], rtol=1e-8,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(strm.correlations, core.correlations, rtol=1e-8, equal_nan=True)


# --- the ELBO split --------------------------------------------------------

SPLIT_CONFIGS = {
    "K1": dict(K=1, P=0, fix_alpha=False, impl="xla", allele=False),
    "K0": dict(K=0, P=0, fix_alpha=False, impl="xla", allele=False),
    "K1_P2_allele": dict(K=1, P=2, fix_alpha=True, impl="xla", allele=True),
    "z_cheb_allele": dict(K=1, P=0, fix_alpha=False, impl="z_cheb", allele=True),
}


def _split_case(cfg, np_dtype):
    """The same parameters, data, draw and allele term for both packages."""
    N, C = 50, 3
    sim = _sim(N=N, G=30)
    rng = np.random.default_rng(0)
    K, P = cfg["K"], cfg["P"]
    x = rng.normal(size=(N, P)) if P else None
    jp = jmm.init_params(jnp.asarray(sim.Y, jnp.float64), jnp.asarray(sim.L, jnp.float64),
                         jax.random.PRNGKey(1), K=K, P=P, dtype=jnp.float64)
    params = {f: np.asarray(getattr(jp, f)).astype(np_dtype) for f in jp._fields}
    params["gamma_logits"] = rng.normal(size=(N, C)).astype(np_dtype)
    params["W"] = (0.1 * rng.normal(size=params["W"].shape)).astype(np_dtype)
    params["beta"] = (0.1 * rng.normal(size=(30, P))).astype(np_dtype)
    S = 2
    mu_base = (params["qmu_loc"] + 0.3 * rng.normal(size=(S, 30))).astype(np_dtype)
    extra = (0.1 * rng.normal(size=(N, C))).astype(np_dtype) if cfg["allele"] else None
    return sim, x, params, mu_base, extra, S


@pytest.mark.parametrize("name", list(SPLIT_CONFIGS))
def test_split_identity_and_jax_parity(name):
    cfg = SPLIT_CONFIGS[name]
    for np_dtype, t_dtype, j_dtype, rtol in ((np.float64, torch.float64, jnp.float64, 1e-12),
                                             (np.float32, torch.float32, jnp.float32, 1e-5)):
        sim, x, params, mu_base, extra, S = _split_case(cfg, np_dtype)
        tcfg = tmm.ModelConfig(K=cfg["K"], P=cfg["P"], mc_samples=S, fix_alpha=cfg["fix_alpha"],
                               likelihood_impl=cfg["impl"])
        jcfg = jmm.ModelConfig(K=cfg["K"], P=cfg["P"], mc_samples=S, fix_alpha=cfg["fix_alpha"],
                               likelihood_impl=cfg["impl"])
        tp = convert.params_from_numpy(params, "cpu", t_dtype)
        td = tmm.prepare_data(sim.Y, sim.L, x, device="cpu", dtype=t_dtype)
        jpar = jmm.CloneAlignParams(**{f: jnp.asarray(params[f], j_dtype)
                                       for f in jmm.CloneAlignParams._fields})
        jd = jmm.prepare_data(sim.Y, sim.L, x=x, dtype=j_dtype)
        t_base = torch.tensor(mu_base, dtype=t_dtype)
        t_extra = None if extra is None else torch.tensor(extra, dtype=t_dtype)
        j_extra = None if extra is None else jnp.asarray(extra, j_dtype)

        got = tmm.elbo_global_terms(tp, t_base, tcfg, td.colsum_Y)
        want = jmm.elbo_global_terms(jpar, jnp.asarray(mu_base, j_dtype), jcfg, jd.colsum_Y)
        np.testing.assert_allclose(float(got), float(want), rtol=rtol)
        total = got
        for i, j in [(0, 20), (20, 50)]:
            tpc = tp.replace(psi=tp.psi[i:j], gamma_logits=tp.gamma_logits[i:j])
            tdc = tmm.ModelData(Y=td.Y[i:j], L=td.L, s=td.s[i:j], log_binom=td.log_binom[i:j],
                                YlogL=td.YlogL[i:j], colsum_Y=None,
                                X=None if td.X is None else td.X[i:j])
            cell = tmm.elbo_cell_terms(tpc, tdc, t_base, tcfg,
                                       None if t_extra is None else t_extra[i:j])
            jpc = jpar._replace(psi=jpar.psi[i:j], gamma_logits=jpar.gamma_logits[i:j])
            jdc = jd._replace(Y=jd.Y[i:j], s=jd.s[i:j], log_binom=jd.log_binom[i:j],
                              YlogL=jd.YlogL[i:j], colsum_Y=None,
                              X=None if jd.X is None else jd.X[i:j])
            jcell = jmm.elbo_cell_terms(jpc, jdc, jnp.asarray(mu_base, j_dtype), jcfg,
                                        None if j_extra is None else j_extra[i:j])
            np.testing.assert_allclose(float(cell), float(jcell), rtol=rtol)
            total = total + cell
        if np_dtype is np.float64 and cfg["impl"] == "xla":
            # elbo draws mu_base = qmu_loc + exp(qmu_log_scale) eps; qmu_log_scale is 0
            full = tmm.elbo(tp, td, t_base - tp.qmu_loc, tcfg, t_extra)
            np.testing.assert_allclose(float(total), float(full), rtol=1e-12)


def test_split_identity_z_cheb_one_chunk():
    """Under z_cheb the Chebyshev range is each chunk's own, so the split
    equals elbo exactly when one chunk holds every cell."""
    cfg = SPLIT_CONFIGS["z_cheb_allele"]
    sim, _, params, mu_base, extra, S = _split_case(cfg, np.float64)
    tcfg = tmm.ModelConfig(K=1, mc_samples=S, likelihood_impl="z_cheb")
    tp = convert.params_from_numpy(params, "cpu", torch.float64)
    td = tmm.prepare_data(sim.Y, sim.L, device="cpu", dtype=torch.float64)
    base, ex = torch.tensor(mu_base), torch.tensor(extra)
    total = (tmm.elbo_global_terms(tp, base, tcfg, td.colsum_Y)
             + tmm.elbo_cell_terms(tp, td, base, tcfg, ex))
    full = tmm.elbo(tp, td, base - tp.qmu_loc, tcfg, ex)
    np.testing.assert_allclose(float(total), float(full), rtol=1e-12)


# --- streamed against in-core ----------------------------------------------

@pytest.mark.parametrize("elbo_eval,seed,chunk", [("fresh", 5, 30), ("reuse", 6, 32)])
def test_streamed_equals_incore(elbo_eval, seed, chunk):
    sim = _sim(seed=seed)
    core = ct.clonealign(sim.Y, sim.L, elbo_eval=elbo_eval, **KW64)
    strm = ct.fit_streaming(sim.Y, sim.L, chunk_cells=chunk, elbo_eval=elbo_eval, **KW64)
    _same_fit(strm, core)
    assert set(strm.timings) == {"setup", "init", "inference", "loop", "package"}


def test_chunk_size_invariance():
    sim = _sim(N=61, seed=7)  # 61 is a multiple of no chunk size below
    fits = [ct.fit_streaming(sim.Y, sim.L, chunk_cells=c, **KW64) for c in (61, 25, 7)]
    for other in fits[1:]:
        _same_fit(other, fits[0])


def test_block_row_source_init_equals_the_device_init(monkeypatch):
    """Above _CHUNK_ELEMENTS the PCA and the mu guess read the host rows in
    blocks of _AUX_ELEMENTS (here forced small), as the in-core fit reads
    its device Y in blocks: the same draws, so the same fit."""
    sim = _sim(seed=3)
    monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 11 * sim.Y.shape[1])
    monkeypatch.setattr(tstream, "_AUX_ELEMENTS", 11 * sim.Y.shape[1])
    core = ct.clonealign(sim.Y, sim.L, **CORE64)
    strm = ct.fit_streaming(sim.Y, sim.L, chunk_cells=20, **KW64)
    _same_fit(strm, core)


def test_sparse_input_with_the_gene_filter():
    sim = _sim(seed=8)
    Y = np.asarray(sim.Y).copy()
    Y[:, 3] = 0  # removed by gene_filter_threshold=0
    core = ct.clonealign(Y, sim.L, **CORE64)
    dense = ct.fit_streaming(Y, sim.L, chunk_cells=20, **KW64)
    sparse = ct.fit_streaming(sp.csr_matrix(Y), sim.L, chunk_cells=20, **KW64)
    assert len(dense.retained_genes) == Y.shape[1] - 1
    assert dense.retained_genes == sparse.retained_genes == core.retained_genes
    _same_fit(dense, core)
    _same_fit(sparse, core)


def test_correlations_through_the_row_source():
    """The package step's correlations: device sums over the row source's
    blocks, with the gene filter; a near-constant high-mean gene's float32
    sums cancel, so its column is read again on the host through
    ``_RowSource[:, genes]`` and summed exactly."""
    from clonealign_torch.assign import compute_correlations

    sim = _sim(seed=2)
    Y = np.asarray(sim.Y, np.int16).copy()
    Y[:, 3] = 0          # filtered out
    Y[:, 10] = 3000      # near-constant and high: a suspect column
    Y[::7, 10] = 3001
    keep = Y.sum(axis=0) > 0
    src = tstream._RowSource(Y, keep)
    np.testing.assert_array_equal(src[:, np.array([2, 9])], Y[:, keep][:, [2, 9]])
    rows = tstream._DeviceRows(src, torch.int16, torch.device("cpu"))
    clones = [["clone_a", "clone_b", "clone_c", "unassigned"][i % 4] for i in range(Y.shape[0])]
    names = ["clone_a", "clone_b", "clone_c"]
    L = sim.L[keep]
    want = compute_correlations(Y[:, keep], L, clones, names)
    got = compute_correlations(src, L, clones, names, device_Y=rows, dtype=torch.float32,
                               blocks=tstream._chunk_bounds(Y.shape[0], 11))
    np.testing.assert_allclose(got[9], want[9], rtol=1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, equal_nan=True)


def test_statistics_pass_equals_prepare_data():
    """The stream's statistics: prepare_data's row loop over the row source
    in the stream's blocks, without a device Y, gives prepare_data's
    statistics exactly (a row's sums lie within its block, and the column
    sums of integer counts are exact in float64 in any order)."""
    sim = _sim(seed=13)
    Y = np.asarray(sim.Y, np.int16)
    x = np.random.default_rng(0).normal(size=(Y.shape[0], 2))
    want = tmm.prepare_data(Y, sim.L, x, device="cpu", dtype=torch.float64)
    src = tstream._RowSource(Y, None)
    got = tmm._prepare_rows(src, sim.L, x, src.tensor, device="cpu", dtype=torch.float64,
                            y_storage=torch.int8, check_feasible=True,
                            blocks=tstream._chunk_bounds(Y.shape[0], 11), with_y=False)
    assert got.Y is None
    for name in ("L", "s", "log_binom", "YlogL", "colsum_Y", "X"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0,
                                   msg=name)


def test_feeder_hands_out_each_chunk_intact():
    """On the CPU the feeder fills chunk c + 1 before handing out chunk c,
    into the other buffer: every chunk handed out holds its rows, in order,
    sweep after sweep."""
    Y = np.arange(23 * 4, dtype=np.int16).reshape(23, 4)
    bounds = tstream._chunk_bounds(23, 5)
    feeder = tstream._ChunkFeeder(tstream._RowSource(Y, None), bounds, torch.int16,
                                  torch.device("cpu"))
    for _ in range(2):
        seen = []
        for c, y in feeder.sweep():
            i, j = bounds[c]
            np.testing.assert_array_equal(y.numpy(), Y[i:j])
            seen.append(c)
        assert seen == list(range(len(bounds)))


def test_row_source_reads_a_read_only_map_in_place(tmp_path):
    """A read-only map's rows, and a gene block of its kept columns, reach
    the feeder's buffer from the map itself: the tensor is a view of the
    map, with no copy before the buffer's (a filtered gene inside the
    block makes the one gather copy)."""
    Y = (np.arange(23 * 9) % 101).astype(np.int16).reshape(23, 9)
    m = np.memmap(tmp_path / "counts.dat", dtype=np.int16, mode="w+", shape=Y.shape)
    m[:] = Y
    m.flush()
    ro = np.memmap(tmp_path / "counts.dat", dtype=np.int16, mode="r", shape=Y.shape)
    keep = np.ones(9, bool)
    keep[0] = False
    src = tstream._RowSource(ro, keep, slice(2, 6))  # kept columns 3-6
    t = src.tensor(4, 11)
    assert np.shares_memory(t.numpy(), ro)
    np.testing.assert_array_equal(t.numpy(), Y[4:11, 3:7])
    np.testing.assert_array_equal(src[2:5, [0, 3]], Y[2:5][:, [3, 6]])
    keep[4] = False  # a dropped gene inside the block: its kept columns gathered
    t = tstream._RowSource(ro, keep, slice(2, 6)).tensor(4, 11)
    np.testing.assert_array_equal(t.numpy(), Y[4:11][:, [3, 5, 6, 7]])
    feeder = tstream._ChunkFeeder(src, tstream._chunk_bounds(23, 5), torch.int8,
                                  torch.device("cpu"))
    for c, y in feeder.sweep():
        i, j = feeder.bounds[c]
        np.testing.assert_array_equal(y.numpy(), Y[i:j, 3:7].astype(np.int8))


def test_memmap_input(tmp_path):
    """A read-only np.memmap streams without being loaded whole."""
    sim = _sim(seed=9)
    Y = np.asarray(sim.Y, np.int16)
    m = np.memmap(tmp_path / "counts.dat", dtype=np.int16, mode="w+", shape=Y.shape)
    m[:] = Y
    m.flush()
    ro = np.memmap(tmp_path / "counts.dat", dtype=np.int16, mode="r", shape=Y.shape)
    _same_fit(ct.fit_streaming(ro, sim.L, chunk_cells=25, **KW64), ct.clonealign(Y, sim.L, **CORE64))


def test_covariates_and_allele_chunked():
    sim = _sim(seed=10)
    N, C = sim.Y.shape[0], sim.L.shape[1]
    rng = np.random.RandomState(3)
    V = 12
    kw = dict(x=rng.normal(size=(N, 2)), clone_allele=rng.randint(1, 4, size=(V, C)).astype(float),
              **KW64)
    cov = rng.poisson(5.0, size=(N, V)).astype(float)
    kw.update(cov=cov, ref=np.minimum(rng.poisson(2.0, size=(N, V)).astype(float), cov))
    core = ct.clonealign(sim.Y, sim.L, elbo_eval="fresh", **kw)
    strm = ct.fit_streaming(sim.Y, sim.L, chunk_cells=30, elbo_eval="fresh", **kw)
    _same_fit(strm, core, params=PARAMS + ("beta",))
    np.testing.assert_allclose(strm.clone_probs_from_snv, core.clone_probs_from_snv, rtol=1e-10)


def test_k0():
    sim = _sim(seed=12)
    core = ct.clonealign(sim.Y, sim.L, K=0, **CORE64)
    strm = ct.fit_streaming(sim.Y, sim.L, K=0, chunk_cells=20, **KW64)
    _same_fit(strm, core, params=("mu", "clone_probs", "s", "alpha"))
    assert "psi" not in strm.ml_params


def test_z_cheb():
    """One chunk: the in-core z_cheb fit. Chunks: each fits its own
    Chebyshev range, and the labels and final ELBO (exact either way) stay
    those of the exact stream (the JAX package's bar, rtol 1e-3)."""
    sim = _sim(seed=14)
    kw = dict(KW64, max_iter=15)
    core = ct.clonealign(sim.Y, sim.L, likelihood_impl="z_cheb", **dict(CORE64, max_iter=15))
    one = ct.fit_streaming(sim.Y, sim.L, chunk_cells=sim.Y.shape[0], likelihood_impl="z_cheb",
                           **kw)
    _same_fit(one, core)
    exact = ct.fit_streaming(sim.Y, sim.L, chunk_cells=30, **kw)
    cheb = ct.fit_streaming(sim.Y, sim.L, chunk_cells=30, likelihood_impl="z_cheb", **kw)
    assert cheb.clone == exact.clone
    np.testing.assert_allclose(cheb.convergence_info.final_elbo,
                               exact.convergence_info.final_elbo, rtol=1e-3)


# --- against the JAX stream -------------------------------------------------

class JaxStreamKeys(JaxKeySchedule):
    """The draws of clonealign_tpu.stream.fit_streaming(seed=...): PCA test
    matrix and psi jitter from the init keys, then the loop's schedule."""

    def __init__(self, seed):
        k_init, k_fit = jax.random.split(jax.random.PRNGKey(seed))
        self.k_pca, self.k_jitter = jax.random.split(k_init)
        super().__init__(k_fit)

    def normal(self, what, shape, dtype, device):
        key = {"pca_omega": getattr(self, "k_pca", None),
               "psi_jitter": getattr(self, "k_jitter", None)}.get(what)
        if key is None:
            return super().normal(what, shape, dtype, device)
        return torch.tensor(np.asarray(jax.random.normal(key, tuple(shape), jnp.float64)),
                            dtype=dtype, device=device)


@pytest.mark.parametrize("elbo_eval", ["reuse", "fresh"])
def test_matches_the_jax_stream(elbo_eval, monkeypatch):
    """The PCA scores' sign is arbitrary, and the two packages' SVDs may
    return opposite ones: the port's scores, checked equal to the JAX
    package's up to sign (rtol 1e-8), take the JAX package's sign, so both
    fits start from the same psi."""
    sim = _sim(seed=4)
    port_pca = tmm.randomized_pca

    def aligned_pca(X, k, noise, **kwargs):
        got = port_pca(X, k, noise, **kwargs)
        want = torch.tensor(np.asarray(jmm.randomized_pca(jnp.asarray(X.numpy()), k,
                                                          noise.k_pca, **kwargs)))
        sign = torch.sign(torch.sum(got * want, dim=0))
        np.testing.assert_allclose((got * sign).numpy(), want.numpy(), rtol=1e-8, atol=1e-10)
        return got * sign

    monkeypatch.setattr(tmm, "randomized_pca", aligned_pca)
    kw = dict(chunk_cells=30, max_iter=25, rel_tol=1e-8, dtype="float64", verbose=False,
              elbo_eval=elbo_eval)
    want = jstream.fit_streaming(sim.Y, sim.L, seed=11, y_storage=None, **kw)
    got = ct.fit_streaming(sim.Y, sim.L, noise=JaxStreamKeys(11), device="cpu", **kw)
    n = want.convergence_info.n_iters
    assert got.convergence_info.n_iters == n
    np.testing.assert_allclose(got.convergence_info.elbo, want.convergence_info.elbo, rtol=1e-6)
    np.testing.assert_allclose(got.convergence_info.final_elbo,
                               want.convergence_info.final_elbo, rtol=1e-6)
    np.testing.assert_allclose(got.ml_params["clone_probs"], want.ml_params["clone_probs"],
                               atol=1e-5)
    assert got.clone == want.clone


# --- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("kwargs,error,match", [
    (dict(mesh=object()), TypeError, "make_mesh"),
    (dict(likelihood_impl="fused"), ValueError, "fused"),
    (dict(likelihood_impl="bogus"), ValueError, "likelihood_impl"),
    (dict(key=object()), ValueError, "key"),
    (dict(elbo_eval="bogus"), ValueError, "elbo_eval"),
    (dict(chunk_cells=0), ValueError, "chunk_cells"),
    (dict(y_storage="int32"), ValueError, "y_storage"),
])
def test_refusals(kwargs, error, match):
    sim = _sim(N=20, G=10, seed=15)
    with pytest.raises(error, match=match):
        ct.fit_streaming(sim.Y, sim.L, verbose=False, device="cpu", **kwargs)
    if "mesh" not in kwargs and "key" not in kwargs:
        with pytest.raises(error, match=match):  # the JAX package's message
            jstream.fit_streaming(sim.Y, sim.L, verbose=False, **kwargs)


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sim = _sim(N=20, G=10, seed=15)
    with pytest.raises(RuntimeError, match="cuda"):
        ct.fit_streaming(sim.Y, sim.L, verbose=False)


def test_verbose_messages(capsys):
    sim = _sim(N=30, G=15, seed=16)
    ct.fit_streaming(sim.Y, sim.L, chunk_cells=10, max_iter=3, seed=1, device="cpu")
    out = capsys.readouterr().out
    assert "Constructing model" in out
    assert "Streaming 30 cells x 15 genes in 3 chunks of 10 (int8 transfer)" in out
    assert "Optimizing ELBO" in out


def test_chunk_cells_auto():
    assert tstream._resolve_chunk_cells("auto", 100_000, 5_000) == (1 << 26) // 5_000
    assert tstream._resolve_chunk_cells(None, 500, 100_000) == 500  # max(1024, ...) capped at N
    assert tstream._chunk_bounds(10, 4) == [(0, 4), (4, 8), (8, 10)]

"""Sparse count input (a scipy CSR, CSC or COO matrix, or an AnnData-style
object with a sparse ``.X``) in clonealign_torch against the JAX package and
against the port's own dense path, on identical numpy inputs.

``models/multinomial.prepare_data_sparse`` densifies one block of CSR rows
at a time into the device buffer and takes each block's statistics on the
device, as for dense input; the JAX package takes them on the host from the
sparse structure in float64. So the port's sparse data equals its dense data
exactly, and the JAX package's to float64 rounding (rtol 1e-12). A sparse
fit equals the port's dense fit exactly, and the JAX package's fit of the
same CSR at the API bars of test_torch_covariates.py (K = 0 with the JAX key
schedule's draws: the ELBO trace and final ELBO rtol 1e-6, labels exact).
The correlations are held to the dense host route at rtol 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_infer import JaxKeySchedule

import clonealign_tpu as ca
import clonealign_torch as ct
from clonealign_tpu import assign as jassign
from clonealign_tpu.models import multinomial as jmm
from clonealign_torch import api as tapi
from clonealign_torch.assign import compute_correlations
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.synth import simulate_multinomial

sp = pytest.importorskip("scipy.sparse")

torch.set_num_threads(2)

F64 = torch.float64
STORAGES = {None: None, "int8": (torch.int8, jnp.int8), "int16": (torch.int16, jnp.int16),
            "bfloat16": (torch.bfloat16, jnp.bfloat16)}
FIELDS = ("Y", "L", "s", "log_binom", "YlogL", "colsum_Y")
LOOP = dict(max_iter=40, rel_tol=0.02)


def _sim(N=70, G=45, C=3, seed=0):
    """int16 counts with a zero-copy-number gene that some cells express
    (-inf YlogL in that clone) and an all-zero gene."""
    sim = simulate_multinomial(N=N, G=G, C=C, seed=seed, mean_total=300)
    Y, L = sim.Y.astype(np.int16), sim.L.copy()
    L[2, 0] = 0.0
    Y[:, 5] = 0
    Y[Y.sum(axis=1) == 0, 1] = 1
    return Y, L, sim.clone_idx


def _formats(Y):
    return {"csr": sp.csr_matrix(Y), "csc": sp.csc_matrix(Y), "coo": sp.coo_matrix(Y)}


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("storage", list(STORAGES))
@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_prepare_data_sparse_matches_jax(monkeypatch, fmt, storage, chunked):
    """Every ModelData field against the JAX package's sparse prepare and
    exactly against the port's dense prepare; ``chunked`` takes N over
    several row blocks (7 rows a block)."""
    Y, L, _ = _sim()
    if chunked:
        monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 7 * Y.shape[1])
        assert len(tmm._row_blocks(*Y.shape)) == 10
    t_store, j_store = STORAGES[storage] or (None, None)
    Ys = _formats(Y)[fmt]
    got = tmm.prepare_data_sparse(Ys, L, device="cpu", dtype=F64, y_storage=t_store,
                                  check_feasible=False)
    want = jmm.prepare_data_sparse(Ys, L, dtype=jnp.float64, y_storage=j_store)
    dense = tmm.prepare_data(Y, L, device="cpu", dtype=F64, y_storage=t_store,
                             check_feasible=False)
    assert got.Y.dtype == (t_store or F64) and got.X is None
    for name in FIELDS:
        g = getattr(got, name).double().numpy()
        np.testing.assert_allclose(g, np.asarray(getattr(want, name), np.float64), rtol=1e-12,
                                   err_msg=name)
        np.testing.assert_array_equal(g, getattr(dense, name).double().numpy(), err_msg=name)
    assert np.isneginf(got.YlogL[:, 0].numpy()).any()
    # prepare_data dispatches a scipy matrix to the sparse prepare
    again = tmm.prepare_data(Ys, L, device="cpu", dtype=F64, y_storage=t_store,
                             check_feasible=False)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(again, name).double().numpy(),
                                      getattr(got, name).double().numpy(), err_msg=name)


def test_prepare_data_sparse_coo_float_counts_and_covariates():
    """COO of float64 counts, int8 storage (checked and narrowed on the
    host block by block), with covariates."""
    Y, L, _ = _sim(seed=1)
    x = np.random.default_rng(0).normal(size=(Y.shape[0], 2))
    got = tmm.prepare_data(sp.coo_matrix(Y.astype(np.float64)), L, x, device="cpu", dtype=F64,
                           y_storage=torch.int8, check_feasible=False)
    want = tmm.prepare_data(Y, L, x, device="cpu", dtype=F64, y_storage=torch.int8,
                            check_feasible=False)
    for name in FIELDS + ("X",):
        np.testing.assert_array_equal(getattr(got, name).double().numpy(),
                                      getattr(want, name).double().numpy(), err_msg=name)


def test_prepare_data_sparse_refuses_what_integer_storage_cannot_hold():
    Y, L, _ = _sim()
    big = Y.astype(np.int32)
    big[3, 4] = 300
    with pytest.raises(ValueError, match="cannot hold the largest count"):
        tmm.prepare_data_sparse(sp.csr_matrix(big), L, device="cpu", y_storage=torch.int8)
    frac = Y.astype(np.float64)
    frac[3, 4] = 2.5
    with pytest.raises(ValueError, match="fractional"):
        tmm.prepare_data_sparse(sp.csr_matrix(frac), L, device="cpu", y_storage=torch.int16)


@pytest.mark.parametrize("fmt", ["csr", "csc", "coo"])
def test_sparse_fit_equals_the_dense_fit(fmt):
    Y, L, _ = _sim(seed=2)
    kw = dict(max_iter=30, seed=4, device="cpu", verbose=False, gene_filter_threshold=0)
    dense = ct.clonealign(Y, L, **kw)
    got = ct.clonealign(_formats(Y)[fmt], L, **kw)
    assert got.retained_genes == dense.retained_genes and len(got.retained_genes) == 44
    np.testing.assert_array_equal(got.convergence_info.elbo, dense.convergence_info.elbo)
    assert got.convergence_info.final_elbo == dense.convergence_info.final_elbo
    assert got.clone == dense.clone
    np.testing.assert_array_equal(got.ml_params["s"], dense.ml_params["s"])
    assert got.ml_params["s"].dtype == np.float64
    np.testing.assert_array_equal(got.correlations, dense.correlations)


def test_sparse_fit_matches_jax_on_the_same_csr():
    """K = 0 with the JAX key schedule's draws (the fit draws only the
    loop's noise): the same iterations, ELBO trace, final ELBO and labels."""
    Y, L, _ = _sim(N=80, G=50, seed=8)
    Ys = sp.csr_matrix(Y)
    kw = dict(K=0, max_iter=60, dtype="float64", verbose=False)
    want = ca.clonealign(Ys, L, seed=3, **kw)
    k_fit = jax.random.split(jax.random.PRNGKey(3))[1]
    got = ct.clonealign(Ys, L, noise=JaxKeySchedule(k_fit), device="cpu", **kw)
    assert got.retained_genes == want.retained_genes
    assert got.convergence_info.n_iters == want.convergence_info.n_iters
    np.testing.assert_allclose(got.convergence_info.elbo, want.convergence_info.elbo, rtol=1e-6)
    np.testing.assert_allclose(got.convergence_info.final_elbo,
                               want.convergence_info.final_elbo, rtol=1e-6)
    assert got.clone == want.clone
    np.testing.assert_array_equal(got.ml_params["s"], want.ml_params["s"])
    np.testing.assert_allclose(got.correlations, want.correlations, rtol=1e-9, equal_nan=True)


class _AnnData:
    """The AnnData duck-type: ``.X``, ``.var_names``, ``.obs_names``."""

    def __init__(self, X):
        self.X = X
        self.var_names = [f"gene_{j}" for j in range(X.shape[1])]
        self.obs_names = [f"cell_{i}" for i in range(X.shape[0])]


def test_anndata_with_sparse_x():
    Y, L, _ = _sim(seed=3)
    ad = _AnnData(sp.csr_matrix(Y))
    parsed, genes, cells = tapi._parse_expression(ad)
    assert sp.issparse(parsed) and parsed.format == "csr"
    assert genes == ad.var_names and cells == ad.obs_names
    kw = dict(max_iter=10, seed=1, device="cpu", verbose=False)
    got = ct.clonealign(ad, L, **kw)
    dense = ct.clonealign(Y, L, **kw)
    assert got.retained_genes == [g for j, g in enumerate(ad.var_names) if j != 5]
    assert got.convergence_info.final_elbo == dense.convergence_info.final_elbo
    assert got.clone == dense.clone


@pytest.mark.parametrize("bad,match", [
    ("nan", "NaN"), ("negative", "non-negative raw counts"),
    ("fractional", "raw integer counts"), ("zero_cell", "no counts"),
])
def test_bad_sparse_counts_raise_as_the_jax_package(bad, match):
    Y, L, _ = _sim()
    Y = Y.astype(np.float64)
    if bad == "nan":
        Y[1, 1] = np.nan
    elif bad == "negative":
        Y[0, 0] = -129  # would wrap positive in an int8 cast
    elif bad == "fractional":
        Y[2, 3] = 1.5
    else:
        Y[3] = 0
    Ys = sp.csr_matrix(Y)
    assert Ys.nnz and (bad == "zero_cell" or np.isnan(Ys.data).any() or (Ys.data != 0).all())
    with pytest.raises(ValueError, match=match) as want:
        ca.api.setup_fit(Ys, L, verbose=False)
    with pytest.raises(ValueError, match=match) as got:
        tapi.setup_fit(Ys, L, verbose=False, device="cpu")
    assert str(got.value) == str(want.value)
    if bad == "fractional":  # allow_fractional keeps the float counts
        ctx = tapi.setup_fit(Ys, L, verbose=False, device="cpu", allow_fractional=True)
        assert ctx.data.Y.dtype == torch.float32


def test_sparse_gene_filter_and_auto_storage():
    """The filter slices the CSR's columns; "auto" reads the stored values."""
    Y, L, _ = _sim()
    ctx = tapi.setup_fit(sp.csr_matrix(Y), L, gene_filter_threshold=30, verbose=False,
                         device="cpu")
    keep = Y.sum(axis=0) > 30
    assert sp.issparse(ctx.Y) and ctx.Y.shape == (Y.shape[0], keep.sum())
    np.testing.assert_array_equal(ctx.Y.toarray(), Y[:, keep])
    np.testing.assert_array_equal(ctx.L, np.minimum(L[keep], 6.0))
    assert ctx.retained_genes == list(np.flatnonzero(keep))
    assert ctx.data.Y.dtype == torch.int8  # every count <= 127
    assert tapi._colsum_f64(sp.csr_matrix(Y)).dtype == np.float64
    np.testing.assert_array_equal(tapi._colsum_f64(sp.csr_matrix(Y)), Y.sum(axis=0))


def _corr_inputs():
    """Counts with a near-constant high-count column (suspect on the device
    route: its variance is a tiny fraction of its sum of squares), clone
    labels with unassigned cells."""
    Y, L, z = _sim(N=90, seed=5)
    Y = Y.astype(np.int32)
    Y[:, 9] = 1000 + (np.arange(Y.shape[0]) % 2)
    names = ["a", "b", "c"]
    clones = [names[c] for c in z]
    clones[4] = clones[11] = "unassigned"
    return Y, L, clones, names


@pytest.mark.parametrize("route", ["host", "device"])
def test_compute_correlations_sparse(route):
    Y, L, clones, names = _corr_inputs()
    dense = compute_correlations(Y, L, clones, names)
    want = jassign.compute_correlations(sp.csr_matrix(Y), L, clones, names)
    for fmt, Ys in _formats(Y).items():
        device_Y = torch.tensor(Y, dtype=F64) if route == "device" else None
        got = compute_correlations(Ys, L, clones, names, device_Y=device_Y, dtype=F64)
        np.testing.assert_allclose(got, dense, rtol=1e-12, equal_nan=True, err_msg=fmt)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-12, equal_nan=True,
                                   err_msg=fmt)
    assert np.isnan(dense[5]) and np.isfinite(dense[9])


def test_compute_correlations_device_route_recomputes_the_suspect_column_from_the_csr():
    """With float32 device sums the near-constant column's variance cancels;
    the suspect recompute slices the CSR's column and sums it exactly."""
    Y, L, clones, names = _corr_inputs()
    dense = compute_correlations(Y, L, clones, names)
    got = compute_correlations(sp.csr_matrix(Y), L, clones, names,
                               device_Y=torch.tensor(Y, dtype=torch.int16))
    np.testing.assert_allclose(got[9], dense[9], rtol=1e-12)
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6, equal_nan=True)


@pytest.mark.parametrize("batching", ["map", "vmap"])
def test_run_clonealign_on_a_csr(batching):
    Y, L, _ = _sim(N=50, G=40, C=2)
    kw = dict(initial_shrinks=(0, 5), n_repeats=2, seed=2, device="cpu", dtype="float64",
              print_elbos=False, verbose=False, restart_batching=batching, **LOOP)
    dense = ct.run_clonealign(Y, L, **kw)
    got = ct.run_clonealign(sp.csr_matrix(Y), L, **kw)
    assert got.timings["iterations"] == dense.timings["iterations"]
    np.testing.assert_array_equal(got.multirun_info["elbos"], dense.multirun_info["elbos"])
    np.testing.assert_array_equal(got.multirun_info["median_correlations"],
                                  dense.multirun_info["median_correlations"])
    assert got.clone == dense.clone


def _with_duplicates(Y, extra):
    """A non-canonical int64 CSR of Y whose cell 0, gene 0 also stores each
    value of ``extra`` as an entry of its own: its dense counts are Y plus
    their sum there."""
    m = sp.csr_matrix(Y.astype(np.int64))
    data = np.concatenate([np.asarray(extra, np.int64), m.data])
    indices = np.concatenate([np.zeros(len(extra), m.indices.dtype), m.indices])
    indptr = m.indptr + np.r_[0, np.full(Y.shape[0], len(extra))]
    out = sp.csr_matrix((data, indices, indptr), shape=Y.shape)
    assert not out.has_canonical_format
    return out


@pytest.mark.parametrize("extra,count", [
    ((100, 100), 202),  # summed past int8: "auto" must pick int16
    ((-3, 5), 4),       # a negative entry in a valid count
])
def test_non_canonical_csr_fits_as_its_dense_counts(extra, count):
    """A CSR is checked and typed by its summed counts, from a copy: the
    caller's indptr, indices and data are left as they were."""
    sim = simulate_multinomial(N=40, G=30, C=3, seed=2, mean_total=300)
    Y = sim.Y.astype(np.int64)
    Y[0, 0] = 2
    m = _with_duplicates(Y, extra)
    dense = m.toarray()
    assert dense[0, 0] == count
    before = [a.copy() for a in (m.indptr, m.indices, m.data)]
    kw = dict(max_iter=20, seed=4, device="cpu", verbose=False)
    got = ct.clonealign(m, sim.L, **kw)
    want = ct.clonealign(dense, sim.L, **kw)
    assert got.clone == want.clone
    assert got.convergence_info.final_elbo == want.convergence_info.final_elbo
    for a, b in zip(before, (m.indptr, m.indices, m.data)):
        np.testing.assert_array_equal(a, b)
    ctx = tapi.setup_fit(m, sim.L, verbose=False, device="cpu")
    assert ctx.data.Y.dtype == (torch.int16 if count > 127 else torch.int8)

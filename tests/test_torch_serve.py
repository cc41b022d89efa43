"""clonealign_torch.serve against clonealign_tpu.serve, scoring new cells
against one fitted model: a JAX fit, carried over by
``convert.fit_from_numpy``.

Tolerances: the log-posteriors on the same inputs in float64, rtol 1e-10
(one product); the Newton refinement's in float32, because the JAX
function keeps its Newton state in float32 whatever its inputs
(serve.py:104: a float64 run fails its scan's carry check), at rtol 1e-6
of each log-posterior (a few float32 ulps of sums over 10^3 counts);
assign_cells in float32, the probabilities
within atol 1e-5 ("ignore") and 1e-4 ("refine", "auto"), and the same
labels except where the largest probability is within 0.01 of the
threshold. Held-out accuracy and agreement with the fit's own calls: the
bars of tests/test_serve.py (> 0.95).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clonealign_torch as ct
from clonealign_torch import convert
from clonealign_torch import serve as tserve
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.synth import simulate_multinomial
from clonealign_tpu import clonealign as jclonealign
from clonealign_tpu import serve as jserve

torch.set_num_threads(2)

THRESHOLD = 0.95


@pytest.fixture(scope="module")
def split_fit():
    """A K = 1 JAX fit on 200 cells; 100 held out."""
    sim = simulate_multinomial(N=300, G=100, C=3, K=1, seed=8, mean_total=1500)
    jfit = jclonealign(sim.Y[:200], sim.L, max_iter=120, seed=0, verbose=False)
    return sim, jfit, convert.fit_from_numpy(jfit)


def _inputs(sim, fit, dtype):
    L = np.minimum(sim.L, 6.0)
    L[7, 1] = 0.0  # a zero rate: cells expressing gene 7 cannot be clone 1
    alpha = np.asarray(fit.ml_params["alpha"], np.float64)
    return dict(Y=np.asarray(sim.Y[200:]), L=L.astype(dtype),
                mu=np.asarray(fit.ml_params["mu"]).astype(dtype),
                log_alpha=np.log(alpha / alpha.sum()).astype(dtype),
                W=np.asarray(fit.ml_params["W"]).astype(dtype))


def test_fit_from_numpy_copies_the_jax_fit(split_fit):
    _, jfit, tfit = split_fit
    assert isinstance(tfit, ct.ClonealignFit)
    assert tfit.clone == jfit.clone and tfit.clone_names == jfit.clone_names
    for k, v in jfit.ml_params.items():
        np.testing.assert_array_equal(tfit.ml_params[k], v)
        assert tfit.ml_params[k] is not v
    assert tfit.convergence_info.n_iters == jfit.convergence_info.n_iters


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("refined,dtype,rtol", [(False, np.float64, 1e-10),
                                                (True, np.float32, 1e-6)])
def test_log_posteriors_match_jax(split_fit, monkeypatch, chunked, refined, dtype, rtol):
    sim, jfit, _ = split_fit
    x = _inputs(sim, jfit, dtype)
    if chunked:  # row blocks of 7 cells: the products and the Newton solve
        monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 7 * x["Y"].shape[1])
    j = {k: jnp.asarray(v, dtype) for k, v in x.items()}
    t = {k: torch.tensor(v) for k, v in x.items() if k != "Y"}
    t["Y"] = torch.tensor(x["Y"].astype(np.int16))  # stored narrow, as served
    if refined:
        want = jserve._posterior_log_probs_refined(j["Y"], j["L"], j["mu"], j["log_alpha"],
                                                   j["W"], newton_iters=8)
        got = tserve._posterior_log_probs_refined(t["Y"], t["L"], t["mu"], t["log_alpha"],
                                                  t["W"], newton_iters=8)
    else:
        want = jserve._posterior_log_probs(j["Y"], j["L"], j["mu"], j["log_alpha"])
        got = tserve._posterior_log_probs(t["Y"], t["L"], t["mu"], t["log_alpha"])
    want = np.asarray(want)
    assert got.numpy().dtype == dtype and np.isneginf(want[:, 1]).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)


@pytest.mark.parametrize("latent,atol", [("ignore", 1e-5), ("refine", 1e-4), ("auto", 1e-4)])
def test_assign_cells_matches_jax(split_fit, latent, atol):
    sim, jfit, tfit = split_fit
    Y = sim.Y[200:]
    want_clones, want = jserve.assign_cells(jfit, Y, sim.L, latent=latent)
    got_clones, got = ct.assign_cells(tfit, Y, sim.L, latent=latent, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol)
    near = np.abs(np.max(want, axis=1) - THRESHOLD) < 0.01
    differ = np.asarray(got_clones) != np.asarray(want_clones)
    assert not (differ & ~near).any()


def test_heldout_accuracy_and_agreement_with_the_fit(split_fit):
    sim, _, tfit = split_fit
    for latent in ("ignore", "refine"):
        clones, probs = ct.assign_cells(tfit, sim.Y[200:], sim.L, latent=latent, device="cpu")
        index = {c: i for i, c in enumerate(tfit.clone_names)}
        called = np.asarray([index.get(c, -1) for c in clones])
        assert np.mean(called == sim.clone_idx[200:]) > 0.95, latent
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
        train, _ = ct.assign_cells(tfit, sim.Y[:200], sim.L, latent=latent, device="cpu")
        fit_calls, serve_calls = np.asarray(tfit.clone), np.asarray(train)
        both = (fit_calls != "unassigned") & (serve_calls != "unassigned")
        assert (fit_calls[both] == serve_calls[both]).mean() > 0.95, latent


def _split_entries(Y):
    """A non-canonical CSR of Y: every count stored as two entries whose sum
    it is, the first at its own position out of order."""
    rows, cols = np.nonzero(Y)
    vals = Y[rows, cols].astype(np.int64)
    half = vals // 2
    order = np.lexsort((-cols, rows))  # columns descending within a row
    rows2 = np.concatenate([rows[order], rows])
    cols2 = np.concatenate([cols[order], cols])
    vals2 = np.concatenate([half[order], vals - half])
    order = np.argsort(rows2, kind="stable")
    indptr = np.searchsorted(rows2[order], np.arange(Y.shape[0] + 1))
    m = sp.csr_matrix((vals2[order], cols2[order], indptr), shape=Y.shape)
    assert not m.has_canonical_format
    return m


def test_sparse_input_equals_dense_and_is_left_untouched(split_fit):
    sim, _, tfit = split_fit
    Y = np.asarray(sim.Y[200:], np.int64)
    want_clones, want = ct.assign_cells(tfit, Y, sim.L, device="cpu")
    for m in (sp.csr_matrix(Y), _split_entries(Y), sp.coo_matrix(Y)):
        before = [a.copy() for a in ((m.indptr, m.indices, m.data) if m.format == "csr"
                                     else (m.row, m.col, m.data))]
        clones, probs = ct.assign_cells(tfit, m, sim.L, device="cpu")
        np.testing.assert_array_equal(probs, want)
        assert clones == want_clones
        after = (m.indptr, m.indices, m.data) if m.format == "csr" else (m.row, m.col, m.data)
        for a, b in zip(before, after):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad,match", [
    ("nan", "NaN"), ("negative", "non-negative"), ("negative_int", "non-negative"),
    ("fractional", "raw integer counts"), ("empty_int", "no counts"),
    ("sparse_negative", "non-negative"),
])
def test_bad_counts_raise(split_fit, bad, match):
    """Beyond the reference, which scores such counts (serve.py:189-196)."""
    sim, _, tfit = split_fit
    Y = np.array(sim.Y[200:210], np.float64)
    if bad == "nan":
        Y[1, 1] = np.nan
    elif bad in ("negative", "sparse_negative"):
        Y[0, 0] = -3
    elif bad == "negative_int":
        Y = Y.astype(np.int16)
        Y[0, 0] = -129  # would wrap positive in an int8 transfer
    elif bad == "fractional":
        Y[2, 3] = 1.5
    else:
        Y = Y.astype(np.int16)
        Y[4] = 0
    if bad == "sparse_negative":
        Y = sp.csr_matrix(Y)
    with pytest.raises(ValueError, match=match):
        ct.assign_cells(tfit, Y, sim.L, device="cpu")


def test_sparse_entries_are_checked_by_their_sums(split_fit):
    """Stored entries -2 and 5 at one position are the count 3."""
    sim, _, tfit = split_fit
    Y = np.array(sim.Y[200:210], np.int64)
    m = _split_entries(Y)
    pos = np.flatnonzero((m.indices == m.indices[0]) & (np.arange(m.nnz) < m.indptr[1]))
    count = m.data[pos].sum()
    m.data[pos] = (-2, count + 2)  # the pair still sums to the count
    assert (m.data < 0).any()
    _, got = ct.assign_cells(tfit, m, sim.L, device="cpu")
    _, want = ct.assign_cells(tfit, Y, sim.L, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_messages_match_jax(split_fit):
    sim, jfit, tfit = split_fit
    G = len(tfit.ml_params["mu"])
    k0_t = dataclasses.replace(tfit, ml_params={k: v for k, v in tfit.ml_params.items()
                                                if k not in ("W", "psi", "chi")})
    k0_j = dataclasses.replace(jfit, ml_params=dict(k0_t.ml_params))
    for fits, args, kw in (
            ((jfit, tfit), (np.ones((5, 3)), np.ones((3, 3))), {}),
            ((jfit, tfit), (np.ones((5, G)),), {}),
            ((jfit, tfit), (np.ones((5, G)), sim.L), dict(latent="bogus")),
            ((k0_j, k0_t), (np.ones((5, G)), sim.L), dict(latent="refine"))):
        with pytest.raises(ValueError) as want:
            jserve.assign_cells(fits[0], *args, **kw)
        with pytest.raises(ValueError) as got:
            ct.assign_cells(fits[1], *args, device="cpu", **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("values,want", [
    ([[1, 5]], torch.int8), ([[1, 200]], torch.int16), ([[1, 40000]], torch.float32),
    ([[1.0, 2.0]], torch.int8), ([[1.5, 2.0]], torch.float32), ([[1.0, -200.0]], torch.float32),
    ([[1, -2]], torch.float32),
])
def test_transfer_storage(values, want):
    assert tserve._transfer_storage(np.asarray(values)) == want


def test_duplicates_that_sum_past_int8_ship_int16(split_fit):
    """Two stored 100s at one position are the count 200: int16, not a
    wrapped int8 (the wire type is read from the summed counts)."""
    sim, _, tfit = split_fit
    Y = np.array(sim.Y[200:240], np.int64)
    Y[0, 0] = 200
    m = sp.csr_matrix(Y)
    data, indices = m.data.copy(), m.indices.copy()
    dup = sp.csr_matrix((np.concatenate([[100, 100], data[1:]]),
                         np.concatenate([[0, 0], indices[1:]]),
                         m.indptr + np.r_[0, np.ones(len(m.indptr) - 1, int)]), shape=Y.shape)
    assert dup.data.max() == 100 and dup.toarray()[0, 0] == 200
    canon = tserve._canonical_csr(dup)
    assert tserve._transfer_storage(canon.data) == torch.int16
    rows = tserve._DeviceRows(tserve._RowSource(canon, None), torch.int16, torch.device("cpu"))
    assert rows[0:1][0, 0] == 200
    _, got = ct.assign_cells(tfit, dup, sim.L, device="cpu")
    _, want = ct.assign_cells(tfit, Y, sim.L, device="cpu")
    np.testing.assert_array_equal(got, want)


def test_cuda_without_a_gpu_raises(split_fit, monkeypatch):
    sim, _, tfit = split_fit
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ct.assign_cells(tfit, sim.Y[200:], sim.L)

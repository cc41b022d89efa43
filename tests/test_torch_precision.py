"""clonealign_torch's narrow count storage (``y_storage``) on the CPU, against
the JAX package's (the cases of tests/test_precision.py, and the same numpy
inputs through both packages).

Tolerance: integer storage is exact, so a fit with int16 or int8 Y equals
the float32-storage fit bit for bit, and the stored Y equals the JAX
package's exactly. The data statistics are held to the JAX package's at
rtol 1e-12 in float64 (the JAX package gathers log(y!) from a table where
the port calls lgamma, and sums in other orders); the row-blocked passes
(PCA, mu guess, products with Y) to their one-block versions at the
tolerances of tests/test_torch_multinomial.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clonealign_torch as ct
from clonealign_tpu import api as japi
from clonealign_tpu.models import multinomial as jmm
from clonealign_torch import api as tapi
from clonealign_torch import restarts as trestarts
from clonealign_torch.assign import _clone_sums_device
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.ops import fused_likelihood as tfl
from clonealign_torch.synth import simulate_multinomial

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
# y_storage name -> (the port's dtype, the JAX package's)
STORE = {None: (None, None), "int16": (torch.int16, jnp.int16), "int8": (torch.int8, jnp.int8),
         "bfloat16": (torch.bfloat16, jnp.bfloat16)}
STATS = ("s", "log_binom", "YlogL", "colsum_Y")


class _Draws:
    """A noise source that returns the arrays it was given, by name."""

    def __init__(self, **draws):
        self.draws = {k: list(v) for k, v in draws.items()}

    def normal(self, what, shape, dtype, device):
        out = torch.tensor(np.asarray(self.draws[what].pop(0)), dtype=dtype, device=device)
        assert tuple(out.shape) == tuple(shape), (what, out.shape, shape)
        return out


def _name(dtype):
    """"int8", "bfloat16", ... for a torch or JAX dtype; None stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return jnp.dtype(dtype).name


def _counts(N, G, seed, large=False, dtype=np.float64):
    rng = np.random.default_rng(seed)
    Y = rng.poisson(4.0, (N, G))
    Y[Y.sum(axis=1) == 0, 0] = 1
    if large:  # counts a bfloat16 rounds, int16 holds
        Y[0, :5] = [300, 513, 1001, 2049, 4099]
    L = rng.integers(1, 5, (G, 3)).astype(np.float64)
    return Y.astype(dtype), L


def _assert_data_equal(a, b):
    """Every ModelData field of two port prepares, bit for bit."""
    assert a.Y.dtype == b.Y.dtype
    for f in ("Y", "L", *STATS):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# "auto"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values,want", [
    (np.array([[0.0, 5.0], [127.0, 1.0]]), "int8"),
    (np.array([[0.0, 128.0]]), "int16"),
    (np.array([[0.0, 40000.0]]), None),
    (np.array([[0.5, 1.0]]), None),
    (np.zeros((0, 3)), None),
    (np.array([[3, 127]], np.int16), "int8"),
    (np.array([[3, 300]], np.int32), "int16"),
    (np.array([[200, 1]], np.uint8), "int16"),
])
def test_auto_y_storage_table(values, want):
    """The reference's table: the narrowest exact integer type, else the
    compute dtype (None), also for fractional counts."""
    assert _name(tapi._auto_y_storage(values)) == want
    assert _name(japi._auto_y_storage(values)) == want


def test_auto_equals_explicit_int8():
    sim = simulate_multinomial(N=50, G=30, C=3, seed=4, mean_total=400)
    ctx = tapi.setup_fit(sim.Y, sim.L, device="cpu", verbose=False)
    assert ctx.data.Y.dtype == torch.int8
    kw = dict(max_iter=15, seed=0, verbose=False, device="cpu")
    auto = ct.clonealign(sim.Y, sim.L, y_storage="auto", **kw)
    explicit = ct.clonealign(sim.Y, sim.L, y_storage="int8", **kw)
    assert list(auto.clone) == list(explicit.clone)
    np.testing.assert_array_equal(auto.ml_params["clone_probs"], explicit.ml_params["clone_probs"])
    np.testing.assert_array_equal(auto.convergence_info.elbo, explicit.convergence_info.elbo)


# ---------------------------------------------------------------------------
# Fits
# ---------------------------------------------------------------------------

def test_int16_storage_fit_equals_float32_fit_exactly():
    """Integer storage is lossless (bfloat16 rounds counts above 256): the
    int16 fit is the float32-storage fit, bit for bit."""
    sim = simulate_multinomial(N=50, G=30, C=3, seed=1, mean_total=3000)
    assert sim.Y.max() > 256
    kw = dict(max_iter=15, seed=0, verbose=False, device="cpu")
    f32 = ct.clonealign(sim.Y, sim.L, y_storage="float32", **kw)
    i16 = ct.clonealign(sim.Y, sim.L, y_storage="int16", **kw)
    np.testing.assert_array_equal(i16.convergence_info.elbo, f32.convergence_info.elbo)
    assert i16.convergence_info.final_elbo == f32.convergence_info.final_elbo
    assert list(i16.clone) == list(f32.clone)
    np.testing.assert_array_equal(i16.correlations, f32.correlations)


@pytest.mark.parametrize("storage", ["auto", "float32", "int16", "int8", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "z_cheb"])
def test_every_storage_fits_like_float32(storage, impl):
    """Every y_storage runs on the CPU, exactly and under z_cheb (whose
    products with Y convert narrow Y a row block at a time); counts below
    128 are exact in each, so every fit equals the float32-storage fit."""
    sim = simulate_multinomial(N=60, G=40, C=3, seed=11, mean_total=500)
    assert sim.Y.max() <= 127
    kw = dict(max_iter=10, seed=0, verbose=False, device="cpu", likelihood_impl=impl)
    want = ct.clonealign(sim.Y, sim.L, y_storage="float32", **kw)
    got = ct.clonealign(sim.Y, sim.L, y_storage=storage, **kw)
    assert np.isfinite(got.convergence_info.final_elbo)
    np.testing.assert_array_equal(got.convergence_info.elbo, want.convergence_info.elbo)
    assert list(got.clone) == list(want.clone)


def test_bfloat16_storage_agrees_with_float32():
    """bfloat16 rounds counts above 256: assignments agree with the float32
    fit and the ELBO stays within bfloat16 rounding of it (the JAX
    package's bar)."""
    sim = simulate_multinomial(N=80, G=60, C=3, seed=11, mean_total=800)
    kw = dict(max_iter=25, seed=0, verbose=False, device="cpu")
    f32 = ct.clonealign(sim.Y, sim.L, **kw)
    b16 = ct.clonealign(sim.Y, sim.L, y_storage="bfloat16", **kw)
    assert f32.clone == b16.clone
    np.testing.assert_allclose(f32.convergence_info.final_elbo, b16.convergence_info.final_elbo,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# prepare_data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", [None, "int16", "int8", "bfloat16"])
@pytest.mark.parametrize("chunked", [False, True])
def test_prepare_data_matches_jax(storage, chunked, monkeypatch):
    """Every ModelData field against the JAX package's prepare_data on the
    same numpy input, in one pass and in row chunks: Y exactly, in the same
    storage type; the statistics at rtol 1e-12 in float64."""
    Y, L = _counts(90, 30, seed=2, large=storage != "int8")
    if chunked:
        monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 600)
        monkeypatch.setattr(jmm, "_CHUNK_ELEMENTS", 600)
    t_store, j_store = STORE[storage]
    want = jmm.prepare_data(Y, L, dtype=jnp.float64, y_storage=j_store)
    got = tmm.prepare_data(Y, L, device="cpu", dtype=F64, y_storage=t_store)
    assert _name(got.Y.dtype) == _name(want.Y.dtype) == (storage or "float64")
    np.testing.assert_array_equal(got.Y.double().numpy(), np.asarray(want.Y, np.float64))
    np.testing.assert_array_equal(got.L.numpy(), np.asarray(want.L))
    for f in STATS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-12, atol=0, err_msg=f)


WIRE_CASES = [
    (np.int16, torch.int8),     # host narrowed to the storage type
    (np.int8, torch.int16),     # host already narrower: shipped as it is
    (np.uint16, torch.int8),    # an unsigned host type: checked, then narrowed
    (np.int16, None),           # integer host, float storage: the host type
    (np.float64, None),         # float64 host: the compute type
    (np.float64, torch.int8),   # float host, integer storage: checked, then narrowed
    (np.float32, torch.int16),
    (np.float64, torch.bfloat16),  # bfloat16 is rounded on the device from the compute type
]


@pytest.mark.parametrize("host,store", WIRE_CASES)
@pytest.mark.parametrize("dtype", [F32, F64])
def test_wire_dtype_matches_jax(host, store, dtype):
    jdtype = {F32: jnp.float32, F64: jnp.float64}[dtype]
    j_store = None if store is None else STORE[_name(store)][1]
    got = tmm._wire_np(host, dtype, dtype if store is None else store)
    want = jmm._wire_np(host, jdtype, jnp.dtype(jdtype if j_store is None else j_store))
    assert got == want


@pytest.mark.parametrize("host,store", WIRE_CASES)
def test_chunked_wire_dtype_matrix(host, store, monkeypatch):
    """Chunks ship in their narrowest exact type: every ModelData field is
    bit-identical to the one-pass prepare, for every (host dtype, storage)."""
    Y, L = _counts(90, 30, seed=7, dtype=host)
    ref = tmm.prepare_data(Y, L, device="cpu", y_storage=store)
    monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 600)  # 16-row chunks
    assert len(tmm._row_blocks(90, 30)) > 3
    got = tmm.prepare_data(Y, L, device="cpu", y_storage=store)
    assert got.Y.dtype == (store or F32)
    _assert_data_equal(got, ref)


def test_chunked_prepare_matches_unchunked_int8(monkeypatch):
    Y, L = _counts(100, 40, seed=0)
    ref = tmm.prepare_data(Y, L, device="cpu", y_storage=torch.int8)
    monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 1000)  # 25-row chunks
    _assert_data_equal(tmm.prepare_data(Y, L, device="cpu", y_storage=torch.int8), ref)
    # a device tensor already in the storage type is kept, not copied
    kept = tmm.prepare_data(ref.Y, L, device="cpu", y_storage=torch.int8)
    assert kept.Y is ref.Y
    _assert_data_equal(kept, ref)


def test_bfloat16_streams_per_chunk_and_rounds_after_the_statistics(monkeypatch):
    """bfloat16 storage ships float32 chunks, takes their statistics, then
    rounds each chunk into the bfloat16 buffer: the statistics are the
    float32 storage's exactly, though Y's large counts are rounded."""
    Y, L = _counts(90, 30, seed=13, large=True)
    f32 = tmm.prepare_data(Y, L, device="cpu")
    ref = tmm.prepare_data(Y, L, device="cpu", y_storage=torch.bfloat16)
    monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 600)
    got = tmm.prepare_data(Y, L, device="cpu", y_storage=torch.bfloat16)
    assert got.Y.dtype == torch.bfloat16
    _assert_data_equal(got, ref)
    assert torch.equal(got.Y, f32.Y.to(torch.bfloat16))
    assert not torch.equal(got.Y.float(), f32.Y)  # 513, 1001, 2049, 4099 rounded
    for f in STATS:
        assert torch.equal(getattr(got, f), getattr(f32, f)), f


@pytest.mark.parametrize("source,store,value,match", [
    ("float64", torch.int8, 300, "cannot hold the largest"),
    ("int16", torch.int8, 300, "cannot hold the largest"),
    ("tensor", torch.int8, 300, "cannot hold the largest"),
    ("float64", torch.int16, 2.5, "fractional"),
    ("tensor", torch.int8, 2.5, "fractional"),
    ("float64", torch.int8, -129, "non-negative"),  # would wrap to 127 in int8
    ("int16", torch.int16, -2, "non-negative"),
    ("float64", None, -2, "non-negative"),
])
@pytest.mark.parametrize("chunked", [False, True])
def test_integer_storage_errors(source, store, value, match, chunked, monkeypatch):
    """A count the storage cannot hold, a fractional count under integer
    storage and a negative count under any storage raise the reference's
    messages, from the host check before narrowing or from the check on
    the statistics' pass, in one pass and in chunks."""
    Y, L = _counts(60, 20, seed=3)
    Y[5, 7] = value
    if source == "int16":
        Y = Y.astype(np.int16)
    elif source == "tensor":
        Y = torch.from_numpy(Y).float()
    if chunked:
        monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 400)
    with pytest.raises(ValueError, match=match):
        tmm.prepare_data(Y, L, device="cpu", y_storage=store)


# ---------------------------------------------------------------------------
# The passes over Y outside the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stored", [F64, torch.int16, torch.int8])
def test_blocked_pca_and_mu_guess_match_jax(stored, monkeypatch):
    """Above _CHUNK_ELEMENTS the PCA and the mu guess run over row blocks of
    the stored Y: against the JAX package's blocked versions (omega drawn
    from the JAX key and fed in as the "pca_omega" draw), and against the
    port's one-block versions."""
    sim = simulate_multinomial(N=120, G=50, C=3, seed=2, mean_total=800)
    assert sim.Y.max() <= 127
    N, G = sim.Y.shape
    key = jax.random.PRNGKey(5)
    omega = np.asarray(jax.random.normal(key, (G, 9), jnp.float64))
    Yt = torch.from_numpy(sim.Y).to(stored)
    pcs1 = tmm.pca_init_scores(Yt, 1, _Draws(pca_omega=[omega]), F64).numpy()
    mu1 = tmm.data_mu_guess(Yt, F64).numpy()
    monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 1500)
    monkeypatch.setattr(jmm, "_CHUNK_ELEMENTS", 1500)
    assert len(tmm._row_blocks(N, G)) > 3
    want = np.asarray(jmm.pca_init_scores(sim.Y, 1, key, jnp.float64))
    got = tmm.pca_init_scores(Yt, 1, _Draws(pca_omega=[omega]), F64).numpy()
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(got * sign, pcs1 * np.sign(np.sum(pcs1 * want, axis=0)),
                               rtol=1e-8, atol=1e-8)
    mu = tmm.data_mu_guess(Yt, F64).numpy()
    np.testing.assert_allclose(mu, np.asarray(jmm.data_mu_guess(sim.Y, jnp.float64)), rtol=1e-12)
    np.testing.assert_allclose(mu, mu1, rtol=1e-12)


@pytest.mark.parametrize("stored", [torch.int16, torch.int8, torch.bfloat16])
def test_row_blocked_products_with_narrow_y(stored, monkeypatch):
    """z_cheb's Y @ B (and its gradient) and the correlations' clone sums
    convert narrow Y a row block at a time; they equal the products with Y
    in float64."""
    Y, L = _counts(70, 24, seed=9)
    rng = np.random.default_rng(1)
    B = torch.from_numpy(rng.normal(0, 1, (3, 24, 2)))  # two lanes' (G, J)
    idx = rng.integers(-1, 3, 70)
    Yn, Yd = torch.from_numpy(Y).to(stored), torch.from_numpy(Y)
    monkeypatch.setattr(tmm, "_CHUNK_ELEMENTS", 300)
    assert len(tmm._row_blocks(70, 24)) > 3
    Bg = B.clone().requires_grad_(True)
    got = tmm._y_times(Yn, Bg)
    assert got.shape == (3, 70, 2)
    np.testing.assert_allclose(got.detach().numpy(), (Yd @ B).numpy(), rtol=1e-12, atol=1e-12)
    # the backward keeps the stored Y, not its converted blocks
    out = tmm._RowBlockedProduct.apply(Yn, Bg[0])
    (kept,) = out.grad_fn.saved_tensors
    assert kept.dtype == stored and kept.data_ptr() == Yn.data_ptr()
    dout = torch.from_numpy(rng.normal(0, 1, (3, 70, 2)))
    (dB,) = torch.autograd.grad(got, Bg, dout)
    np.testing.assert_allclose(dB.numpy(), (Yd.T @ dout).numpy(), rtol=1e-12, atol=1e-12)
    for g, w in zip(_clone_sums_device(Yn, idx, 3, F64), _clone_sums_device(Yd, idx, 3)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
def test_sweep_bytes_count_y_at_its_storage_itemsize(device_type):
    """Y counts at its storage itemsize; narrow storage adds the z_cheb
    products' row block in the compute dtype on the card (the exact kernels
    read Y as it is stored), and Y converted whole by the plain fused op on
    the CPU; a z_cheb sweep runs no backward kernel, so on the card it holds
    no gene-part scratch."""
    N, G, C = 100_000, 5_000, 10
    f32 = trestarts._sweep_bytes(N, G, C, 1, 1, 10, 4, device_type)
    assert f32 == trestarts._sweep_bytes(N, G, C, 1, 1, 10, 4, device_type, 4)
    i8 = trestarts._sweep_bytes(N, G, C, 1, 1, 10, 4, device_type, 1)
    assert i8 == f32 - 3 * N * G + (0 if device_type == "cuda" else 4 * N * G)
    i8_cheb = trestarts._sweep_bytes(N, G, C, 1, 1, 10, 4, device_type, 1, z_cheb=True)
    extra = 4 * tmm._CHUNK_ELEMENTS if device_type == "cuda" else 4 * N * G
    scratch = 4 * (tfl.gene_scratch(N, G, 1, 0, C) + (1 + C) * G) if device_type == "cuda" else 0
    assert i8_cheb == f32 - 3 * N * G + extra - scratch


# ---------------------------------------------------------------------------
# setup_fit: the device-validated path for <= 16-bit integer input
# ---------------------------------------------------------------------------

def _filter_toy(large=False):
    Y, L = _counts(60, 24, seed=21, large=large, dtype=np.int16)
    Y[:, 3] = 0          # dropped at threshold 0
    Y[:, 8] = 0
    Y[2, 8] = 1          # dropped at threshold 1
    return Y, L


@pytest.mark.parametrize("storage", ["auto", "int8", "float32", "bfloat16"])
def test_deferred_gene_filter_matches_jax(storage):
    """int16 input skips the host validation and filters genes by the
    device column sums: the retained genes, the stored Y and the statistics
    equal the JAX package's setup."""
    Y, L = _filter_toy(large=storage in ("float32", "bfloat16"))
    kw = dict(gene_filter_threshold=1, dtype="float64", verbose=False, y_storage=storage)
    got = tapi.setup_fit(Y, L, device="cpu", **kw)
    want = japi.setup_fit(Y, L, **kw)
    assert list(got.retained_genes) == list(want.retained_genes)
    assert len(got.retained_genes) == 22
    assert _name(got.data.Y.dtype) == _name(want.data.Y.dtype)
    np.testing.assert_array_equal(got.data.Y.double().numpy(), np.asarray(want.data.Y, np.float64))
    for f in STATS:
        np.testing.assert_allclose(getattr(got.data, f).numpy(), np.asarray(getattr(want.data, f)),
                                   rtol=1e-12, atol=0, err_msg=f)
    np.testing.assert_array_equal(got.Y, Y[:, got.retained_genes])


@pytest.mark.parametrize("storage", ["auto", "int16", "float32"])
def test_feasibility_is_checked_after_the_deferred_filter(storage):
    """A cell infeasible only through a gene the filter drops still fits;
    one infeasible through a kept gene raises."""
    Y, L = _counts(30, 12, seed=0, dtype=np.int16)
    L[2, :] = 0.0
    Y[:, 2] = 0
    Y[4, 2] = 1
    kw = dict(max_iter=3, device="cpu", verbose=False, y_storage=storage)
    fit = ct.clonealign(Y, L, gene_filter_threshold=1, **kw)
    assert len(fit.retained_genes) == 11 and np.isfinite(fit.convergence_info.final_elbo)
    Y[4, 2] = 3
    with pytest.raises(ValueError, match="no clone can explain"):
        ct.clonealign(Y, L, gene_filter_threshold=1, **kw)


@pytest.mark.parametrize("bad,match", [("zero_cell", "no counts"), ("negative", "non-negative")])
def test_device_validated_path_rejects_bad_counts(bad, match):
    Y, L = _counts(40, 12, seed=5, dtype=np.int16)
    if bad == "zero_cell":
        Y[3] = 0
    else:
        Y[6, 1] = -4
    with pytest.raises(ValueError, match=match):
        tapi.setup_fit(Y, L, device="cpu", verbose=False)

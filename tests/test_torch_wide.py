"""The wide kernel contract: more than 4 columns of ``[psi, X]``, more than
4 Monte Carlo samples (A2 columns) or more than 32 sample x clone columns,
which the Pallas kernels of clonealign_tpu take through their ``jnp.dot``
branches and which clonealign_torch's wrappers hand to the wide family of
CUDA kernels (``fwd_wide_kernel``, ``dpsi_wide_kernel``, ``gene_wide_kernel``).

On the CPU: the port's plain versions (what the autograd function runs on
CPU tensors, and the wide kernels' plain versions on the card) against the
Pallas op in interpret mode, values and VJP, with Y in float32 and in each
narrow storage type; the route function; ``clonealign`` at K = 1, P = 4,
mc_samples = 8 against the JAX package's from the same draws; the
streaming fit against the in-core fit and "vmap" against "map" at a wide
shape; the wide kernels' launch plan (``wide_plan``: every column in one
group or pass, each pass's accumulator tiles apart, the plan and workspace
the wrappers hand the library, every bound; past the old bound of Kf 64,
S 64 and S*C 2,048 the split backward's row blocks, gene ranges and cell
slices, the split forward's row blocks and gene ranges, the route that
takes exactly those widths, and the joint backward's one library call);
an emulation of the kernels' 3xTF32 number scheme (the split forward's
and backward's too) against float64; the sweep's reckoning of the wide
workspace; the refusal past the wide family's bound; and the library's
name following the split kernels' shared header. On
the card (``cuda`` marker, skipped without a GPU): the wide kernels
against their plain versions at every Y storage (also at widths Kf, S and
S*C set apart, as no fit sets them), their launches counted apart from
the narrow kernels', the forward, dpsi and the gene part deterministic
(the split forward and backward too, at two row blocks), and every
plan's kernels at their blocks an SM:
``python -m pytest --noconftest -m cuda tests/test_torch_wide.py``.

Tolerances: the fused op's values rtol 2e-5 / atol 1e-4 and VJP rtol 3e-5
/ atol 1e-4 (tests/test_torch_fused_likelihood.py: float32 sums in other
orders); ``clonealign`` against the JAX package, float64: trace and final
ELBO rtol 1e-6, labels identical (tests/test_torch_covariates.py's parity
test); streamed against in-core rtol 1e-11 and lanes against map rtol 1e-12
with iterations and labels exact (tests/test_torch_stream.py,
tests/test_torch_restarts.py).

jax is imported inside fixtures and tests, never at the top: the GPU
machine has no jax.
"""

import numpy as np
import pytest
import torch

import clonealign_torch as ct
from clonealign_torch import restarts as trestarts
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.ops import fused_likelihood as tfl
from clonealign_torch.synth import simulate_multinomial

torch.set_num_threads(2)

# (N, G, C, K, S): Kf = 6 with S = 8 (S*C = 80); S*C = 33 alone; Kf = 5 with
# S = 5; S*C = 36 alone (S = 4, Kf = 2)
SHAPES = [(70, 300, 10, 6, 8), (37, 41, 33, 1, 1), (50, 129, 5, 5, 5), (17, 260, 9, 2, 4)]
# on the card besides: several 1,024-cell chunks, one gene and K = 0, a
# forward that is wide only with A2 (S = 5, S*C = 10, Kf = 1), every bound
# at once (Kf = 64, S = 64, S*C = 192; and S*C = 2048), and two column
# groups and two gene-part passes (S*C = 160) at Kf = 18 over three chunks
CUDA_SHAPES = SHAPES + [(2100, 130, 9, 1, 4), (33, 1, 40, 0, 1), (60, 100, 2, 1, 5),
                        (40, 70, 3, 64, 64), (20, 50, 64, 3, 32), (2100, 200, 20, 18, 8)]
# past the old bound of 64, 64 and 2,048, each alone and all at once: Kf 72
# (dpsi's and dW's column groups), S 66 (the Y products' groups, dlog mu's
# passes), S*C 2,178 (S 33 x C 66) and Kf 72, S 66, S*C 660
PAST_BOUND_SHAPES = [(300, 100, 3, 72, 2), (300, 100, 2, 1, 66), (2100, 200, 66, 1, 33),
                     (500, 130, 10, 72, 66)]
CUDA_SHAPES += PAST_BOUND_SHAPES
STORAGES = [torch.float32, torch.bfloat16, torch.int16, torch.int8]
VALUE_TOL = dict(rtol=2e-5, atol=1e-4)
VJP_TOL = dict(rtol=3e-5, atol=1e-4)
# The wide backward on the card against the float64 plain version: each
# element within BWD_ABS_RTOL of the sum of its terms' absolute values
# (about 8 float32 ulps of that sum). dpsi, dW, dlog mu and d(muL) are signed
# sums that cancel: at (2100, 130, 9, 1, 4) dW sums 2,100 terms of about 24
# to about 1, and float32 products and sums of those terms (the plain
# version's as much as the kernel's) miss rtol 3e-5 / atol 1e-4 of the
# float64 value there by up to 3e-4, which is 5e-9 of the absolute sum.
BWD_ABS_RTOL = 1e-6


def _inputs(N, G, C, K, S, seed):
    """Y, psi, W, log_mu, muL as float32 numpy arrays (the recipe of
    tests/test_fused_likelihood.py); W's scale shrinks with K so that
    log_rfe keeps the size it has at K = 1."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    Y = rng.poisson(3.0, (N, G)).astype(f32)
    psi = rng.normal(0, 1, (N, K)).astype(f32)
    W = rng.normal(0, 0.3 / np.sqrt(max(K, 1)), (G, K)).astype(f32)
    mu = rng.lognormal(0, 0.5, (S, G)).astype(f32)
    L = rng.integers(1, 5, (G, C)).astype(f32)
    muL = (mu[:, None, :] * L.T[None]).transpose(2, 0, 1).reshape(G, S * C)
    return Y, psi, W, np.log(mu), np.ascontiguousarray(muL)


def _cotangents(N, S, SC, seed):
    rng = np.random.default_rng(seed + 1000)
    return (rng.normal(0, 1, N).astype(np.float32),
            rng.normal(0, 1, (N, S)).astype(np.float32),
            rng.normal(0, 1, (N, SC)).astype(np.float32))


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_ops():
    """(jax, jax.numpy, the JAX package's fused-likelihood module)."""
    jax = pytest.importorskip("jax")
    jfl = pytest.importorskip("clonealign_tpu.ops.fused_likelihood")
    return jax, jax.numpy, jfl


# --- the plain versions against the Pallas kernel's wide branches ------------

@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_the_pallas_wide_branches(shape, storage, jax_ops):
    """Values (A1, A2, Z) and the VJP (psi, W, log mu, muL) of the port's
    plain versions, with Y in ``storage``, against jax.vjp of the Pallas op
    given Y in the same type, and the autograd function's CPU gradients.
    These are the wide kernels' plain versions: the wide dpsi and gene
    kernels sum in their association (dlog_rfe W, dlog_rfe^T psi)."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = shape
    assert tfl.wide_route(K, S, S * C) and tfl.wide_route(K, 0, S * C) == (K > 4 or S * C > 32)
    x = _inputs(N, G, C, K, S, seed=N + G)
    cot = _cotangents(N, S, S * C, seed=N + G)
    Yf, psi, W, log_mu, muL = _torch(x)
    Y = Yf.to(storage)
    assert torch.equal(Y.float(), Yf)  # Poisson(3) counts are exact in every storage type
    jY = jnp.asarray(x[0]).astype(jnp.dtype(str(storage).removeprefix("torch.")))
    pallas, vjp = jax.vjp(jfl.fused_likelihood_terms, jY, *map(jnp.asarray, x[1:]))
    want = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cot)))[1:]]

    for name, o, p in zip(("A1", "A2", "Z"), tfl.reference_likelihood_terms(Y, psi, W, log_mu, muL),
                          pallas):
        assert o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), np.asarray(p), err_msg=name, **VALUE_TOL)
    dA1, dA2, dZ = _torch(cot)
    explicit = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)
    leaves = [t.clone().requires_grad_(True) for t in (psi, W, log_mu, muL)]
    auto = torch.autograd.grad(tfl.fused_likelihood_terms(Y, *leaves), leaves,
                               grad_outputs=(dA1, dA2, dZ))
    for name, w, e, a in zip(("psi", "W", "log_mu", "muL"), want, explicit, auto):
        np.testing.assert_allclose(e.numpy(), w, err_msg=name, **VJP_TOL)
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **VJP_TOL)


@pytest.mark.parametrize("storage", [torch.float32, torch.int8])
def test_plain_versions_match_the_pallas_op_past_the_old_bound(storage, jax_ops):
    """At Kf 72, S 66 and S*C 2,178 (past every old bound at once) the
    plain versions, with Y in ``storage``, against the Pallas op in
    interpret mode (float32, as on its TPU): the values within VALUE_TOL;
    the VJP, whose elements here sum thousands of cancelling float32 terms
    in both, within BWD_ABS_RTOL of each element's absolute-term sum (the
    wide kernels' tolerance against float64)."""
    jax, jnp, jfl = jax_ops
    N, G, C, K, S = 24, 40, 33, 72, 66
    x = _inputs(N, G, C, K, S, seed=7)
    cot = _cotangents(N, S, S * C, seed=7)
    Yf, psi, W, log_mu, muL = _torch(x)
    Y = Yf.to(storage)
    jY = jnp.asarray(x[0]).astype(jnp.dtype(str(storage).removeprefix("torch.")))
    pallas, vjp = jax.vjp(jfl.fused_likelihood_terms, jY, *map(jnp.asarray, x[1:]))
    want = [np.asarray(g) for g in vjp(tuple(map(jnp.asarray, cot)))[1:]]
    for name, o, p in zip(("A1", "A2", "Z"), tfl.reference_likelihood_terms(Y, psi, W, log_mu, muL),
                          pallas):
        np.testing.assert_allclose(o.numpy(), np.asarray(p), err_msg=name, **VALUE_TOL)
    dA1, dA2, dZ = _torch(cot)
    got = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)
    scale = _abs_term_sums(*(t.double() for t in (Yf, psi, W, muL, dA1, dA2, dZ)))
    for name, g, w, sc in zip(("psi", "W", "log_mu", "muL"), got, want, scale):
        err = np.abs(g.double().numpy() - w)
        assert (err <= BWD_ABS_RTOL * sc.numpy()).all(), (name, float(err.max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_reassociated_plain_versions_take_wide_shapes(shape):
    """The narrow kernels' re-associated plain versions (the Y-free dpsi and
    the gene-major formulas) at the wide shapes: in float64 each equals the
    plain VJP to rounding (in float32 their other association differs from
    it by float32 rounding at cancelling elements)."""
    N, G, C, K, S = shape
    x = [a.astype(np.float64) for a in _inputs(N, G, C, K, S, seed=N + 3)]
    cot = [a.astype(np.float64) for a in _cotangents(N, S, S * C, seed=N + 3)]
    Y, psi, W, _log_mu, muL = _torch(x)
    dA1, dA2, dZ = _torch(cot)
    want = tfl.reference_likelihood_vjp(Y, psi, W, muL, dA1, dA2, dZ)
    got = (tfl.reference_dpsi(Y @ W, psi, W, muL, dA1, dZ),
           *tfl.reference_gene(Y, psi, W, muL, dA1, dA2, dZ))
    for name, g, w in zip(("psi", "W", "log_mu", "muL"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10, atol=1e-12, err_msg=name)


# --- the route --------------------------------------------------------------

@pytest.mark.parametrize("Kf,n_a2,SC,wide", [
    (4, 4, 32, False), (0, 0, 1, False), (1, 0, 10, False), (5, 0, 10, True),
    (1, 5, 10, True), (1, 0, 33, True), (4, 4, 33, True), (5, 5, 40, True),
    (64, 64, 2048, True),
])
def test_route_picks_the_wide_family_exactly_past_each_limit(Kf, n_a2, SC, wide):
    assert tfl.wide_route(Kf, n_a2, SC) is wide
    assert (Kf > tfl.MAX_KF or n_a2 > tfl.MAX_A2 or SC > tfl.MAX_SC) is wide


@pytest.mark.parametrize("K,P,S,C", [(65, 0, 1, 3), (60, 5, 1, 3), (1, 0, 65, 1),
                                     (1, 0, 32, 65)])
def test_widths_past_the_old_bound_are_taken_on_cuda(monkeypatch, K, P, S, C):
    """Past 64 columns of [psi, X], 64 samples or 2,048 sample x clone
    columns, where the wide and float64 kernels take their columns in
    groups or passes, setup_fit on CUDA takes the fit, as the CPU does; the
    kernels' plans hold those widths."""
    from test_torch_api import _setup_passes_the_contract_on_cuda

    sim = simulate_multinomial(N=30, G=20, C=C, seed=1, mean_total=400)
    x = np.random.default_rng(1).normal(size=(30, P)) if P else None
    _setup_passes_the_contract_on_cuda(monkeypatch, sim.Y, sim.L, x=x, K=K, mc_samples=S)
    for n_a2 in (S, 0):
        assert tfl.wide_plan(30, 20, K + P, n_a2, S * C)["n_zt"] == -(-S * C // 8)
        p = tfl.f64_plan(30, 20, K + P, n_a2, S * C)
        # Z's tiles in the forward's groups, or past the bound its gene
        # ranges (every gene of each row block's product)
        assert (p["zsplit"] * p["zgenes"] >= 20 if p["split"]
                else p["f_tiles"] >= -(-S * C // 8))


# --- fits at a wide shape on the CPU ------------------------------------------

def _sim(N=80, G=50, C=5, seed=8, P=4):
    """Counts, copy numbers and P covariate columns (a 0/1 batch over halves
    of the cells, then standard normals), all made with numpy."""
    sim = simulate_multinomial(N=N, G=G, C=C, seed=seed, mean_total=400)
    rng = np.random.default_rng(seed + 100)
    cols = [(np.arange(N) >= N // 2).astype(np.float64)]
    cols += [rng.normal(size=N) for _ in range(P - 1)]
    return sim.Y, sim.L, np.stack(cols[:P], axis=1)


def _matches_jax(monkeypatch, Y, L, X, K, S, max_iter=40):
    """clonealign on the CPU in float64 against the JAX package's from the
    same draws: the port's fit replays the JAX package's (the PCA test
    matrix and psi jitter from the init keys, then the loop's schedule),
    with the PCA scores' arbitrary sign aligned to the JAX package's, so
    both fits start from the same parameters: the same iterations, ELBO
    trace, final ELBO and labels."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    ca = pytest.importorskip("clonealign_tpu")
    from clonealign_tpu.models import multinomial as jmm
    from test_torch_stream import JaxStreamKeys

    port_pca = tmm.randomized_pca

    def aligned_pca(X, k, noise, **kwargs):
        got = port_pca(X, k, noise, **kwargs)
        want = torch.tensor(np.asarray(jmm.randomized_pca(jnp.asarray(X.numpy()), k,
                                                          noise.k_pca, **kwargs)))
        sign = torch.sign(torch.sum(got * want, dim=0))
        np.testing.assert_allclose((got * sign).numpy(), want.numpy(), rtol=1e-8, atol=1e-10)
        return got * sign

    monkeypatch.setattr(tmm, "randomized_pca", aligned_pca)
    kw = dict(K=K, x=X, mc_samples=S, max_iter=max_iter, dtype="float64", verbose=False)
    want = ca.clonealign(Y, L, seed=3, **kw)
    got = ct.clonealign(Y, L, noise=JaxStreamKeys(3), device="cpu", **kw)
    assert got.convergence_info.n_iters == want.convergence_info.n_iters
    np.testing.assert_allclose(got.convergence_info.elbo, want.convergence_info.elbo, rtol=1e-6)
    np.testing.assert_allclose(got.convergence_info.final_elbo,
                               want.convergence_info.final_elbo, rtol=1e-6)
    assert got.clone == want.clone
    return got, want


def test_clonealign_k1_p4_s8_matches_jax(monkeypatch):
    """K = 1, P = 4 (Kf = 5) and mc_samples = 8 (S*C = 40) against the JAX
    package (:func:`_matches_jax`), beta too."""
    Y, L, X = _sim()
    got, want = _matches_jax(monkeypatch, Y, L, X, K=1, S=8)
    assert got.ml_params["beta"].shape == want.ml_params["beta"].shape == (50, 4)
    np.testing.assert_allclose(got.ml_params["beta"], want.ml_params["beta"], atol=1e-5)


@pytest.mark.parametrize("N,G,C,K,P,S", [(80, 50, 5, 1, 65, 1), (80, 50, 5, 1, 0, 66),
                                         (40, 30, 33, 1, 0, 66)])
def test_clonealign_past_the_old_bound_matches_jax(monkeypatch, N, G, C, K, P, S):
    """Past the old bound: K + P = 66, mc_samples = 66 (S*C 330) and S*C =
    2,178 (66 x 33 clones) against the JAX package, float64, from the same
    draws (:func:`_matches_jax`; the tolerances of the K = 1, P = 4 case)."""
    Y, L, X = _sim(N=N, G=G, C=C, P=max(P, 1))
    got, want = _matches_jax(monkeypatch, Y, L, X if P else None, K=K, S=S, max_iter=25)
    if P:
        np.testing.assert_allclose(got.ml_params["beta"], want.ml_params["beta"], atol=1e-5)


WIDE_FIT = dict(K=1, mc_samples=8, max_iter=12, rel_tol=1e-8, dtype="float64", seed=11,
                verbose=False, device="cpu")


def test_fit_streaming_equals_the_in_core_fit_at_a_wide_shape():
    Y, L, X = _sim(N=75, G=40, seed=5)
    core = ct.clonealign(Y, L, x=X, elbo_eval="reuse", **WIDE_FIT)
    strm = ct.fit_streaming(Y, L, x=X, chunk_cells=30, **WIDE_FIT)
    assert strm.convergence_info.n_iters == core.convergence_info.n_iters
    np.testing.assert_allclose(strm.convergence_info.elbo, core.convergence_info.elbo,
                               rtol=1e-11)
    np.testing.assert_allclose(strm.convergence_info.final_elbo,
                               core.convergence_info.final_elbo, rtol=1e-11)
    assert strm.clone == core.clone
    for name in ("mu", "clone_probs", "psi", "W", "beta"):
        np.testing.assert_allclose(strm.ml_params[name], core.ml_params[name], rtol=1e-8,
                                   atol=1e-12, err_msg=name)


def test_run_clonealign_vmap_equals_map_at_a_wide_shape():
    Y, L, X = _sim(N=50, G=40, seed=2)
    kw = dict(WIDE_FIT, initial_shrinks=(0, 5), n_repeats=2, print_elbos=False, x=X,
              rel_tol=0.02)
    seq = ct.run_clonealign(Y, L, restart_batching="map", **kw)
    got = ct.run_clonealign(Y, L, restart_batching="vmap", **kw)
    assert got.timings["iterations"] == seq.timings["iterations"]
    assert got.multirun_info["best_run"] == seq.multirun_info["best_run"]
    np.testing.assert_allclose(got.multirun_info["elbos"], seq.multirun_info["elbos"], rtol=1e-12)
    assert got.clone == seq.clone


def test_sweep_bytes_hold_the_wide_gene_workspace_once():
    """On the card an exact sweep whose backward runs the wide family holds
    one call's gene-part workspace beside the lanes, whatever their number:
    the (Kf + S C, G) float32 partial sums of each 1,024-cell chunk, the
    packed cell side (dZ's and psi's (hi, lo) pairs at 8-column tiles, and
    dA1) and their sum; and dpsi's packed gene table. A narrow exact sweep
    holds the narrow gene part's scratch and sums instead; a z_cheb sweep
    (no backward kernel) and the CPU hold none; a z_cheb sweep converts a
    block of narrow Y instead."""
    N, G, C, K, P, S = 100_000, 5_000, 10, 1, 4, 8
    F = K + P + S * C
    want = 4 * (-(-N // 1024) * F * G + N * 2 * (8 * 10 + 8 * 1) + N + F * G)
    assert 4 * tfl.wide_plan(N, G, K + P, 0, S * C)["gene_workspace"] == want
    table = 4 * -(-G // 32) * 32 // 8 * (2 * 1 + 10) * 32 * 4  # W^T, muL^T, W a k-step
    assert 4 * tfl.wide_plan(N, G, K + P, 0, S * C)["dpsi_workspace"] == table
    narrow = 4 * (tfl.gene_scratch(N, G, K + 2, 0, C) + (K + 2 + C) * G)
    block = 4 * tmm._CHUNK_ELEMENTS

    def sweep(n_lanes, device_type="cuda", P=P, S=S, z_cheb=False):
        return trestarts._sweep_bytes(N, G, C, K, S, n_lanes, 4, device_type, 1, P,
                                      z_cheb=z_cheb)

    for n_lanes in (1, 3, 10):
        assert sweep(n_lanes) - sweep(n_lanes, z_cheb=True) == want + table - block
        assert sweep(n_lanes, P=2, S=1) - sweep(n_lanes, P=2, S=1, z_cheb=True) == narrow - block
        assert sweep(n_lanes, "cpu") == sweep(n_lanes, "cpu", z_cheb=True)
    assert trestarts._auto_restart_batching(N, G, C, K, S, 3, 4, "cuda", 1, P) == "vmap"


def test_sweep_bytes_hold_the_grouped_workspace_past_the_old_bound():
    """Past the old bound (K 2, P 70: Kf 72; mc_samples 66: S*C 660) an
    exact sweep on the card holds one call's split workspace beside the
    lanes, once whatever their number: the backward's row block of rfe and
    dlog_rfe (1,664 cells x 5,000 genes each, 61 blocks), dpsi's 6 gene
    ranges' sums (1,664 x Kf each) and the (Kf + S C, G) sums (kernel_gene
    alone the same workspace, one layout for both calls; kernel_dpsi alone
    one row block and the ranges' sums), and the forward's (the split
    forward's: the Y products' table, A1's partial sums, its row block of
    rfe and its 5 gene ranges' sums of Z, 1,664 x S C each; every forward,
    z_cheb's too); in float64 the float64 family's one call for both parts:
    the row block of rfe and dlog_rfe of 832 cells (half the float32
    one's), dpsi's 14 gene ranges' sums and its output. "auto" still runs
    these lanes together at three restarts."""
    N, G, C, K, P, S = 100_000, 5_000, 10, 2, 70, 66
    Kf, SC = K + P, S * C
    p = tfl.wide_plan(N, G, Kf, 0, SC)
    F = Kf + SC
    assert (p["split"], p["rows"], p["n_chunks"], p["ldw"], p["dsplit"]) == (1, 1664, 61, G, 6)
    dtable = 1664 * G + 6 * 1664 * Kf
    assert p["dpsi_workspace"] == dtable
    bwd = 2 * 1664 * G + 6 * 1664 * Kf + F * G
    assert p["bwd_workspace"] == p["gene_workspace"] == bwd
    pf = tfl.wide_plan(N, G, Kf, S, SC)
    assert (pf["zsplit"], pf["zgenes"], pf["ldz"]) == (5, 1024, 0)
    assert pf["a1_parts"] > 0 and pf["fwd_workspace"] == (
        pf["table"] + pf["a1part"] + 1664 * G + 5 * 1664 * SC) and pf["a1part"] >= (
        pf["a1_parts"] * N)
    block = 4 * tmm._CHUNK_ELEMENTS

    def sweep(n_lanes, z_cheb=False, itemsize=4):
        return trestarts._sweep_bytes(N, G, C, K, S, n_lanes, itemsize, "cuda", 1, P,
                                      z_cheb=z_cheb)

    for n_lanes in (1, 3):
        assert sweep(n_lanes) - sweep(n_lanes, z_cheb=True) == 4 * bwd - block
        assert sweep(n_lanes) - sweep(0) == sweep(n_lanes, z_cheb=True) - sweep(0, z_cheb=True)
        p64 = tfl.f64_plan(N, G, Kf, 0, SC)
        assert (p64["split"], p64["rows"], p64["n_chunks"], p64["dsplit"], p64["zsplit"]) == (
            1, 832, 121, 14, 5)
        assert p64["bwd_workspace"] == p64["gene_workspace"] == (
            2 * 832 * G + 14 * 832 * Kf + F * G)
        assert (sweep(n_lanes, itemsize=8) - sweep(n_lanes, True, itemsize=8)
                == 8 * (p64["bwd_workspace"] - tmm._CHUNK_ELEMENTS))
    assert trestarts._auto_restart_batching(N, G, C, K, S, 3, 4, "cuda", 1, P) == "vmap"


# --- the wide kernels' launch plan ------------------------------------------

# (N, Kf, n_a2, SC) at widths no fit gives (S*C below S): dW and dlog mu
# filling the first pass beside one, two or 25 dZ tiles, and A2 alone wide
INDEPENDENT_WIDTHS = [(300, 64, 64, 8), (300, 57, 60, 16), (300, 64, 64, 200), (300, 5, 64, 8)]
# ... and past the old bound: dW's and dpsi's groups beside dlog mu's own
# pass, dlog mu in three passes of its own, and three column groups of
# [psi, X] (Kf 140)
PAST_BOUND_WIDTHS = [(300, 72, 66, 8), (300, 1, 130, 16), (300, 140, 2, 8)]
# (N, G, Kf, n_a2, SC): the shapes above, the wide fit's, Y tiles that do not
# fit beside Z's, the independent widths, every bound
PLAN_SHAPES = ([(N, G, K, S, S * C) for N, G, C, K, S in CUDA_SHAPES
                if (N, G, C, K, S) not in PAST_BOUND_SHAPES]
               + [(N, G, K, 0, S * C) for N, G, C, K, S in CUDA_SHAPES
                  if (N, G, C, K, S) not in PAST_BOUND_SHAPES]
               + [(N, 100, Kf, n_a2, SC) for N, Kf, n_a2, SC in INDEPENDENT_WIDTHS]
               + [(100_000, 5_000, 5, 8, 80), (100_000, 5_000, 5, 0, 10), (500, 300, 5, 1, 128),
                  (500, 300, 64, 64, 8), (500, 300, 64, 64, 2048), (1000, 100, 0, 0, 33),
                  (100_000, 5_000, 64, 0, 80), (100_000, 5_000, 64, 64, 2048)])
# (N, G, Kf, n_a2, SC) past the old bound: the shapes above, the widths set
# apart, the full-width fit's (Kf 72, S 66, S*C 660) and the widest Kf each
# family takes
PAST_PLAN_SHAPES = ([(N, G, K, S, S * C) for N, G, C, K, S in PAST_BOUND_SHAPES]
                    + [(N, G, K, 0, S * C) for N, G, C, K, S in PAST_BOUND_SHAPES]
                    + [(N, 100, Kf, n_a2, SC) for N, Kf, n_a2, SC in PAST_BOUND_WIDTHS]
                    + [(100_000, 5_000, 72, 66, 660), (100_000, 5_000, 72, 0, 660),
                       (100_000, 5_000, 1, 66, 2178), (1000, 500, 176, 1, 10),
                       (1000, 500, 248, 66, 660)])


def _pass_tiles(p, q):
    """gene_wide_kernel's accumulator tiles in pass q of plan p, by product:
    d(muL) the first nj (none in dlog mu's pass of its own), dW's n_kc after
    them, dlog mu (the first pass) n_st after dW's or, in its own pass,
    d(muL)'s first."""
    with_mu = q >= p["y_pass"]
    tiles = {"dmuL": range(p["nj"]) if with_mu else range(0),
             "dW": range(p["nj"], p["nj"] + p["n_kc"])}
    if p["y_pass"] and q == 0:
        tiles["dlog_mu"] = range(p["n_st"])
    elif not p["y_pass"] and q == 0:
        t_mu = p["nj"] + p["n_kc"]
        tiles["dlog_mu"] = range(t_mu, t_mu + p["n_st"])
    return tiles


@pytest.mark.parametrize("shape", PLAN_SHAPES + PAST_PLAN_SHAPES)
def test_wide_plan_covers_every_column_once(shape):
    """The forward's column groups hold each of Z's tiles once, and the Y
    products' groups each Y tile once (A1 written by one warp where it holds
    every column of Y W, else from partial sums); S*C <= 128 is one column
    group. Up to the old bound the gene part's passes hold each of dZ's
    tiles once, dlog mu's tiles once in the first pass or its own, and dW's
    every tile of [psi, X]; each pass is padded to a built tile count and
    holds no more accumulator tiles than WIDE_TILES, where no two products
    share a tile; dpsi holds every tile of [psi, X] and its dZ groups each
    dZ tile once. Past it the split backward's row blocks hold each cell
    once, in whole tiles of 64 as even as they go, and dpsi's ranges each
    gene once, in whole stages of 32; the forward is the split one, with no
    Z groups, its table the Y products' tiles alone, and its gene ranges
    hold each gene once, in whole stages of 32, the fewest whose blocks
    fill their last wave to _WAVE_FILL (or the best fill); its workspace is
    the table, A1's partial sums, a row block of rfe, the ranges' sums of Z
    where more than one, and muL's copy at an odd S*C."""
    N, G, Kf, n_a2, SC = shape
    p = tfl.wide_plan(N, G, Kf, n_a2, SC)
    n_zt, n_yt, n_kc, n_st = -(-SC // 8), -(-(Kf + n_a2) // 8), -(-Kf // 8), -(-n_a2 // 8)
    assert (p["n_zt"], p["n_yt"], p["n_kc"], p["n_st"]) == (n_zt, n_yt, n_kc, n_st)
    assert p["zt_group"] in tfl.WIDE_TILE_COUNTS or (p["split"] and p["zt_group"] == 0)
    assert p["ny_pad"] in tfl.WIDE_Y_TILE_COUNTS
    y_tiles = []
    for g in range(p["n_ygroups"]):
        y = list(range(g * p["ny_pad"], min(n_yt, (g + 1) * p["ny_pad"])))
        assert y or n_yt == 0
        y_tiles += y
    assert y_tiles == list(range(n_yt))
    per_warp = p["ny_pad"] // (2 if p["ny_pad"] > 10 else 1)
    one_warp = p["n_ygroups"] == 1 and Kf <= 8 * per_warp
    assert p["a1_parts"] == (0 if one_warp else p["n_ygroups"] * p["ny_pad"] // per_warp)
    assert p["a1part"] >= p["a1_parts"] * N
    if p["split"]:
        assert p["n_zgroups"] == p["zt_group"] == 0
        assert p["table"] == -(-G // 32) * 4 * p["n_ygroups"] * p["ny_pad"] * 32 * 4
        zgenes = [g for z in range(p["zsplit"])
                  for g in range(z * p["zgenes"], min(G, (z + 1) * p["zgenes"]))]
        assert zgenes == list(range(G)) and p["zgenes"] % 32 == 0
        tiles = -(-p["rows"] // 64) * -(-SC // 64)

        def fill(z):
            return tiles * z / (-(-tiles * z // 264) * 264)

        ranges = range(1, -(-G // 256) + 1)
        least = next((z for z in ranges if fill(z) >= tfl._WAVE_FILL), max(ranges, key=fill))
        assert p["zgenes"] == -(-(-(-G // least)) // 32) * 32
        zpart = -(-p["zsplit"] * p["rows"] * SC // 4) * 4 if p["zsplit"] > 1 else 0
        assert p["fwd_workspace"] == (p["table"] + p["a1part"] + p["rows"] * p["ldw"] + zpart
                                      + G * p["ldz"])
    else:
        assert p["fwd_workspace"] == p["table"] + p["a1part"] and p["zsplit"] == p["zgenes"] == 0
        z_tiles = []
        for g in range(p["n_zgroups"]):
            z = list(range(g * p["zt_group"], min(n_zt, (g + 1) * p["zt_group"])))
            assert z and p["zt_group"] <= tfl.WIDE_TILES
            z_tiles += z
        assert z_tiles == list(range(n_zt))
        assert (p["n_zgroups"] == 1) == (SC <= 8 * tfl.WIDE_TILES)
    if p["split"]:
        rows, blocks = p["rows"], p["n_chunks"]
        cells = [n for b in range(blocks) for n in range(b * rows, min(N, (b + 1) * rows))]
        assert cells == list(range(N)) and rows % 64 == 0 and rows - -(-N // blocks) < 64
        assert p["ldw"] >= G and p["ldw"] % 4 == 0 and p["dgenes"] % 32 == 0
        genes = [g for z in range(p["dsplit"])
                 for g in range(z * p["dgenes"], min(G, (z + 1) * p["dgenes"]))]
        assert genes == list(range(G))
        if p["gslices"] > 1:  # one row block's cells in slices of whole stages
            assert blocks == 1 and p["gcells"] % 32 == 0
            assert [n for z in range(p["gslices"])
                    for n in range(z * p["gcells"], min(N, (z + 1) * p["gcells"]))] == cells
        else:
            assert p["gcells"] == rows
        assert not any(p[k] for k in ("nj", "mu_passes", "n_passes", "dk_pad", "dtable", "part"))
        return
    assert n_kc <= 8 and n_st <= 8 and p["nj"] in tfl.WIDE_TILE_COUNTS
    j_tiles, s_tiles = [], []
    assert p["n_passes"] == p["mu_passes"] + p["y_pass"]
    for q in range(p["n_passes"]):
        with_mu = q >= p["y_pass"]
        begin = (q - p["y_pass"]) * p["nj"]
        j_tiles += list(range(begin, min(n_zt, begin + p["nj"]))) if with_mu else []
        tiles = _pass_tiles(p, q)
        s_tiles += [t - tiles["dlog_mu"][0] for t in tiles.get("dlog_mu", ())]
        held = [t for r in tiles.values() for t in r]
        assert len(set(held)) == len(held) and all(0 <= t < tfl.WIDE_TILES for t in held)
    assert j_tiles == list(range(n_zt)) and s_tiles == list(range(n_st))
    # dpsi: [psi, X]'s tiles padded to a built count; dZ's column groups,
    # run one after another, hold each tile once; S*C <= 80 is one group,
    # and so one exp per (cell, gene)
    assert p["dk_pad"] in tfl.WIDE_DPSI_K_COUNTS and p["dk_pad"] >= n_kc
    assert p["dz_group"] in tfl.WIDE_DPSI_Z_COUNTS
    d_tiles = []
    for g in range(p["n_dgroups"]):
        z = list(range(g * p["dz_group"], min(n_zt, (g + 1) * p["dz_group"])))
        assert z
        d_tiles += z
    assert d_tiles == list(range(n_zt))
    assert (p["n_dgroups"] == 1) == (SC <= 8 * tfl.WIDE_DPSI_Z_COUNTS[-1])
    assert p["dsteps"] in (2, 4) and p["g_pad"] % (8 * p["dsteps"]) == 0


class _FakeLib:
    """The CUDA library's wide entry points, recording their arguments."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def call(*args):
            self.calls[name] = args
            return 0
        return call


def _recorded_wrappers(monkeypatch):
    """The CUDA library's entry points recorded, not called (a _FakeLib),
    and the numel of each torch.empty the wrappers make, for running the
    wrappers on CPU tensors."""
    lib = _FakeLib()
    from clonealign_torch.ops import _build
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(tfl, "_check", lambda *args, **kwargs: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: type("S", (), {"cuda_stream": 0}))
    sizes = []
    empty = torch.empty

    def recording_empty(*shape_, **kwargs):
        out = empty(*shape_, **kwargs)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    return lib, sizes


@pytest.mark.parametrize("shape", [(2100, 130, 9, 1, 4), (70, 300, 10, 6, 8), (40, 70, 3, 64, 64),
                                   (40, 70, 10, 72, 66)])
def test_wide_plan_workspace_is_what_the_wrappers_allocate(monkeypatch, shape):
    """kernel_gene's allocations (the scratch and the (Kf + SC + n_a2, G)
    output) add up to wide_plan's gene_workspace, kernel_forward's scratch is
    its fwd_workspace (the packed table and A1's partial sums, or past the
    old bound the split forward's, test_split_workspace_is_what_the_wrappers_allocate),
    kernel_dpsi's its dpsi_workspace
    (the plan of n_a2 = 0: the packed table, or past the old bound the split
    one's row block and gene ranges' sums), and each entry point gets the
    plan's numbers in WIDE_PLAN_KEYS' order. The wrappers run on CPU
    tensors with the CUDA library's entry points recorded, not called."""
    N, G, C, K, S = shape
    Y, psi, W, log_mu, muL = _torch(_inputs(N, G, C, K, S, seed=1))
    dA1, dA2, dZ = _torch(_cotangents(N, S, S * C, seed=1))
    lib, sizes = _recorded_wrappers(monkeypatch)
    for with_a2 in (True, False):
        n_a2 = S if with_a2 else 0
        p = tfl.wide_plan(N, G, K, n_a2, S * C)
        sizes.clear()
        tfl.kernel_gene(Y, psi, W, muL, dA1, dA2 if with_a2 else None, dZ)
        assert sum(sizes) == p["gene_workspace"]
        want = [p[k] for k in tfl.WIDE_PLAN_KEYS]
        assert list(lib.calls["fl_backward_gene_wide"][10]) == want
        assert lib.calls["fl_backward_gene_wide"][7] is None  # no dpsi
        sizes.clear()
        tfl.kernel_forward(Y, psi, W, log_mu if with_a2 else None, muL)
        assert sizes[-1] == p["fwd_workspace"]
        assert p["split"] or p["fwd_workspace"] == p["table"] + p["a1part"]
        assert list(lib.calls["fl_forward_wide"][10]) == want
    p = tfl.wide_plan(N, G, K, 0, S * C)
    sizes.clear()
    tfl.kernel_dpsi(psi, W, muL, dA1, dZ, Y @ W)
    assert sizes == [N * K, p["dpsi_workspace"]] and p["dpsi_workspace"] == (
        p["rows"] * p["ldw"] + p["dsplit"] * p["rows"] * K if p["split"] else p["dtable"])
    assert list(lib.calls["fl_backward_dpsi_wide"][8]) == [p[k] for k in tfl.WIDE_PLAN_KEYS]


@pytest.mark.parametrize("shape", PAST_BOUND_SHAPES + [(2000, 333, 7, 3, 300), (37, 41, 3, 70, 2)])
def test_split_workspace_is_what_the_wrappers_allocate(monkeypatch, shape):
    """Past the old bound kernel_gene allocates the split backward's
    workspace, one row block of rfe and one of dlog_rfe (rows x ldw floats
    each), dpsi's dsplit x rows x Kf gene ranges' sums (the layout
    kernel_backward's call with dpsi fills; one layout for both calls; and
    where one row block's cells go in slices, the slices' partial
    sums; and where S*C is no multiple of 4, dZ's row block and muL at a
    row pitch of whole float4s), and its (Kf + SC + n_a2, G) output, which the products write in
    place of chunk partial sums: wide_plan's gene_workspace, with A2 and
    without; kernel_dpsi one row block of t = rfe drfe and dsplit x rows x
    Kf gene ranges' sums, its dpsi_workspace; kernel_forward the split
    forward's, the Y products' table and A1's partial sums, one row block of
    rfe, the zsplit x rows x SC gene ranges' sums of Z where more than one
    and muL at a row pitch of whole float4s where S*C is no multiple of 4,
    its fwd_workspace. Each entry point gets the
    plan's numbers, its split key 1 (a call within the bound, as S 66's
    without A2, gets today's workspace). The wrappers run on CPU tensors
    with the CUDA library's entry points recorded, not called."""
    N, G, C, K, S = shape
    Y, psi, W, log_mu, muL = _torch(_inputs(N, G, C, K, S, seed=2))
    dA1, dA2, dZ = _torch(_cotangents(N, S, S * C, seed=2))
    lib, sizes = _recorded_wrappers(monkeypatch)
    for da2, n_a2 in ((dA2, S), (None, 0)):
        p = tfl.wide_plan(N, G, K, n_a2, S * C)
        assert p["split"] == tfl.split_route(K, n_a2, S * C)
        sizes.clear()
        tfl.kernel_forward(Y, psi, W, None if da2 is None else log_mu, muL)
        assert list(lib.calls["fl_forward_wide"][10]) == [p[k] for k in tfl.WIDE_PLAN_KEYS]
        assert sizes[-1] == p["fwd_workspace"]
        if p["split"]:
            zpart = -(-p["zsplit"] * p["rows"] * S * C // 4) * 4 if p["zsplit"] > 1 else 0
            assert p["fwd_workspace"] == (p["table"] + p["a1part"] + p["rows"] * p["ldw"] + zpart
                                          + G * p["ldz"])
        sizes.clear()
        tfl.kernel_gene(Y, psi, W, muL, dA1, da2, dZ)
        F = K + S * C + n_a2
        if p["split"]:
            gpart = -(-p["gslices"] * F * G // 4) * 4 if p["gslices"] > 1 else 0
            pad = (p["rows"] + G) * p["ldz"]
            assert p["ldz"] == (-(-S * C // 4) * 4 if S * C % 4 else 0)
            assert sizes == [2 * p["rows"] * p["ldw"] + p["dsplit"] * p["rows"] * K + gpart + pad,
                             F * G]
        assert sum(sizes) == p["gene_workspace"]
        assert list(lib.calls["fl_backward_gene_wide"][10]) == [p[k] for k in tfl.WIDE_PLAN_KEYS]
    p = tfl.wide_plan(N, G, K, 0, S * C)
    sizes.clear()
    tfl.kernel_dpsi(psi, W, muL, dA1, dZ, Y @ W)
    assert sizes == [N * K, p["dpsi_workspace"]] and p["dpsi_workspace"] == (
        p["rows"] * p["ldw"] + p["dsplit"] * p["rows"] * K + (p["rows"] + G) * p["ldz"]
        if p["split"] else p["dtable"])
    assert list(lib.calls["fl_backward_dpsi_wide"][8]) == [p[k] for k in tfl.WIDE_PLAN_KEYS]


@pytest.mark.parametrize("shape", PAST_BOUND_SHAPES + [(37, 41, 3, 70, 2)])
def test_split_backward_takes_both_parts_in_one_call(monkeypatch, shape):
    """kernel_backward (the autograd function's backward) past the old bound
    makes one library call for dpsi and the gene part, the gene part's
    entry point fl_backward_gene_wide with dpsi, with the gene part's plan:
    dpsi (N, Kf), its bwd_workspace (the gene part's: one row block of rfe
    and dlog_rfe, dpsi's gene ranges' sums) less the output, and the (Kf +
    SC + n_a2, G) output; counted in split_launches alone. Within the bound
    (S 66 without A2) it calls kernel_dpsi and kernel_gene, as before, each
    counted in its own counter."""
    N, G, C, K, S = shape
    Y, psi, W, _log_mu, muL = _torch(_inputs(N, G, C, K, S, seed=3))
    dA1, dA2, dZ = _torch(_cotangents(N, S, S * C, seed=3))
    lib, sizes = _recorded_wrappers(monkeypatch)
    for da2, n_a2 in ((dA2, S), (None, 0)):
        p = tfl.wide_plan(N, G, K, n_a2, S * C)
        lib.calls.clear()
        sizes.clear()
        before = _launches()
        tfl.kernel_backward(Y, psi, W, muL, dA1, da2, dZ, Y @ W)
        after = _launches()
        moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if not p["split"]:
            assert moved == {"dpsi_wide": 1, "gene_wide": 1}
            assert set(lib.calls) == {"fl_backward_dpsi_wide", "fl_backward_gene_wide"}
            continue
        assert moved == {"split": 1}
        F = K + S * C + n_a2
        assert list(lib.calls) == ["fl_backward_gene_wide"]
        assert sizes == [N * K, p["bwd_workspace"] - F * G, F * G]
        gpart = -(-p["gslices"] * F * G // 4) * 4 if p["gslices"] > 1 else 0
        assert p["bwd_workspace"] == p["gene_workspace"] == (
            2 * p["rows"] * p["ldw"] + p["dsplit"] * p["rows"] * K + gpart
            + (p["rows"] + G) * p["ldz"] + F * G)
        call = lib.calls["fl_backward_gene_wide"]
        assert call[7] is not None  # dpsi
        assert list(call[10]) == [p[k] for k in tfl.WIDE_PLAN_KEYS]


@pytest.mark.parametrize("shape", PLAN_SHAPES + PAST_PLAN_SHAPES)
def test_split_route_takes_exactly_the_widths_past_the_old_bound(shape):
    """wide_plan's one rule: a call past Kf 64, n_a2 64 or S*C 2,048 (the
    old bound) gets the split backward (its rows, ldw and gene ranges, the
    ungrouped kernels' keys 0), and every call within it today's
    ungrouped dpsi_wide_kernel and gene_wide_kernel (their passes and
    tiles, the split keys 0); dpsi's plan (n_a2 0) by its own widths."""
    N, G, Kf, n_a2, SC = shape
    past = Kf > 64 or n_a2 > 64 or SC > 2048
    for a2 in (n_a2, 0):
        p = tfl.wide_plan(N, G, Kf, a2, SC)
        assert tfl.split_route(Kf, a2, SC) == bool(p["split"]) == (Kf > 64 or a2 > 64 or SC > 2048)
        if p["split"]:
            assert min(p["rows"], p["ldw"], p["dsplit"], p["dgenes"]) > 0
            assert p["nj"] == p["dk_pad"] == p["dtable"] == 0
        else:
            assert p["ldw"] == p["dsplit"] == p["dgenes"] == 0
            assert p["nj"] in tfl.WIDE_TILE_COUNTS and p["dk_pad"] in tfl.WIDE_DPSI_K_COUNTS
    assert not past or shape in PAST_PLAN_SHAPES


def test_wide_plan_holds_at_every_bound():
    """At Kf = 64, S = 64 and S*C = 2,048, and N past 65,535 chunks of 1,024
    cells: grid.y within 65,535 (chunks and column groups), chunks whole
    16-cell stages, accumulator tiles within WIDE_TILES, dpsi's tiles built
    counts that cover every column with its shared memory within two blocks
    an SM, and every workspace region 16-byte aligned. Past it, at the same
    N: the split backward's row blocks hold every cell, each within grid.y's
    65,535 tiles and its workspace within 2^23 floats past one tile of
    cells, and the forward's groups within 65,535. (The kernels' shared
    memory, laid out on the card from the plan, is held to two blocks an SM
    there: test_cuda_wide_plans_run_two_blocks_an_sm.)"""
    for N in (1, 1024, 65_535 * 1024 + 1, 2**31 - 1):
        for Kf, n_a2, SC in ((72, 66, 2178), (72, 0, 660), (1, 0, 2049), (0, 65, 1)):
            p = tfl.wide_plan(N, 5_000, Kf, n_a2, SC)  # past it: the split backward
            assert p["split"] and p["n_zgroups"] <= 65_535 and p["n_ygroups"] <= 65_535
            assert p["n_chunks"] * p["rows"] >= N > (p["n_chunks"] - 1) * p["rows"]
            assert -(-p["rows"] // 64) <= 65_535 and p["dsplit"] <= 65_535
            assert p["rows"] * p["ldw"] <= max(64 * p["ldw"], 1 << 23)
            assert all(p[k] % 4 == 0 for k in ("table", "a1part", "ldw"))
        for Kf, n_a2, SC in ((64, 64, 2048), (64, 0, 2048), (0, 0, 2048), (64, 64, 1), (1, 0, 33)):
            p = tfl.wide_plan(N, 5_000, Kf, n_a2, SC)
            assert p["n_chunks"] <= 65_535 and p["n_zgroups"] <= 65_535
            assert p["rows"] % 16 == 0 and p["n_chunks"] * p["rows"] >= N
            assert p["n_pad"] % 16 == 0 and p["n_pad"] >= N
            assert max(p["zt_group"], p["ny_pad"], p["nj"] + p["n_kc"]) <= tfl.WIDE_TILES
            assert all(p[k] % 4 == 0 for k in ("table", "part", "dz", "ps", "a2", "dtable"))
            assert p["dk_pad"] >= p["n_kc"] and p["n_dgroups"] * p["dz_group"] >= p["n_zt"]
            assert p["dpsi_smem"] <= tfl._TWO_BLOCK_SMEM


# --- the number scheme, emulated -----------------------------------------------

def _tf32(x):
    """cvt.rna.tf32.f32 on float32 values: round to nearest, ties away from
    zero, on the 13 low significand bits (the kernels' round_tf32)."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32((x - hi).astype(np.float32))


def _mma3(a, b, kb):
    """The 3xTF32 products of a (M, K) and b (K, N), in fresh accumulators
    for each block of kb along K: (K / kb, M, N) float32 block sums, each
    block's lo.hi + hi.lo + hi.hi products (exact in float32) summed exactly
    and rounded once."""
    (M, K), N = a.shape, b.shape[1]
    pad = -K % kb
    a = np.pad(a, ((0, 0), (0, pad))).astype(np.float32)
    b = np.pad(b, ((0, pad), (0, 0))).astype(np.float32)
    (ah, al), (bh, bl) = _split(a), _split(b)
    nb = (K + pad) // kb
    f64 = [t.astype(np.float64) for t in (ah, al, bh, bl)]
    ah, al, bh, bl = f64
    A = lambda t: t.reshape(M, nb, kb)
    B = lambda t: t.reshape(nb, kb, N)
    d = (np.einsum("mbk,bkn->bmn", A(al), B(bh)) + np.einsum("mbk,bkn->bmn", A(ah), B(bl))
         + np.einsum("mbk,bkn->bmn", A(ah), B(bh)))
    return d.astype(np.float32)


def _running(blocks):
    """A float32 running sum over the leading axis, in order."""
    acc = np.zeros(blocks.shape[1:], np.float32)
    for d in blocks:
        acc = (acc + d).astype(np.float32)
    return acc


def _dpsi_scheme(psi, W, muL, dA1, dZ, YW, plan):
    """dpsi_wide_kernel's arithmetic: log_rfe = psi W^T (fresh every 8
    columns of [psi, X], float32 sum), one exp an element; for each of the
    plan's dZ column groups, drfe = dZ muL^T over the group's columns (fresh
    every 8 columns, float32 running sum) and t = rfe drfe in float32, then
    dpsi's products t W in fresh accumulators every 8 genes (a k-step),
    summed in float32 over each stage of ``dsteps`` k-steps and in float64
    over the stages and groups; dA1 YW added last in float64."""
    f32 = np.float32
    rfe = np.exp(_running(_mma3(psi, W.T, 8))).astype(f32)
    cols = 8 * plan["dz_group"]
    acc = np.zeros(psi.shape, np.float64)
    for g in range(plan["n_dgroups"]):
        part = slice(g * cols, (g + 1) * cols)
        drfe = _running(_mma3(dZ[:, part], muL[:, part].T, 8))
        steps = _mma3((rfe * drfe).astype(f32), W, 8)  # (k-steps, N, Kf)
        steps = np.concatenate([steps, np.zeros((-len(steps) % plan["dsteps"], *steps.shape[1:]),
                                                f32)])
        for stage in steps.reshape(-1, plan["dsteps"], *steps.shape[1:]):
            acc += _running(stage)
    return (dA1[:, None].astype(np.float64) * YW.astype(np.float64) + acc).astype(f32)


def _sliced(blocks):
    """The split backward's sum of fresh blocks of 16 along K: two warp
    groups take alternate blocks (the halves of each 32-wide stage), each a
    float32 running sum, the second group's added to the first's."""
    return (_running(blocks[0::2]) + _running(blocks[1::2])).astype(np.float32)


def _split_scheme(Y, psi, W, muL, dA1, dZ, YW, plan):
    """The split backward's arithmetic (dlog_rfe_kernel and the tiled
    products): every product fresh every 16 of its K (a pair of k-steps),
    summed as :func:`_sliced`; log_rfe = psi W^T, one exp an element, drfe = dZ
    muL^T, t = rfe drfe and dlog_rfe = Y dA1 + t in float32 (one rounding,
    fmaf); over each row block of ``rows`` cells (or slice of ``gcells``)
    dW = dlog_rfe^T psi and d(muL) = rfe^T dZ, the blocks added in float32
    in order; dpsi = t W over
    each range of ``dgenes`` genes, the ranges summed in float64 and dA1 YW
    added last in float64. Returns (dpsi, dW, d(muL))."""
    f32, f64 = np.float32, np.float64
    rfe = np.exp(_sliced(_mma3(psi, W.T, 16))).astype(f32)
    t = (rfe * _sliced(_mma3(dZ, muL.T, 16))).astype(f32)
    dlog = (Y.astype(f64) * dA1[:, None] + t).astype(f32)
    rows = plan["gcells"]  # a row block's cells, or its slices' where one block is sliced
    blocks = range(0, len(Y), rows)
    dW = _running(np.stack([_sliced(_mma3(dlog[i:i + rows].T, psi[i:i + rows], 16))
                            for i in blocks]))
    dmuL = _running(np.stack([_sliced(_mma3(rfe[i:i + rows].T, dZ[i:i + rows], 16))
                              for i in blocks]))
    ranges = range(0, W.shape[0], plan["dgenes"])
    g = plan["dgenes"]
    acc = sum(_sliced(_mma3(t[:, i:i + g], W[i:i + g], 16)).astype(f64) for i in ranges)
    dpsi = (dA1[:, None].astype(f64) * YW.astype(f64) + acc).astype(f32)
    return dpsi, dW, dmuL


def _split_forward_scheme(psi, W, muL, plan):
    """The split forward's arithmetic (dlog_rfe_kernel's rfe-only form and
    dpsi_product_kernel with muL): log_rfe = psi W^T fresh every 16 of Kf,
    summed as :func:`_sliced`, one exp an element in float32; Z = rfe muL
    over each range of ``zgenes`` genes, fresh every 16 genes, summed as
    :func:`_sliced`; the ranges summed in float64 in order and rounded once
    (one range: its float32 sum as it stands). Row blocks change nothing: Z's
    row n reads only cell n."""
    rfe = np.exp(_sliced(_mma3(psi, W.T, 16))).astype(np.float32)
    g = plan["zgenes"]
    ranges = [_sliced(_mma3(rfe[:, i:i + g], muL[i:i + g], 16)) for i in range(0, len(W), g)]
    return sum(r.astype(np.float64) for r in ranges).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES + [(2100, 130, 9, 1, 4), (60, 90, 12, 6, 8),
                                            (50, 80, 10, 64, 2), (40, 60, 10, 72, 66),
                                            (300, 300, 66, 1, 33), (64, 600, 3, 72, 2)])
def test_3xtf32_scheme_meets_the_tolerances(shape):
    """The wide kernels' arithmetic, emulated on the CPU: log_rfe = psi W^T
    and Z = rfe muL (fresh accumulators every 16 genes, float32 running sum)
    within VALUE_TOL of float64; drfe = dZ muL^T (fresh every 8 columns),
    dlog_rfe = rfe drfe + Y dA1 in float32, then d(muL) = rfe^T dZ and dW =
    dlog_rfe^T psi (fresh every 8 cells, a float32 running sum over each
    1,024-cell chunk, the chunks added in float32 in order), and dpsi as
    dpsi_wide_kernel forms it (:func:`_dpsi_scheme`, from the forward's YW:
    fresh every 8 genes, float32 running sum), each within BWD_ABS_RTOL of
    each element's absolute-term sum. Every product is 3xTF32 with
    cvt.rna's rounding. The shapes past SHAPES take several 1,024-cell
    chunks, two dZ column groups (S*C = 96) and Kf = 64. Past the old bound
    (Kf 72; S*C 2,178) the split forward's and backward's schemes instead
    (:func:`_split_forward_scheme`, at the last shape in three gene ranges,
    and :func:`_split_scheme`)."""
    N, G, C, K, S = shape
    Y, psi, W, _log_mu, muL = _inputs(N, G, C, K, S, seed=N)
    dA1, _dA2, dZ = _cotangents(N, S, S * C, seed=N)
    f32 = np.float32
    plan = tfl.wide_plan(N, G, K, 0, S * C)
    log_rfe = _running(_mma3(psi, W.T, 8))
    rfe = np.exp(log_rfe).astype(f32)
    Z = (_split_forward_scheme(psi, W, muL, plan) if plan["split"]
         else _running(_mma3(rfe, muL, 16)))
    assert plan["zsplit"] == (3 if shape == (64, 600, 3, 72, 2) else int(plan["split"]))
    f64 = [torch.from_numpy(a.astype(np.float64)) for a in (Y, psi, W, muL, dA1, dZ)]
    Y64, psi64, W64, muL64, dA164, dZ64 = f64
    want_Z = (torch.exp(psi64 @ W64.T) @ muL64).numpy()
    np.testing.assert_allclose(Z, want_Z, **VALUE_TOL)

    YW = _running(_mma3(Y, W, 8))
    if plan["split"]:
        dpsi, dW, dmuL = _split_scheme(Y, psi, W, muL, dA1, dZ, YW, plan)
    else:
        drfe = _running(_mma3(dZ, muL.T, 8))
        dlog = (rfe * drfe + Y * dA1[:, None]).astype(f32)
        rows = tfl._chunk_rows(N)
        chunks = range(0, N, rows)
        dmuL = _running(np.stack([_running(_mma3(rfe[i:i + rows].T, dZ[i:i + rows], 8))
                                  for i in chunks]))
        dW = _running(np.stack([_running(_mma3(dlog[i:i + rows].T, psi[i:i + rows], 8))
                                for i in chunks]))
        dpsi = _dpsi_scheme(psi, W, muL, dA1, dZ, YW, plan)
    want_dpsi, want_dW, _dlog_mu, want_dmuL = tfl.reference_likelihood_vjp(
        Y64, psi64, W64, muL64, dA164, None, dZ64)
    scale_dpsi, scale_dW, _s, scale_dmuL = _abs_term_sums(Y64, psi64, W64, muL64, dA164, None,
                                                          dZ64)
    for name, got, want, scale in (("dpsi", dpsi, want_dpsi, scale_dpsi),
                                   ("dW", dW, want_dW, scale_dW),
                                   ("dmuL", dmuL, want_dmuL, scale_dmuL)):
        err = np.abs(got.astype(np.float64) - want.numpy())
        assert (err <= BWD_ABS_RTOL * scale.numpy()).all(), (name, float(err.max()))


# --- on the card ------------------------------------------------------------

def _abs_term_sums(Y, psi, W, muL, dA1, dA2, dZ):
    """Each VJP output's sums over the absolute values of its terms: with
    ``|dlog_rfe| = Y |dA1| + rfe (|dZ| muL^T)``, dpsi's ``|dlog_rfe| |W|``, dW's
    ``|dlog_rfe|^T |psi|``, dlog mu's ``|dA2|^T Y`` and d(muL)'s ``rfe^T |dZ|``."""
    rfe = torch.exp(psi @ W.T)
    dlog = Y * dA1.abs()[:, None] + rfe * (dZ.abs() @ muL.T)
    return (dlog @ W.abs(), dlog.T @ psi.abs(), None if dA2 is None else dA2.abs().T @ Y,
            rfe.T @ dZ.abs())


def _launches():
    return {"fwd": tfl.fwd_launches, "dpsi": tfl.dpsi_launches, "gene": tfl.gene_launches,
            "fwd_wide": tfl.fwd_wide_launches, "dpsi_wide": tfl.dpsi_wide_launches,
            "gene_wide": tfl.gene_wide_launches, "split": tfl.split_launches}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_cuda_wide_kernels_match_plain(shape, storage):
    """The forward (A2 on and off) and the backward against the plain
    versions on the card, with Y in each storage type, the backward taking
    Y W from the forward as the fit does; the forward against the float32
    plain version (VALUE_TOL), the backward against the float64 plain
    version of the same inputs (BWD_ABS_RTOL of each element's absolute-term
    sum). A narrow Y gives the float32 Y's results bit for bit. Each call is
    counted by the family :func:`wide_route` picks; kernel_backward past
    the old bound (:func:`split_route`) in split_launches alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, G, C, K, S = shape
    x = [t.cuda() for t in _torch(_inputs(N, G, C, K, S, seed=N))]
    dA1, dA2, dZ = [t.cuda() for t in _torch(_cotangents(N, S, S * C, seed=N))]
    Yf, psi, W, log_mu, muL = x
    Y = Yf.to(storage)
    before = _launches()
    want_launches = dict.fromkeys(before, 0)
    for lm, da2 in ((log_mu, dA2), (None, None)):
        n_a2 = 0 if lm is None else S
        fwd = "fwd_wide" if tfl.wide_route(K, n_a2, S * C) else "fwd"
        gene = "gene_wide" if tfl.wide_route(K, n_a2, S * C) else "gene"
        dpsi = "dpsi_wide" if tfl.wide_route(K, 0, S * C) else "dpsi"
        want_launches[fwd] += 2
        if tfl.split_route(K, n_a2, S * C):  # kernel_backward's one call
            want_launches[gene] += 2
            want_launches["split"] += 1
        else:
            want_launches[gene] += 3
            want_launches[dpsi] += 1 if K else 0
        *got, YW = tfl.kernel_forward(Y, psi, W, lm, muL)
        for g, f in zip((*got, YW), tfl.kernel_forward(Yf, psi, W, lm, muL)):
            assert (g is None and f is None) or torch.equal(g, f)
        assert torch.equal(tfl.kernel_gene(Y, psi, W, muL, dA1, da2, dZ)[2],
                           tfl.kernel_gene(Yf, psi, W, muL, dA1, da2, dZ)[2])
        want = tfl.reference_likelihood_terms(Y, psi, W, lm, muL)
        for name, g, w in zip(("A1", "A2", "Z"), got, want):
            if w is not None:
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), err_msg=name,
                                           **VALUE_TOL)
        np.testing.assert_allclose(YW.cpu().numpy(), (Yf @ W).cpu().numpy(), **VALUE_TOL)
        got = tfl.kernel_backward(Y, psi, W, muL, dA1, da2, dZ, YW)
        f64 = [None if t is None else t.double() for t in (Y, psi, W, muL, dA1, da2, dZ)]
        exact = tfl.reference_likelihood_vjp(*f64)
        scale = _abs_term_sums(*f64)
        for name, g, w, sc in zip(("psi", "W", "log_mu", "muL"), got, exact, scale):
            if w is not None:
                err = (g.double() - w).abs()
                assert bool((err <= BWD_ABS_RTOL * sc).all()), (
                    name, float(err.max()), float((err / sc.clamp_min(1e-300)).max()))
    after = _launches()
    assert {k: after[k] - before[k] for k in after} == want_launches


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2100, 130, 9, 1, 4), (70, 300, 10, 6, 8)])
def test_cuda_wide_gene_part_is_deterministic(shape):
    """The wide gene part adds its chunks' partial sums in a fixed order,
    with no atomics: two calls on the same inputs give bitwise-equal
    results."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, G, C, K, S = shape
    Y, psi, W, _log_mu, muL = [t.cuda() for t in _torch(_inputs(N, G, C, K, S, seed=N))]
    dA1, dA2, dZ = [t.cuda() for t in _torch(_cotangents(N, S, S * C, seed=N))]
    before = tfl.gene_wide_launches
    first = tfl.kernel_gene(Y, psi, W, muL, dA1, dA2, dZ)
    second = tfl.kernel_gene(Y, psi, W, muL, dA1, dA2, dZ)
    assert tfl.gene_wide_launches == before + 2
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2100, 130, 9, 1, 4), (70, 300, 10, 6, 8),
                                   (2100, 200, 20, 18, 8), (40, 70, 3, 64, 64)])
def test_cuda_wide_dpsi_is_deterministic(shape):
    """The wide dpsi keeps each output in one lane and sums in a fixed order,
    with no atomics: two calls on the same inputs give bitwise-equal
    results, one column group or several (S*C = 160, 192)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, G, C, K, S = shape
    Y, psi, W, _log_mu, muL = [t.cuda() for t in _torch(_inputs(N, G, C, K, S, seed=N))]
    dA1, _dA2, dZ = [t.cuda() for t in _torch(_cotangents(N, S, S * C, seed=N))]
    YW = tfl.kernel_forward(Y, psi, W, None, muL)[3]
    before = tfl.dpsi_wide_launches
    first = tfl.kernel_dpsi(psi, W, muL, dA1, dZ, YW)
    second = tfl.kernel_dpsi(psi, W, muL, dA1, dZ, YW)
    assert tfl.dpsi_wide_launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2100, 130, 9, 1, 4), (70, 300, 10, 6, 8),
                                   (2100, 200, 20, 18, 8)])
def test_cuda_wide_forward_is_deterministic(shape):
    """The wide forward sums in a fixed order, with no atomics: two calls on
    the same inputs, A2 on and off, give bitwise-equal results."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, G, C, K, S = shape
    Y, psi, W, log_mu, muL = [t.cuda() for t in _torch(_inputs(N, G, C, K, S, seed=N))]
    before = tfl.fwd_wide_launches
    for lm in (log_mu, None):
        first = tfl.kernel_forward(Y, psi, W, lm, muL)
        second = tfl.kernel_forward(Y, psi, W, lm, muL)
        for a, b in zip(first, second):
            assert (a is None and b is None) or torch.equal(a, b)
    assert tfl.fwd_wide_launches == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("widths", INDEPENDENT_WIDTHS + PAST_BOUND_WIDTHS)
def test_cuda_wide_kernels_at_independent_widths(widths, storage):
    """The wide forward, dpsi and gene part at widths no fit gives (S*C
    below S, where the gene part's dlog mu takes a pass of its own beside
    dW) against the plain versions, with the tolerances of
    test_cuda_wide_kernels_match_plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, Kf, n_a2, SC = widths
    G = 100
    rng = np.random.default_rng(N + Kf + n_a2 + SC)
    f32 = np.float32
    Yf, psi, W, log_mu, muL, dA1, dA2, dZ = [torch.from_numpy(a).cuda() for a in (
        rng.poisson(3.0, (N, G)).astype(f32), rng.normal(0, 1, (N, Kf)).astype(f32),
        rng.normal(0, 0.3 / np.sqrt(Kf), (G, Kf)).astype(f32),
        rng.normal(0, 0.5, (n_a2, G)).astype(f32), rng.lognormal(0, 0.5, (G, SC)).astype(f32),
        rng.normal(0, 1, N).astype(f32), rng.normal(0, 1, (N, n_a2)).astype(f32),
        rng.normal(0, 1, (N, SC)).astype(f32))]
    Y = Yf.to(storage)
    *got, YW = tfl.kernel_forward(Y, psi, W, log_mu, muL)
    for name, g, w in zip(("A1", "A2", "Z"), got,
                          tfl.reference_likelihood_terms(Y, psi, W, log_mu, muL)):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), err_msg=name, **VALUE_TOL)
    got = (tfl.kernel_dpsi(psi, W, muL, dA1, dZ, YW), *tfl.kernel_gene(Y, psi, W, muL, dA1, dA2, dZ))
    f64 = [t.double() for t in (Y, psi, W, muL, dA1, dA2, dZ)]
    exact = tfl.reference_likelihood_vjp(*f64)
    scale = _abs_term_sums(*f64)
    for name, g, w, sc in zip(("psi", "W", "log_mu", "muL"), got, exact, scale):
        err = (g.double() - w).abs()
        assert bool((err <= BWD_ABS_RTOL * sc).all()), (
            name, float(err.max()), float((err / sc.clamp_min(1e-300)).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_cuda_wide_plans_run_two_blocks_an_sm(shape):
    """The library takes each plan wide_plan makes, and lays out the wide
    forward's, the Y products', the gene part's and dpsi's shared memory
    from it so that each holds at least two blocks an SM (the occupancy
    query), at every Y storage; dpsi takes the plan's k-steps a stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import ctypes

    from clonealign_torch.ops import _build
    lib = _build.load()
    N, G, Kf, n_a2, SC = shape
    plan = tfl._plan_arg(tfl.wide_plan(N, G, Kf, n_a2, SC))
    for code in range(4):
        out = (ctypes.c_int * 16)()
        assert lib.fl_wide_resources(plan, N, G, Kf, n_a2, SC, code, out) == 0
        assert min(out[1], out[3], out[5], out[7]) >= 2, list(out)
        p = tfl.wide_plan(N, G, Kf, n_a2, SC)
        assert (out[6], out[9]) == (p["dpsi_smem"], p["dsteps"]), list(out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAST_PLAN_SHAPES)
def test_cuda_past_bound_plans_launch_with_the_plans_shared_memory(shape):
    """Past the old bound the library takes each plan wide_plan makes, lays
    out each kernel's shared memory as wide_plan reckons it (``smem``, at
    float32 Y; the forward's k-steps a stage too): the forward's, and where
    the backward is the split one dlog_rfe_kernel's (with Y and without),
    dpsi_product_kernel's and gene_product_kernel's (the workspace's, and Y's
    for dlog mu); the forward holds at least one block an SM, and each of
    the split backward's kernels two of 8 warps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import ctypes

    from clonealign_torch.ops import _build
    lib = _build.load()
    N, G, Kf, n_a2, SC = shape
    p = tfl.wide_plan(N, G, Kf, n_a2, SC)
    out = (ctypes.c_int * 16)()
    assert lib.fl_wide_resources(tfl._plan_arg(p), N, G, Kf, n_a2, SC, 0, out) == 0
    sm = p["smem"]
    assert [out[0], out[2], out[8]] == [sm["fwd"], sm["fwd_y"], sm["fwd_steps"]], list(out)
    assert min(out[1], out[3]) >= 1, list(out)
    if p["split"]:
        assert [out[4], out[6], out[10], out[12], out[14], out[9]] == [
            sm["gene"], sm["dpsi"], sm["gene_products"], sm["gene_y"], sm["gene"], 0], list(out)
        assert min(out[5], out[7], out[11], out[13], out[15]) >= 2, list(out)
    else:
        assert [out[4], out[6], out[9]] == [sm["gene"], sm["dpsi"], p["dsteps"]], list(out)


@pytest.mark.cuda
@pytest.mark.parametrize("widths", PAST_BOUND_WIDTHS)
def test_cuda_split_backward_is_deterministic(widths):
    """Past the old bound the split backward (its row blocks added in order
    into the output, dpsi's gene ranges summed in order, no atomics) gives
    bitwise-equal outputs across two launches, A2 on (every width past the
    bound) and off: kernel_dpsi and kernel_gene at N 300 (one row block),
    each counted in the family :func:`wide_route` picks, and
    kernel_backward, the call the fit makes, at N 300 and at N 100,000,
    where N x G passes 2^23 and its row blocks are two, counted in
    split_launches where the plan is the split one; and so does the split
    forward (its Z ranges summed in order), kernel_forward at N 300 and
    100,000, counted in fwd_wide_launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    N, Kf, n_a2, SC = widths
    G = 100
    rng = np.random.default_rng(N + Kf + n_a2 + SC + 1)
    f32 = np.float32

    def inputs(n):
        return [torch.from_numpy(a).cuda() for a in (
            rng.poisson(3.0, (n, G)).astype(np.int8), rng.normal(0, 1, (n, Kf)).astype(f32),
            rng.normal(0, 0.3 / np.sqrt(Kf), (G, Kf)).astype(f32),
            rng.lognormal(0, 0.5, (G, SC)).astype(f32), rng.normal(0, 1, n).astype(f32),
            rng.normal(0, 1, (n, n_a2)).astype(f32), rng.normal(0, 1, (n, SC)).astype(f32),
            rng.normal(0, 1, (n, Kf)).astype(f32), rng.normal(0, 0.5, (n_a2, G)).astype(f32))]

    before = _launches()
    want = dict.fromkeys(before, 0)
    Y, psi, W, muL, dA1, dA2, dZ, YW, _log_mu = inputs(N)
    for da2 in (dA2, None):
        a2 = 0 if da2 is None else n_a2
        assert tfl.wide_plan(N, G, Kf, a2, SC)["split"] or da2 is None
        want["dpsi_wide" if tfl.wide_route(Kf, 0, SC) else "dpsi"] += 2
        want["gene_wide" if tfl.wide_route(Kf, a2, SC) else "gene"] += 2
        runs = [(tfl.kernel_dpsi(psi, W, muL, dA1, dZ, YW),
                 *tfl.kernel_gene(Y, psi, W, muL, dA1, da2, dZ)) for _ in range(2)]
        for a, b in zip(*runs):
            assert (a is None and b is None) or torch.equal(a, b)
    for n in (N, 100_000):
        Y, psi, W, muL, dA1, dA2, dZ, YW, log_mu = inputs(n)
        for da2, lm in ((dA2, log_mu), (None, None)):
            a2 = 0 if da2 is None else n_a2
            p = tfl.wide_plan(n, G, Kf, a2, SC)
            assert p["n_chunks"] == (1 if n == N else 2) or not p["split"]
            if p["split"]:
                want["split"] += 2
            else:
                want["dpsi_wide" if tfl.wide_route(Kf, 0, SC) else "dpsi"] += 2
                want["gene_wide" if tfl.wide_route(Kf, a2, SC) else "gene"] += 2
            runs = [tfl.kernel_backward(Y, psi, W, muL, dA1, da2, dZ, YW) for _ in range(2)]
            for a, b in zip(*runs):
                assert (a is None and b is None) or torch.equal(a, b)
            want["fwd_wide" if tfl.wide_route(Kf, a2, SC) else "fwd"] += 2
            runs = [tfl.kernel_forward(Y, psi, W, lm, muL) for _ in range(2)]
            for a, b in zip(*runs):
                assert (a is None and b is None) or torch.equal(a, b)
    after = _launches()
    assert {k: after[k] - before[k] for k in after} == want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(100_000, 5_000, 1, 0, 10), (100_000, 5_000, 3, 2, 10),
                                   (2100, 130, 4, 4, 32), (1, 1, 0, 0, 1)])
def test_cuda_gene_scratch_is_the_librarys(shape):
    """fused_likelihood.gene_scratch, which restarts._sweep_bytes reckons
    with on any device, is the scratch the library's narrow gene part asks
    for (fl_backward_gene_scratch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from clonealign_torch.ops import _build
    N, G, Kf, n_a2, SC = shape
    lib = _build.load()
    assert tfl.gene_scratch(N, G, Kf, n_a2, SC) == lib.fl_backward_gene_scratch(
        N, G, Kf, n_a2, SC, tfl._chunk_rows(N))


def test_assign_cells_against_a_wide_fit():
    """Serving reads the fit's parameters, not the kernels: a fit with
    K = 1, P = 4 and mc_samples = 8 serves its own training cells with the
    fit's labels (tests/test_serve.py's agreement bar, > 0.95)."""
    Y, L, X = _sim(N=120, G=60, seed=9)
    fit = ct.clonealign(Y, L, x=X, K=1, mc_samples=8, max_iter=60, seed=1, device="cpu",
                        verbose=False)
    clones, probs = ct.assign_cells(fit, Y, L, device="cpu")
    assert probs.shape == (120, 5) and np.isfinite(probs).all()
    assert np.mean(np.asarray(clones) == np.asarray(fit.clone)) > 0.95


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """Both kernel sources include the split kernels' shared header, and
    the built library's name (a hash of what it is built from) changes
    with the header as with a source, so an edited header is rebuilt."""
    from clonealign_torch.ops import _build

    (header,) = _build.HEADERS
    for src in _build.SOURCES:
        assert f'#include "{header.name}"' in src.read_text()
    copies = []
    for path in _build.SOURCES + _build.HEADERS:
        copies.append(tmp_path / path.name)
        copies[-1].write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "SOURCES", tuple(copies[:-1]))
    monkeypatch.setattr(_build, "HEADERS", (copies[-1],))
    name = _build.library_path().name
    copies[-1].write_text(copies[-1].read_text() + "\n")
    assert _build.library_path().name != name

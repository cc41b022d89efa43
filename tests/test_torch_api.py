"""clonealign_torch's public entry points on the CPU: the fit-object
contract, agreement with the JAX package's fits, the input checks the JAX
package's round-5 fixes define (tests/test_round5_fixes.py), restarts,
persistence, and the port's own guarantees (no jax import, explicit device,
no silent fallback for options it does not cover)."""

import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import clonealign_tpu as ca
import clonealign_torch as ct
from clonealign_torch import api as tapi
from clonealign_torch.assign import compute_correlations, multirun_calls_device
from clonealign_torch.models import multinomial as tmm
from clonealign_torch.ops import fused_likelihood as tfl
from clonealign_torch.utils.device import resolve_device, resolve_dtype

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLE_SCE = REPO / "data" / "example_sce.npz"


def _example():
    z = np.load(EXAMPLE_SCE)
    return z["counts"], z["copy_number"]


def _toy(N=60, G=24, C=3, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.integers(1, 4, size=(G, C)).astype(np.float64)
    z = rng.integers(0, C, size=N)
    rates = L[:, z].T * rng.uniform(0.5, 2.0, size=G)[None, :]
    Y = rng.poisson(rates * 3.0).astype(np.int16)
    Y[Y.sum(axis=1) == 0, 0] = 1
    return Y, L


@pytest.fixture(scope="module")
def example_fit():
    Y, L = _example()
    return ct.clonealign(Y, L, device="cpu", seed=0, verbose=False, dtype="float64")


def test_fit_object_contract(example_fit):
    Y, L = _example()
    fit = example_fit
    N, G = Y.shape
    assert isinstance(fit, ct.ClonealignFit)
    assert len(fit.clone) == N
    assert set(fit.clone) <= {"clone_a", "clone_b", "clone_c", "unassigned"}
    assert fit.clone_names == ["clone_a", "clone_b", "clone_c"]
    mp = fit.ml_params
    assert set(mp) == {"mu", "clone_probs", "s", "alpha", "psi", "W", "chi"}
    assert mp["clone_probs"].shape == (N, 3) and mp["mu"].shape == (G,)
    np.testing.assert_allclose(mp["clone_probs"].sum(axis=1), 1.0, rtol=1e-12)
    np.testing.assert_array_equal(mp["s"], Y.sum(axis=1))
    ci = fit.convergence_info
    assert ci.elbo.shape == (ci.n_iters + 1,) and np.isfinite(ci.elbo).all()
    assert ci.elbo[-1] > ci.elbo[0] and np.isfinite(ci.final_elbo) and ci.sd_final_elbo > 0
    assert len(fit.retained_genes) == G and fit.correlations.shape == (G,)
    assert set(fit.timings) == {"setup", "init", "inference", "loop", "package"}
    # the device path of compute_correlations equals the host path
    host = compute_correlations(Y, L, fit.clone, fit.clone_names)
    np.testing.assert_allclose(fit.correlations, host, rtol=1e-10, equal_nan=True)


def test_labels_agree_with_jax_fit(example_fit):
    """Independent noise streams, so cells near the 0.95 threshold may fall
    either side of it: two JAX fits with different seeds agree on 99% of
    the 200 cells; the bar is 97%, the same clone counts within 3."""
    Y, L = _example()
    jax_fit = ca.clonealign(Y, L, seed=0, verbose=False, dtype="float64")
    agree = np.mean(np.asarray(jax_fit.clone) == np.asarray(example_fit.clone))
    assert agree >= 0.97
    cj, ct_ = Counter(jax_fit.clone), Counter(example_fit.clone)
    assert all(abs(cj[k] - ct_[k]) <= 3 for k in set(cj) | set(ct_))
    np.testing.assert_allclose(example_fit.convergence_info.final_elbo,
                               jax_fit.convergence_info.final_elbo, rtol=1e-3)


def test_cell_infeasible_in_every_clone_raises_typed_error():
    Y, L = _toy(N=30, G=12)
    L = L.copy()
    L[2, :] = 0.0
    Y[:, 2] = 0
    Y[4, 2] = 3
    with pytest.raises(ValueError, match="no clone can explain"):
        tmm.prepare_data(Y, L, device="cpu")
    with pytest.raises(ValueError, match="no clone can explain"):
        ct.clonealign(Y, L, max_iter=3, device="cpu", verbose=False)
    # a cell infeasible only through a gene the filter removes still fits:
    # the filter runs before the feasibility check
    Y[4, 2] = 1
    fit = ct.clonealign(Y, L, max_iter=3, device="cpu", verbose=False,
                        gene_filter_threshold=1)
    assert len(fit.retained_genes) == 11 and np.isfinite(fit.convergence_info.final_elbo)


def test_partially_impossible_cell_gets_zero_responsibility():
    Y, L = _toy(N=30, G=12)
    L = L.copy()
    L[2, 0] = 0.0
    L[2, 1:] = 2.0
    Y[:, 2] = 0
    Y[4, 2] = 3
    fit = ct.clonealign(Y, L, max_iter=5, device="cpu", verbose=False)
    assert np.isfinite(fit.convergence_info.final_elbo)
    assert float(fit.ml_params["clone_probs"][4, 0]) == 0.0


def test_numpy_bool_data_init_mu():
    Y, L = _toy(N=30, G=12)
    for flag in (np.bool_(True), np.bool_(False), np.array(True)):
        fit = ct.clonealign(Y, L, data_init_mu=flag, max_iter=3, seed=0,
                            device="cpu", verbose=False)
        assert np.isfinite(fit.convergence_info.final_elbo)
    ref = ct.clonealign(Y, L, data_init_mu=True, max_iter=3, seed=0, device="cpu", verbose=False)
    got = ct.clonealign(Y, L, data_init_mu=np.bool_(True), max_iter=3, seed=0,
                        device="cpu", verbose=False)
    assert ref.convergence_info.final_elbo == got.convergence_info.final_elbo


@pytest.mark.parametrize("bad", ["negative", "fractional", "nan", "zero_cell"])
def test_bad_counts_rejected(bad):
    Y, L = _toy()
    Y = Y.astype(np.float64)
    if bad == "negative":
        Y[0, 0] = -129  # would wrap positive in an int8 cast
        match = "non-negative raw counts"
    elif bad == "fractional":
        Y = Y * 1.5
        match = "raw integer counts"
    elif bad == "nan":
        Y[1, 1] = np.nan
        match = "NaN"
    else:
        Y[3] = 0
        match = "no counts"
    with pytest.raises(ValueError, match=match):
        tapi.setup_fit(Y, L, verbose=False, device="cpu")
    if bad == "negative":
        with pytest.raises(ValueError, match="non-negative raw counts"):
            tmm.prepare_data(Y, L, device="cpu")
    if bad == "fractional":
        ctx = tapi.setup_fit(Y, L, verbose=False, device="cpu", allow_fractional=True)
        assert ctx.data.Y.dtype == torch.float32


def test_run_clonealign_picks_best_lane():
    Y, L = _toy()
    fit = ct.run_clonealign(Y, L, initial_shrinks=(0, 5, 10), n_repeats=1, max_iter=20,
                            seed=3, device="cpu", print_elbos=False, verbose=False)
    info = fit.multirun_info
    assert set(info) == {"elbos", "clone_prevalences_at_different_shrinks",
                         "median_correlations", "initial_shrinks", "best_run"}
    assert info["best_run"] == int(np.nanargmax(info["elbos"]))
    np.testing.assert_array_equal(info["initial_shrinks"], [0.0, 5.0, 10.0])
    assert fit.convergence_info.final_elbo == info["elbos"][info["best_run"]]
    assert all(sum(p.values()) == Y.shape[0] for p in info["clone_prevalences_at_different_shrinks"])
    # lane 0 of a sweep is the single fit with the same seed: exactly so in
    # sequence, and to float64 rounding as a lane of the batched loop
    one = ct.run_clonealign(Y, L, initial_shrinks=(5,), n_repeats=1, max_iter=20, seed=3,
                            device="cpu", print_elbos=False, verbose=False,
                            restart_batching="map")
    single = ct.clonealign(Y, L, max_iter=20, seed=3, device="cpu", verbose=False)
    assert one.convergence_info.final_elbo == single.convergence_info.final_elbo
    lanes = ct.run_clonealign(Y, L, initial_shrinks=(5, 0), n_repeats=1, max_iter=20, seed=3,
                              device="cpu", print_elbos=False, verbose=False,
                              restart_batching="vmap", dtype="float64")
    single = ct.clonealign(Y, L, max_iter=20, seed=3, device="cpu", verbose=False,
                           dtype="float64")
    np.testing.assert_allclose(lanes.multirun_info["elbos"][0],
                               single.convergence_info.final_elbo, rtol=1e-12)
    assert lanes.timings["iterations"][0] == single.convergence_info.n_iters


def test_multirun_calls_match_host_assignment():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 50, 3))
    logits[1, 7] = np.nan
    called, counts = multirun_calls_device(torch.tensor(logits), 0.9)
    names = ["a", "b", "c"]
    for r in range(4):
        probs = torch.softmax(torch.tensor(logits[r]), dim=1).numpy()
        host = ct.clone_assignment(probs, names, 0.9)
        labels = names + ["unassigned"]
        assert [labels[i] for i in called[r]] == host
        assert counts[r].sum() == 50
    assert called[1, 7] == 3


def test_save_load_roundtrip(example_fit, tmp_path):
    path = example_fit.save(str(tmp_path / "fit"))
    back = ct.ClonealignFit.load(path)
    assert back.clone == example_fit.clone
    assert back.clone_names == example_fit.clone_names
    for k, v in example_fit.ml_params.items():
        np.testing.assert_array_equal(back.ml_params[k], v)
    np.testing.assert_array_equal(back.convergence_info.elbo, example_fit.convergence_info.elbo)
    np.testing.assert_array_equal(back.correlations, example_fit.correlations)


def test_preprocess_matches_jax():
    Y, L = _example()
    cn = {"A": L[:, 0], "B": L[:, 1], "C": L[:, 2]}
    got = ct.preprocess_for_clonealign(Y, cn, min_counts_per_cell=10)
    want = ca.preprocess_for_clonealign(Y, cn, min_counts_per_cell=10)
    np.testing.assert_array_equal(got.gene_expression_data, want.gene_expression_data)
    np.testing.assert_array_equal(got.copy_number_data, want.copy_number_data)
    assert got.clone_names == want.clone_names


def test_import_leaves_jax_out():
    code = (
        "import sys, clonealign_torch, clonealign_torch.convert, clonealign_torch.ops._build, "
        "clonealign_torch.serve, clonealign_torch.stream; "
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('clonealign_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=REPO)
    assert out.stdout.strip() == "[]"


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    Y, L = _toy()
    with pytest.raises(RuntimeError, match="cuda"):
        ct.clonealign(Y, L, device="cuda", verbose=False)
    with pytest.raises(ValueError, match="explicitly"):
        resolve_device(None)
    # the entry points default to the card, and do not fall back to the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        ct.clonealign(Y, L, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        ct.run_clonealign(Y, L, verbose=False)


@pytest.mark.parametrize("option", [
    dict(mesh=object()),
])
def test_options_outside_the_slice_raise(option):
    """``mesh`` is ported: one that make_mesh did not make is refused."""
    Y, L = _toy()
    with pytest.raises(TypeError, match="make_mesh"):
        ct.run_clonealign(Y, L, device="cpu", verbose=False, **option)


def test_a_genes_mesh_axis_is_not_ported():
    """make_mesh takes a genes axis with the JAX package's shape check (one
    rank cannot hold a 0 x 2 mesh), and the layouts split the per-gene
    fields along it (clonealign_tpu/parallel/sharding.py:59-96)."""
    from clonealign_torch.parallel.collectives import GENE_AXIS
    from clonealign_torch.parallel.sharding import data_shardings, make_mesh, param_specs

    with pytest.raises(ValueError, match="mesh 0x2 != 1 ranks"):
        make_mesh(devices="cpu", gene_parallelism=2)
    assert make_mesh(devices="cpu", gene_parallelism=1).shape == {"cells": 1, "genes": 1}
    specs = param_specs()
    assert {f for f, spec in vars(specs).items() if GENE_AXIS in spec} == {
        "W", "beta", "qmu_loc", "qmu_log_scale"}
    assert specs.W == (GENE_AXIS, None) and specs.qmu_loc == (GENE_AXIS,)
    data = data_shardings(has_x=True)
    assert data.Y == ("cells", GENE_AXIS) and data.L == (GENE_AXIS, None)
    assert data.colsum_Y == (GENE_AXIS,)


def test_float64_on_cuda_resolves():
    """float64 runs on the card through the float64 kernel family."""
    assert resolve_dtype("float64", torch.device("cuda")) == torch.float64
    assert resolve_dtype("float32", torch.device("cuda")) == torch.float32
    with pytest.raises(ValueError, match="dtype"):
        resolve_dtype("float16", torch.device("cuda"))


def test_reference_keywords():
    Y, L = _toy()
    kw = dict(max_iter=3, seed=1, device="cpu", verbose=False)
    ref = ct.clonealign(Y, L, **kw)
    for extra in (dict(loop_impl="scan"), dict(unroll=4), dict(remat=False)):
        got = ct.clonealign(Y, L, **kw, **extra)
        assert got.convergence_info.final_elbo == ref.convergence_info.final_elbo
    sweep = dict(kw, initial_shrinks=(5,), n_repeats=1, print_elbos=False)
    got = ct.run_clonealign(Y, L, loop_impl="scan", unroll=2, remat=True, **sweep)
    assert got.convergence_info.final_elbo == ref.convergence_info.final_elbo
    for call, extra in ((ct.clonealign, kw), (ct.run_clonealign, sweep)):
        with pytest.raises(ValueError, match="seed"):
            call(Y, L, key=object(), **extra)
        with pytest.raises(ValueError, match="loop_impl"):
            call(Y, L, loop_impl="for", **extra)


def _setup_passes_the_contract_on_cuda(monkeypatch, Y, L, **kwargs):
    """setup_fit on a CUDA device (torch.cuda.is_available patched true)
    gets past the host checks, the kernels' contract among them: it
    returns where there is a card, and without one fails only at its first
    allocation on the card, not with a refusal."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    parsed = []
    parse = tapi._parse_inputs
    monkeypatch.setattr(tapi, "_parse_inputs", lambda *a, **k: parsed.append(parse(*a, **k))
                        or parsed[-1])
    try:
        tapi.setup_fit(Y, L, device="cuda", verbose=False, **kwargs)
    except NotImplementedError:
        raise
    except (AssertionError, RuntimeError) as err:  # no card behind the patched check
        assert "CUDA" in str(err)
    assert len(parsed) == 1


@pytest.mark.parametrize("K,S,C,wide", [
    (5, 1, 3, True), (1, 5, 3, True), (1, 2, 17, True), (1, 1, 33, True),
    (4, 4, 8, False), (0, 1, 32, False),
])
def test_wide_kernel_contract_is_refused_at_setup_on_cuda(monkeypatch, K, S, C, wide):
    """Widths past the narrow kernels' limits (K > 4, mc_samples > 4,
    mc_samples x clones > 32) go to the wide family: on CUDA the contract
    takes them (it refuses only past the wide family's bound,
    tests/test_torch_wide.py), and setup_fit with them."""
    tapi._check_kernel_contract(torch.device("cpu"), K, S, C)  # the CPU takes any width
    tapi._check_kernel_contract(torch.device("cuda"), K, S, C)
    assert tfl.wide_route(K, S, S * C) is wide
    Y, L = _toy(C=C)
    _setup_passes_the_contract_on_cuda(monkeypatch, Y, L, K=K, mc_samples=S)


def test_golden_example_meets_the_oracle_bar():
    """The bar tests/test_tpu_hardware.py holds the TPU to on the reference
    data (example_sce, seed 7, 500 iterations, float32): the final ELBO
    within max(1e-4 |e64|, 3 sd_final) of the float64 oracle, and labels
    that differ from the float64 oracle's only where the max probability is
    within 0.01 of the 0.95 threshold. (The float32 oracle's exact labels
    need the JAX package's noise stream.)"""
    oracle = np.load(REPO / "tests" / "golden" / "tpu_parity_oracle.npz")
    Y, L = _example()
    fit = ct.clonealign(Y, L, max_iter=500, seed=7, dtype="float32", device="cpu",
                        verbose=False)
    e64 = float(oracle["example_elbo64"])
    ci = fit.convergence_info
    assert abs(ci.final_elbo - e64) < max(1e-4 * abs(e64), 3.0 * ci.sd_final_elbo)
    probs = fit.ml_params["clone_probs"]
    flips = np.flatnonzero(np.asarray(fit.clone) != oracle["example_clone64"])
    assert all(abs(probs[i].max() - 0.95) < 0.01 for i in flips), flips

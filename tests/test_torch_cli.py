"""The command line of clonealign_torch (``python -m clonealign_torch``),
in-process with ``--device cpu``, on the JAX package's CLI fixture
(tests/test_cli.py: simulate_multinomial(N=60, G=40, C=3, seed=9) as a
gene-major .mtx.gz and a CSV). Each command's fit equals the port's library
call with the same arguments on the same arrays (labels identical, final
ELBO within 1e-9 relative; both run the same float32 arithmetic, so they
agree to the last bit in practice); every refusal of the JAX CLI comes back
with its exit code and message; ``assign`` against fits the JAX package
saved matches the JAX package's ``assign_cells`` within 1e-5 absolute (its
float32 against the port's).

The MatrixMarket files are read by the pure-Python reader here
(``CLONEALIGN_TPU_NO_NATIVE=1``): test_torch_io.py holds both readers
against the JAX package's, and a reader that builds the native library at
first use must not race another test process building it."""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import clonealign_torch as ct
from clonealign_torch.__main__ import main
from clonealign_torch.io import mtx as tmtx
from clonealign_torch.models import negbin as tn
from clonealign_torch.synth import assignment_accuracy, simulate_multinomial

REPO = Path(__file__).resolve().parents[1]
NAMES = ["A", "B", "C"]
ITERS = 30


@pytest.fixture(scope="module", autouse=True)
def _python_mtx_reader():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CLONEALIGN_TPU_NO_NATIVE", "1")
        mp.setattr(tmtx, "_lib", None)
        yield


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    sim = simulate_multinomial(N=60, G=40, C=3, seed=9, mean_total=500)
    dense = sim.Y.T  # genes x cells on disk
    nz = np.argwhere(dense != 0)
    with gzip.open(d / "counts.mtx.gz", "wt") as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n")
        fh.write(f"{dense.shape[0]} {dense.shape[1]} {len(nz)}\n")
        for r, c in nz:
            fh.write(f"{r + 1} {c + 1} {int(dense[r, c])}\n")
    with open(d / "cnv.csv", "w") as fh:
        fh.write("gene,A,B,C\n")
        for i, row in enumerate(sim.L):
            fh.write(f"g{i}," + ",".join(str(int(v)) for v in row) + "\n")
    # the arrays the CLI reads, made independently: a CSR of the counts and
    # the clone columns by the CSV's header
    Y = sp.csr_matrix(sim.Y)
    cnv = dict(zip(NAMES, sim.L.T))
    return d, sim, Y, cnv


def _fit_args(d, out, *extra, device="cpu"):
    """`fit` of the fixture's files; ``device=None`` leaves --device out (the
    JAX CLI has none; the port's defaults to "cuda")."""
    return ["fit", "--counts", str(d / "counts.mtx.gz"), "--cnv", str(d / "cnv.csv"),
            "--out", str(out), "--transpose", "--max-iter", str(ITERS), "--seed", "1",
            "--quiet", *extra, *(["--device", device] if device else [])]


LIB = dict(max_iter=ITERS, seed=1, verbose=False, device="cpu")


def assert_same_fit(got, want, sim):
    assert got.clone == want.clone
    assert got.clone_names == want.clone_names == NAMES
    a, b = got.convergence_info.final_elbo, want.convergence_info.final_elbo
    assert abs(a - b) <= 1e-9 * abs(b)
    assert got.convergence_info.n_iters == want.convergence_info.n_iters
    assert assignment_accuracy(got.clone, got.clone_names, sim.clone_idx) > 0.9


def test_fit_show_info(cli, capsys):
    d, sim, Y, cnv = cli
    assert main(_fit_args(d, d / "fit.npz")) == 0
    fit = ct.ClonealignFit.load(str(d / "fit.npz"))
    assert_same_fit(fit, ct.clonealign(Y, cnv, **LIB), sim)
    capsys.readouterr()
    assert main(["show", str(d / "fit.npz")]) == 0
    out = capsys.readouterr().out
    info = json.loads(out[out.index("{"):])
    assert info["final_elbo"] == fit.convergence_info.final_elbo
    assert sum(info["clone_counts"].values()) == 60
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"clonealign_torch {ct.__version__}\n")
    assert f"torch {torch.__version__}" in out
    assert "kernel library: " in out and "native loader: fallback (pure python)" in out


@pytest.mark.parametrize("variant", ["restarts", "stream", "z_cheb", "preprocess", "rds"])
def test_fit_variants_match_library(cli, variant):
    d, sim, Y, cnv = cli
    out = d / f"{variant}.{'rds' if variant == 'rds' else 'npz'}"
    extra, lib = {
        "restarts": (["--restarts", "3"], lambda: ct.run_clonealign(
            Y, cnv, initial_shrinks=(5,), n_repeats=3, print_elbos=False, **LIB)),
        "stream": (["--stream", "--chunk-cells", "16"], lambda: ct.fit_streaming(
            Y, cnv, chunk_cells=16, **LIB)),
        "z_cheb": (["--likelihood-impl", "z_cheb"], lambda: ct.clonealign(
            Y, cnv, likelihood_impl="z_cheb", **LIB)),
        "preprocess": (["--preprocess"], lambda: _preprocessed(Y, cnv)),
        "rds": ([], lambda: ct.clonealign(Y, cnv, **LIB)),
    }[variant]
    assert main(_fit_args(d, out, *extra)) == 0
    load = ct.ClonealignFit.load_rds if variant == "rds" else ct.ClonealignFit.load
    got, want = load(str(out)), lib()
    assert_same_fit(got, want, sim)
    if variant == "restarts":
        assert got.multirun_info["best_run"] == want.multirun_info["best_run"]
        np.testing.assert_array_equal(got.multirun_info["elbos"], want.multirun_info["elbos"])
    if variant == "rds":  # float32 parameters come back as R's doubles
        for k, v in want.ml_params.items():
            np.testing.assert_array_equal(got.ml_params[k], np.asarray(v, np.float64))


def _preprocessed(Y, cnv):
    pp = ct.preprocess_for_clonealign(Y, cnv)
    return ct.clonealign(pp.gene_expression_data,
                         dict(zip(pp.clone_names, pp.copy_number_data.T)), **LIB)


@pytest.mark.parametrize("impl", ["auto", "cheb"])
def test_fit_negbin_v1_matches_library(cli, capsys, impl):
    d, sim, Y, cnv = cli
    out = d / f"v1_{impl}.npz"
    args = _fit_args(d, out, "--model", "negbin-v1", "--likelihood-impl", impl)
    args.remove("--seed"), args.remove("1")  # the v1 fit refuses --seed
    assert main(args) == 0
    got = ct.ClonealignV1Fit.load(str(out))
    want = ct.inference_em(Y, np.column_stack([cnv[k] for k in NAMES]), max_iter=ITERS,
                           clone_names=NAMES, verbose=False, device="cpu",
                           likelihood_impl="cheb" if impl == "cheb" else "exact")
    assert got.clone == want.clone and got.clone_names == NAMES
    assert got.final_elbo == want.final_elbo and got.n_iter == want.n_iter
    assert assignment_accuracy(got.clone, NAMES, sim.clone_idx) > 0.9
    capsys.readouterr()
    assert main(["show", str(out)]) == 0
    info = json.loads((o := capsys.readouterr().out)[o.index("{"):])
    assert info["model"] == "negbin_v1" and info["final_elbo"] == got.final_elbo
    # assign: the classify_cells dispatch
    a_out = d / f"assign_v1_{impl}.npz"
    assert main(["assign", "--fit", str(out), "--counts", str(d / "counts.mtx.gz"),
                 "--cnv", str(d / "cnv.csv"), "--out", str(a_out), "--transpose",
                 "--quiet", "--device", "cpu"]) == 0
    z = np.load(a_out)
    clones, probs = tn.classify_cells(got, Y, np.column_stack([cnv[k] for k in NAMES]),
                                      device="cpu")
    assert [str(c) for c in z["clone"]] == list(clones)
    np.testing.assert_array_equal(z["clone_probs"], probs)


REFUSALS = {
    "cheb_without_v1": (["--likelihood-impl", "cheb"], "v1.npz",
                        "--likelihood-impl cheb is only valid with --model negbin-v1"),
    "stream_restarts": (["--stream", "--restarts", "3"], "x.npz",
                        "--stream does not support --restarts"),
    "v1_rds_out": (["--model", "negbin-v1"], "v1.rds", "v1 fits save as .npz"),
    "v1_restarts": (["--model", "negbin-v1", "--restarts", "5"], "x.npz",
                    "--restarts, --seed not supported with --model negbin-v1"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_fit_refusals_match_jax(cli, capsys, case):
    from clonealign_tpu.__main__ import main as jmain

    d = cli[0]
    extra, out, msg = REFUSALS[case]
    capsys.readouterr()
    assert main(_fit_args(d, d / out, *extra)) == 2
    err = capsys.readouterr().err
    assert msg in err
    assert jmain(_fit_args(d, d / out, *extra, device=None)) == 2
    assert capsys.readouterr().err == err


def test_layer_refusal_and_h5ad_layer(cli, tmp_path):
    """--layer on a file that is not .h5ad raises the JAX CLI's ValueError
    in-process; on an .h5ad it reads that layer's counts."""
    h5py = pytest.importorskip("h5py")
    from clonealign_tpu.__main__ import main as jmain

    d, sim, Y, cnv = cli
    with pytest.raises(ValueError) as je:
        jmain(_fit_args(d, tmp_path / "x.npz", "--layer", "counts", device=None))
    with pytest.raises(ValueError, match="--layer applies to .h5ad inputs only") as te:
        main(_fit_args(d, tmp_path / "x.npz", "--layer", "counts"))
    assert str(te.value) == str(je.value)

    p = tmp_path / "scanpy.h5ad"
    counts = Y.astype(np.int32)
    with h5py.File(p, "w") as f:
        f["X"] = np.log1p(sim.Y)  # normalized, fractional
        g = f.create_group("layers/counts")
        g.attrs["encoding-type"], g.attrs["shape"] = "csr_matrix", counts.shape
        g["data"], g["indices"], g["indptr"] = counts.data, counts.indices, counts.indptr
    args = ["fit", "--counts", str(p), "--layer", "counts", "--cnv", str(d / "cnv.csv"),
            "--out", str(tmp_path / "h5.npz"), "--max-iter", str(ITERS), "--seed", "1",
            "--quiet", "--device", "cpu"]
    assert main(args) == 0
    assert_same_fit(ct.ClonealignFit.load(str(tmp_path / "h5.npz")),
                    ct.clonealign(counts, cnv, **LIB), sim)


def test_assign_against_jax_saved_fits(cli, capsys):
    """`assign --fit` of a fit the JAX package fitted and saved, as .npz and
    as .rds, against the JAX package's assign_cells on the same fit; and
    --latent on a v1 fit is refused as the JAX CLI refuses it."""
    import clonealign_tpu as jct
    from clonealign_tpu.__main__ import main as jmain

    d, sim, Y, cnv = cli
    jfit = jct.clonealign(Y, cnv, max_iter=ITERS, seed=1, verbose=False)
    jfit.save(str(d / "jax_fit.npz"))
    jfit.save_rds(str(d / "jax_fit.rds"))
    for latent in ("auto", "ignore"):
        want_clones, want = jct.assign_cells(jfit, Y, sim.L, latent=latent)
        for ext in ("npz", "rds"):
            out = d / f"assign_{ext}_{latent}.npz"
            assert main(["assign", "--fit", str(d / f"jax_fit.{ext}"),
                         "--counts", str(d / "counts.mtx.gz"), "--cnv", str(d / "cnv.csv"),
                         "--out", str(out), "--transpose", "--latent", latent, "--quiet",
                         "--device", "cpu"]) == 0
            z = np.load(out)
            np.testing.assert_allclose(z["clone_probs"], want, rtol=0, atol=1e-5)
            assert [str(c) for c in z["clone_names"]] == NAMES
            assert [str(c) for c in z["clone"]] == list(want_clones)

    args = _fit_args(d, d / "v1.npz", "--model", "negbin-v1")
    args[args.index("--max-iter") + 1] = "5"
    args.remove("--seed"), args.remove("1")  # the v1 fit refuses --seed
    assert main(args) == 0
    args = ["assign", "--fit", str(d / "v1.npz"), "--counts", str(d / "counts.mtx.gz"),
            "--cnv", str(d / "cnv.csv"), "--out", str(d / "y.npz"), "--transpose",
            "--latent", "refine", "--quiet"]
    capsys.readouterr()
    assert main(args + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert "--latent refine applies to v2 fits only" in err
    assert jmain(args) == 2
    assert capsys.readouterr().err == err


def test_cuda_without_a_gpu_exits_nonzero(cli, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = cli[0]
    fit_args = _fit_args(d, d / "never.npz", device=None)  # --device left at "cuda"
    assign_args = ["assign", "--fit", str(d / "fit.npz"), "--counts",
                   str(d / "counts.mtx.gz"), "--cnv", str(d / "cnv.csv"),
                   "--out", str(d / "never_a.npz"), "--transpose"]
    for args in (fit_args, assign_args):
        capsys.readouterr()
        assert main(args) == 1
        err = capsys.readouterr().err
        assert "error: --device cuda:" in err and "torch.cuda.is_available() is false" in err
    assert not (d / "never.npz").exists() and not (d / "never_a.npz").exists()


def test_fresh_interpreter_loads_no_jax(cli):
    """`python -m clonealign_torch info` and `show` run in fresh
    interpreters, and importing the CLI, io, cnv, plot and profiling modules
    loads no jax* and no clonealign_tpu* module."""
    d = cli[0]
    env = {**os.environ, "CLONEALIGN_TPU_NO_NATIVE": "1"}
    for cmd in (["info"], ["show", str(d / "fit.npz")]):
        run = subprocess.run([sys.executable, "-m", "clonealign_torch", *cmd], cwd=REPO,
                             env=env, capture_output=True, text=True, timeout=120)
        assert run.returncode == 0, run.stderr
    code = (
        "import sys\n"
        "import clonealign_torch.__main__, clonealign_torch.cnv, clonealign_torch.plot\n"
        "import clonealign_torch.io.rds, clonealign_torch.io.mtx, clonealign_torch.io.h5\n"
        "import clonealign_torch.io.datasets, clonealign_torch.utils.profiling\n"
        "from clonealign_torch.__main__ import main\n"
        "assert main(['info']) == 0\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'clonealign_tpu'))))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip().splitlines()[-1] == "[]"

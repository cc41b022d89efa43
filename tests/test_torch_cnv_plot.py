"""clonealign_torch.cnv, assign.compute_ca_fit_mse, plot and
utils.profiling against the JAX package on the same inputs, made from a
numpy seed. Tolerances: the CNV mapping, the alignment, their errors, the
plot helpers and the figures' data (line and scatter data, axis limits,
titles) exactly; compute_ca_fit_mse within 1e-12 relative (one float64 mean
of squares, summed in the same order: the bar allows a last-place
difference)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp

import clonealign_torch as ct
from clonealign_torch import cnv as tcnv
from clonealign_torch import plot as tplot
from clonealign_torch.io.datasets import load_df_cnv
from clonealign_torch.utils import profiling
from clonealign_tpu import assign as jassign
from clonealign_tpu import cnv as jcnv


def _simple_case():
    # two clones; chr1 has two segments per clone, chr2 one per clone
    cnv = dict(cnv_chr=["1", "1", "1", "1", "2", "2"], cnv_start=[0, 100, 0, 100, 0, 0],
               cnv_end=[99, 200, 99, 200, 500, 500], cnv_copy_number=[2, 3, 2, 5, 1, 4],
               cnv_clone=["A", "A", "B", "B", "A", "B"])
    genes = dict(gene_ids=["g_left", "g_right", "g_span", "g_chr2", "g_nohit"],
                 gene_chr=["chr1", "1", "1", "2", "3"], gene_start=[10, 120, 90, 20, 0],
                 gene_end=[50, 180, 150, 30, 10])
    return {**cnv, **genes}


def _bundled_case():
    """The bundled df_cnv with genes drawn around its segments from a seed."""
    cnv = load_df_cnv()
    rng = np.random.default_rng(11)
    n = 400
    seg = rng.integers(0, len(cnv["chr"]), n)
    start = rng.uniform(cnv["start"][seg], cnv["end"][seg])
    return dict(cnv_chr=cnv["chr"], cnv_start=cnv["start"], cnv_end=cnv["end"],
                cnv_copy_number=cnv["copy_number"], cnv_clone=cnv["clone"],
                gene_ids=[f"g{i}" for i in range(n)], gene_chr=cnv["chr"][seg],
                gene_start=start, gene_end=start + rng.uniform(0, 3e6, n))


CNV_CASES = {
    "simple": lambda: _simple_case(),
    "no_variance_filter": lambda: {**_simple_case(), "require_varying_copy_number": False},
    "max_min_cn": lambda: {**_simple_case(), "cnv_copy_number": [2, 3, 2, 5, 7, 8]},
    "no_max_min": lambda: {**_simple_case(), "max_min_copy_number": None},
    "chr_prefix": lambda: {**_simple_case(),
                           "cnv_chr": ["chr1", "chr1", "Chr1", "chr1", "chr2", "2"]},
    "nan_cn": lambda: {**_simple_case(), "cnv_copy_number": [2, 3, 2, np.nan, 1, 4]},
    "bundled": _bundled_case,
}


def _same_gene_cnv(a, b):
    assert a.copy_number.dtype == b.copy_number.dtype
    np.testing.assert_array_equal(a.copy_number, b.copy_number)
    assert (a.gene_ids, a.clone_names) == (b.gene_ids, b.clone_names)


@pytest.mark.parametrize("case", sorted(CNV_CASES))
def test_cnv_regions_to_genes_matches(case):
    args = CNV_CASES[case]()
    got = tcnv.cnv_regions_to_genes(**args)
    _same_gene_cnv(got, jcnv.cnv_regions_to_genes(**args))
    if case == "simple":
        assert dict(zip(got.gene_ids, got.copy_number.tolist())) == {
            "g_right": [3.0, 5.0], "g_chr2": [1.0, 4.0]}
    if case == "bundled":
        assert got.copy_number.shape[0] > 10


def _align_inputs(sparse):
    rng = np.random.default_rng(12)
    Y = rng.poisson(2.0, (15, 8)).astype(np.float64)
    names = [f"g{j}" for j in range(8)]
    ids = ["g5", "g1", "g7", "gX", "g2"]
    L = rng.integers(1, 5, (5, 3)).astype(np.float64)
    return (sp.csr_matrix(Y) if sparse else Y), names, ids, L


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("form", ["gene_cnv_matrix", "pair"])
def test_align_expression_to_cnv_matches(sparse, form):
    Y, names, ids, L = _align_inputs(sparse)

    def gene_cnv(m, ids=ids, L=L):
        return m.GeneCNVMatrix(L, ids, ["A", "B", "C"]) if form == "gene_cnv_matrix" else (ids, L)

    calls = {
        "drop": lambda m: m.align_expression_to_cnv(Y, names, gene_cnv(m), on_missing="drop"),
        "present": lambda m: m.align_expression_to_cnv(
            Y, names, gene_cnv(m, ids=[i for i in ids if i != "gX"], L=L[[0, 1, 2, 4]])),
        "missing": lambda m: m.align_expression_to_cnv(Y, names, gene_cnv(m)),
        "bad_mode": lambda m: m.align_expression_to_cnv(Y, names, gene_cnv(m), on_missing="x"),
        "duplicates": lambda m: m.align_expression_to_cnv(Y, names[:-1] + ["g0"], gene_cnv(m)),
        "disjoint": lambda m: m.align_expression_to_cnv(
            Y, [f"h{j}" for j in range(8)], gene_cnv(m), on_missing="drop"),
    }
    for name, call in calls.items():
        try:
            want = call(jcnv)
        except ValueError as e:
            with pytest.raises(ValueError) as te:
                call(tcnv)
            assert str(te.value) == str(e), name
            continue
        got = call(tcnv)
        assert sp.issparse(got[0]) == sp.issparse(want[0]) == sparse
        np.testing.assert_array_equal(got[0].toarray() if sparse else got[0],
                                      want[0].toarray() if sparse else want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]
        assert name in ("drop", "present")


@pytest.mark.parametrize("sparse", [False, True])
def test_compute_ca_fit_mse_matches(sparse):
    rng = np.random.default_rng(13)
    N, G, C = 40, 25, 3
    Y = rng.poisson(3.0, (N, G))
    L = rng.integers(1, 5, (G, C)).astype(np.float64)
    names = ["A", "B", "C"]
    fit = SimpleNamespace(clone=[names[i] for i in rng.integers(0, C, N)], clone_names=names,
                          ml_params={"mu": rng.uniform(0.5, 2.0, G)})
    Yin = sp.csr_matrix(Y) if sparse else Y
    for kwargs in ({}, {"model_mu": True}, {"random_clones": True},
                   {"model_mu": True, "random_clones": True}):
        got = ct.compute_ca_fit_mse(fit, Yin, L, rng=np.random.default_rng(7), **kwargs)
        want = jassign.compute_ca_fit_mse(fit, Yin, L, rng=np.random.default_rng(7), **kwargs)
        assert np.isfinite(got) and abs(got - want) <= 1e-12 * abs(want), kwargs


def test_plot_helpers_match():
    from clonealign_tpu import plot as jplot

    rng = np.random.default_rng(14)
    for x in (rng.integers(0, 6, 50), rng.normal(size=20), [10, 30, 20], [5, 5, 1], []):
        got = tplot._rank(x)
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, jplot._rank(x))
    for cnv in (rng.integers(1, 3, (40, 3)), np.zeros((0, 2)), np.ones((5, 1))):
        np.testing.assert_array_equal(tplot.segment_states(cnv), jplot.segment_states(cnv))


def _figure_data(fig):
    """What a figure draws: every axes' lines (xy data, color, width),
    scatters (offsets, colors), limits, titles, labels and legend texts."""
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "lines": [(ln.get_xydata().tolist(), ln.get_color(), ln.get_linewidth())
                      for ln in ax.get_lines()],
            "scatters": [(np.asarray(c.get_offsets()).tolist(),
                          np.asarray(c.get_facecolors()).tolist())
                         for c in ax.collections],
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "text": (ax.get_title(), ax.get_title("left"), ax.get_xlabel(), ax.get_ylabel()),
            "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        })
    return out


def test_plots_match():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from clonealign_tpu import plot as jplot

    rng = np.random.default_rng(15)
    N, G, C = 40, 25, 3
    logcounts = rng.normal(2, 1, (N, G))
    cnv = rng.integers(1, 4, (G, C)).astype(float)
    coords = dict(gene_chr=["1"] * 20 + ["2"] * 5, gene_start=rng.permutation(G) * 100.0,
                  gene_end=rng.permutation(G) * 100.0 + 50)
    cases = {
        "dict": dict(clones=rng.choice(["A", "B", "C", "unassigned"], N).tolist(),
                     cnv_data=dict(A=cnv[:, 0], B=cnv[:, 1], C=cnv[:, 2])),
        "array": dict(clones=rng.choice(["clone_a", "clone_b", "clone_c"], N).tolist(),
                      cnv_data=cnv, jitter_cnv=False, expression_ylim=None),
        "chr2": dict(clones=rng.choice(["A", "B", "C"], N).tolist(),
                     cnv_data=dict(A=cnv[:, 0], B=cnv[:, 1], C=cnv[:, 2]), chromosome="2",
                     clone_names=["C", "A"]),
    }
    for name, kw in cases.items():
        figs = [m.plot_clonealign(logcounts, **coords, rng=np.random.default_rng(3), **kw)
                for m in (tplot, jplot)]
        assert _figure_data(figs[0]) == _figure_data(figs[1]), name
        assert any(len(c.get_offsets()) for c in figs[0].axes[0].collections), name
        plt.close("all")
    for m in (tplot, jplot):
        with pytest.raises(ValueError, match="No genes on chromosome 7"):
            m.plot_clonealign(logcounts, cases["dict"]["clones"], cnv, **coords, chromosome="7")

    v2 = SimpleNamespace(convergence_info=SimpleNamespace(
        elbo=rng.normal(-100, 3, 30), final_elbo=-98.25, sd_final_elbo=1.5))
    v1 = SimpleNamespace(elbo_trace=rng.normal(-100, 3, 12), final_elbo=-97.0)
    for fit in (v2, v1):
        figs = [m.plot_elbo(fit) for m in (tplot, jplot)]
        assert _figure_data(figs[0]) == _figure_data(figs[1])
        plt.close("all")


def test_plot_adata_matches():
    pytest.importorskip("matplotlib")
    pd = pytest.importorskip("pandas")
    import matplotlib.pyplot as plt

    from clonealign_tpu import plot as jplot

    rng = np.random.default_rng(16)
    N, G = 30, 20
    adata = SimpleNamespace(X=sp.csr_matrix(rng.poisson(3, (N, G)).astype(float)))
    adata.layers = {"logcounts": np.log1p(adata.X.toarray())}
    adata.var = pd.DataFrame({"chr": ["1"] * G, "start_position": np.arange(G, dtype=float),
                              "end_position": np.arange(G, dtype=float) + 1,
                              "A": rng.integers(1, 4, G).astype(float),
                              "B": rng.integers(1, 4, G).astype(float)})
    clones = rng.choice(["A", "B", "unassigned"], N).tolist()
    for kw in ({"cnv_cols": ["A", "B"]}, {"cnv_data": adata.var[["A", "B"]], "layer": None}):
        figs = [m.plot_clonealign_adata(adata, clones, rng=np.random.default_rng(5), **kw)
                for m in (tplot, jplot)]
        assert _figure_data(figs[0]) == _figure_data(figs[1])
        plt.close("all")
    for kw in ({"cnv_cols": ["A", "B"], "chr_str": "nope"}, {"cnv_cols": ["A", "Z"]}, {}):
        with pytest.raises(ValueError) as je:
            jplot.plot_clonealign_adata(adata, clones, **kw)
        with pytest.raises(ValueError) as te:
            tplot.plot_clonealign_adata(adata, clones, **kw)
        assert str(te.value) == str(je.value)


def test_profiling_timed_and_trace(tmp_path, capsys):
    import torch

    with profiling.timed("probe"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    out = capsys.readouterr().out
    assert out.startswith("probe: ") and out.strip().endswith("s")
    logs = []
    with profiling.timed(sink=logs.append):
        pass
    assert logs[0].startswith("block: ")

    d = str(tmp_path / "trace")
    with profiling.trace(d) as prof:
        (torch.ones(32, 32) + 1).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert os.path.getsize(os.path.join(d, files[0])) > 0
    assert any(e.key == "aten::add" for e in prof.key_averages())

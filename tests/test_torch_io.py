"""clonealign_torch.io (mtx, h5, datasets) against the JAX package's readers
on the same files, made from a numpy seed: the same arrays (type, dtype,
shape and values), names and errors, exactly. The MatrixMarket readers are
compared on the native reader and on the pure-Python one."""

import gzip
import os

import numpy as np
import pytest
import scipy.sparse as sp

from clonealign_torch.io import datasets as tds
from clonealign_torch.io import mtx as tm
from clonealign_tpu.io import datasets as jds
from clonealign_tpu.io import mtx as jm


def _mtx_text(dense, field="integer", symmetry="general"):
    rows, cols = dense.shape
    if symmetry == "general":
        nz = np.argwhere(dense != 0)
    else:  # the lower triangle, as MatrixMarket stores a symmetric matrix
        nz = np.argwhere(np.tril(dense) != 0)
    lines = [f"%%MatrixMarket matrix coordinate {field} {symmetry}", "% a comment",
             f"{rows} {cols} {len(nz)}"]
    for r, c in nz:
        v = dense[r, c]
        lines.append(f"{r + 1} {c + 1}" + ("" if field == "pattern" else
                                           f" {int(v) if field == 'integer' else float(v)!r}"))
    return ("\n".join(lines) + "\n").encode()


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(0)
    d = rng.poisson(0.5, (30, 21)).astype(np.float64)
    d[0, 0] = 7  # a nonzero at the corner
    return d


def _square(dense, skew=False):
    s = dense[:21, :21] + dense[:21, :21].T
    if skew:
        s = np.tril(dense[:21, :21], -1)
        s = s - s.T
    return s


# name -> (matrix to write, field, symmetry)
MTX = {
    "integer": (lambda d: d, "integer", "general"),
    "real": (lambda d: d * 0.25, "real", "general"),
    "pattern": (lambda d: d, "pattern", "general"),
    "symmetric": (_square, "integer", "symmetric"),
    "skew": (lambda d: _square(d, skew=True), "integer", "skew-symmetric"),
}


@pytest.fixture(params=["native", "python"])
def reader(request, monkeypatch):
    """Both packages' modules on one reader: the native library (built from
    native/ by its Makefile at first use) or the pure-Python fallback."""
    for m in (tm, jm):
        monkeypatch.setattr(m, "_lib", None)
        monkeypatch.setattr(m, "_build_failed", False)
    if request.param == "python":
        monkeypatch.setenv("CLONEALIGN_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("CLONEALIGN_TPU_NO_NATIVE", raising=False)
        if tm._load_native() is None or jm._load_native() is None:
            pytest.skip("the native reader does not build here (needs make, g++ and zlib)")
    return request.param


def _same_read(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a).__name__ == type(b).__name__ == "COOMatrix"
        assert a.shape == b.shape
        for x, y in zip(a[:3], b[:3]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kind", sorted(MTX))
@pytest.mark.parametrize("gz", [False, True])
def test_read_mtx_matches(tmp_path, dense, reader, kind, gz):
    make, field, symmetry = MTX[kind]
    mat = make(dense)
    p = str(tmp_path / ("m.mtx" + (".gz" if gz else "")))
    payload = _mtx_text(mat, field, symmetry)
    with (gzip.open(p, "wb") if gz else open(p, "wb")) as fh:
        fh.write(payload)
    assert tm.read_mtx_info(p) == jm.read_mtx_info(p)
    want = (mat != 0).astype(np.float64) if field == "pattern" else mat
    for is_dense in (True, False):
        for transpose in (False, True):
            got = tm.read_mtx(p, dense=is_dense, transpose=transpose)
            _same_read(got, jm.read_mtx(p, dense=is_dense, transpose=transpose))
            full = got if is_dense else got.todense()
            np.testing.assert_array_equal(full, want.T if transpose else want)
            if not is_dense:
                _same_read_csr(got.tocsr(), jm.read_mtx(p, dense=False,
                                                        transpose=transpose).tocsr())


def _same_read_csr(a, b):
    assert a.format == b.format and a.dtype == b.dtype and a.shape == b.shape
    for x, y in ((a.data, b.data), (a.indices, b.indices), (a.indptr, b.indptr)):
        np.testing.assert_array_equal(x, y)


def test_mtx_errors_alike(tmp_path, reader):
    bad = {"array.mtx": b"%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
           "complex.mtx": b"%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
           "banner.mtx": b"not a matrix\n",
           "bounds.mtx": b"%%MatrixMarket matrix coordinate integer general\n2 2 1\n3 1 5\n"}
    for name, payload in bad.items():
        p = str(tmp_path / name)
        with open(p, "wb") as fh:
            fh.write(payload)
        with pytest.raises(ValueError) as te:
            tm.read_mtx(p)
        with pytest.raises(ValueError) as je:
            jm.read_mtx(p)
        assert str(te.value) == str(je.value), name


@pytest.mark.parametrize("gz", [False, True])
def test_load_cellranger_dir_matches(tmp_path, dense, reader, gz):
    d = tmp_path / "outs"
    d.mkdir()
    sfx = ".gz" if gz else ""
    opener = gzip.open if gz else open
    with opener(d / f"matrix.mtx{sfx}", "wb") as fh:
        fh.write(_mtx_text(dense.T))  # genes x cells on disk
    with opener(d / f"features.tsv{sfx}", "wt") as fh:
        fh.writelines(f"ENSG{j}\tgene{j}\tGene Expression\n" for j in range(dense.shape[1]))
    with opener(d / f"barcodes.tsv{sfx}", "wt") as fh:
        fh.writelines(f"BC{i}-1\n" for i in range(dense.shape[0]))
    for is_dense in (False, True):
        Yt, gt, bt = tm.load_cellranger_dir(str(d), dense=is_dense)
        Yj, gj, bj = jm.load_cellranger_dir(str(d), dense=is_dense)
        (_same_read if is_dense else _same_read_csr)(Yt, Yj)
        assert (gt, bt) == (gj, bj)
        assert gt[2] == "ENSG2" and bt[0] == "BC0-1"
    empty = tmp_path / "empty"
    empty.mkdir()
    for m in (tm, jm):
        with pytest.raises(FileNotFoundError, match="no matrix.mtx"):
            m.load_cellranger_dir(str(empty))


# --- HDF5: .h5ad and 10x .h5 ------------------------------------------------

def _names(prefix, n):
    return np.array([f"{prefix}{i}".encode() for i in range(n)])


def _obs_var(f, X):
    for group, idx, prefix, n in (("obs", "cell_id", "cell", X.shape[0]),
                                  ("var", "gene_id", "gene", X.shape[1])):
        g = f.create_group(group)
        g.attrs["_index"] = idx
        g[idx] = _names(prefix, n)


def _sparse_group(f, key, X, fmt, attrs=("encoding-type", "shape")):
    m = sp.csr_matrix(X) if fmt == "csr" else sp.csc_matrix(X)
    g = f.create_group(key)
    if "encoding-type" in attrs:
        g.attrs["encoding-type"] = f"{fmt}_matrix"
    if "h5sparse" in attrs:
        g.attrs["h5sparse_format"] = fmt
        g.attrs["h5sparse_shape"] = np.asarray(X.shape)
    if "shape" in attrs:
        g.attrs["shape"] = X.shape
    g["data"], g["indices"], g["indptr"] = m.data, m.indices, m.indptr


def _h5ad_dense(f, X):
    f["X"] = X
    _obs_var(f, X)


def _h5ad_csr(f, X):
    _sparse_group(f, "X", X, "csr")
    _obs_var(f, X)


def _h5ad_csc(f, X):
    _sparse_group(f, "X", X, "csc")
    _obs_var(f, X)


def _h5ad_h5sparse(f, X):
    _sparse_group(f, "X", X, "csr", attrs=("h5sparse",))


def _h5ad_undeclared(f, X):
    _sparse_group(f, "X", X, "csr", attrs=("shape",))


def _h5ad_int32(f, X):
    _sparse_group(f, "X", X.astype(np.int32), "csr")


def _h5ad_layers(f, X):
    f["X"] = np.log1p(X)
    f["layers/counts"] = X.astype(np.int32)
    _sparse_group(f, "layers/sparse", X * 2, "csr")
    _obs_var(f, X)


def _h5ad_categorical(f, X):
    f["X"] = X
    var = f.create_group("var")
    var.attrs["_index"] = "gene_id"
    gi = var.create_group("gene_id")
    gi["categories"] = _names("g", X.shape[1])[::-1]
    gi["codes"] = np.arange(X.shape[1], dtype=np.int8)[::-1]
    obs = f.create_group("obs")
    obs.attrs["_index"] = "cell_id"
    obs["cell_id"] = _names("c", X.shape[0])


def _h5ad_structured(f, X):
    f["X"] = X
    dt = np.dtype([("index", "S8"), ("val", "f8")])
    f.create_dataset("obs", data=np.array([(f"c{i}".encode(), 0.1) for i in range(X.shape[0])],
                                          dtype=dt))
    f.create_dataset("var", data=np.array([(f"g{j}".encode(), 1.0) for j in range(X.shape[1])],
                                          dtype=dt))


def _h5ad_coo(f, X):
    g = f.create_group("X")
    g.attrs["encoding-type"] = "coo_matrix"
    g.attrs["shape"] = X.shape
    g["data"], g["row"], g["col"] = np.ones(3), np.arange(3), np.arange(3)


def _h5ad_bad_index(f, X):
    f["X"] = X
    var = f.create_group("var")
    var.attrs["_index"] = "gene_id"
    var.create_group("gene_id")["something_else"] = np.arange(3)


H5AD = {k.removeprefix("_h5ad_"): v for k, v in globals().items() if k.startswith("_h5ad_")}


def _tenx(f, X):
    gxc = sp.csc_matrix(X.T)
    g = f.create_group("matrix")
    g["data"], g["indices"], g["indptr"] = gxc.data, gxc.indices, gxc.indptr
    g["shape"] = np.array(gxc.shape)
    g["barcodes"] = _names("BC", X.shape[0])
    g.create_group("features")["id"] = _names("ENSG", X.shape[1])


def _tenx_legacy(f, X):
    gxc = sp.csc_matrix(X.T)
    g = f.create_group("GRCh38")
    g["data"], g["indices"], g["indptr"] = gxc.data, gxc.indices, gxc.indptr
    g["shape"] = np.array(gxc.shape)
    g["genes"] = _names("ENSG", X.shape[1])
    g["barcodes"] = _names("BC", X.shape[0])


def _same_counts(a, b):
    assert sp.issparse(a) == sp.issparse(b)
    if sp.issparse(a):
        _same_read_csr(a, b)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _both(read_t, read_j, *args, **kwargs):
    """Both readers' results, or the same ValueError message from each."""
    try:
        want = read_j(*args, **kwargs)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            read_t(*args, **kwargs)
        assert str(te.value) == str(e)
        return None
    got = read_t(*args, **kwargs)
    _same_counts(got.counts, want.counts)
    assert (got.gene_names, got.cell_names) == (want.gene_names, want.cell_names)
    return got


@pytest.mark.parametrize("kind", sorted(H5AD))
def test_read_h5ad_matches(tmp_path, dense, kind):
    h5py = pytest.importorskip("h5py")
    from clonealign_torch.io.h5 import read_h5ad as tread
    from clonealign_tpu.io.h5 import read_h5ad as jread

    p = str(tmp_path / "t.h5ad")
    with h5py.File(p, "w") as f:
        H5AD[kind](f, dense)
    got = _both(tread, jread, p)
    if kind in ("coo", "bad_index"):
        assert got is None
    if kind == "layers":
        for layer in ("counts", "sparse", "bogus"):
            _both(tread, jread, p, layer=layer)


@pytest.mark.parametrize("writer", [_tenx, _tenx_legacy])
def test_read_10x_h5_matches(tmp_path, dense, writer):
    h5py = pytest.importorskip("h5py")
    from clonealign_torch.io.h5 import read_10x_h5 as tread
    from clonealign_tpu.io.h5 import read_10x_h5 as jread

    p = str(tmp_path / "t.h5")
    with h5py.File(p, "w") as f:
        writer(f, dense)
    got = _both(tread, jread, p)
    np.testing.assert_array_equal(got.counts.toarray(), dense)


# --- bundled datasets -------------------------------------------------------

def test_dataset_loaders_match():
    t, j = tds.load_example_sce(), jds.load_example_sce()
    for field in ("counts", "copy_number"):
        assert getattr(t, field).dtype == getattr(j, field).dtype
        np.testing.assert_array_equal(getattr(t, field), getattr(j, field))
    assert (t.gene_names, t.cell_names, t.clone_names) == (j.gene_names, j.cell_names,
                                                           j.clone_names)
    assert (t.n_cells, t.n_genes) == (200, 100) and t.counts.sum() == 16090
    for load in ("load_df_cnv", "load_example_fit"):
        a, b = getattr(tds, load)(), getattr(jds, load)()
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def test_dataset_override_and_conversion(tmp_path, monkeypatch):
    src = os.path.join(os.path.dirname(tds.__file__), "..", "..", "data", "df_cnv.npz")
    with np.load(src) as z:
        np.savez(tmp_path / "df_cnv.npz", **{k: z[k][:3] for k in z.files})
    monkeypatch.setenv("CLONEALIGN_TPU_DATA", str(tmp_path))
    a, b = tds.load_df_cnv(), jds.load_df_cnv()
    assert list(a) == list(b) and all(len(v) == 3 for v in a.values())
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(FileNotFoundError):
        tds.load_example_sce()
    with pytest.raises(NotImplementedError, match="waits for the reference's .rda data files"):
        tds.convert_reference_data(str(tmp_path))

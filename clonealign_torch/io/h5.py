"""HDF5 single-cell formats: AnnData ``.h5ad`` and 10x CellRanger ``.h5``;
a copy of ``clonealign_tpu/io/h5.py`` (NumPy only, h5py imported inside the
readers).

Minimal readers via h5py — no anndata/scanpy dependency. Sparse matrices
stay scipy-sparse in their on-disk dtype (the fit path's ingestion is
nnz-bound, ``api._parse_expression`` / ``prepare_data_sparse``), dense
matrices keep their on-disk dtype — nothing is densified or widened to
float64 here (a 200k x 20k h5ad would otherwise cost 32 GB of host RAM
before the fit even starts). Both readers return cells-by-genes counts plus
names, ready for :func:`clonealign_torch.clonealign`.

Encodings the h5ad reader understands (pinned against files written by the
real ``anndata`` package in tests/test_anndata_integration.py when it is
installed):

* dense ``X`` datasets;
* ``csr_matrix`` / ``csc_matrix`` groups (anndata >= 0.7 ``encoding-type``
  attr, or the legacy ``h5sparse_format`` attr, or — absent both — the
  presence of data/indices/indptr with a shape attr);
* string / bytes obs/var index columns, anndata >= 0.8 **categorical** index
  groups (``categories`` + ``codes``), and pre-0.7 structured-dataset
  obs/var.

Anything else raises a :class:`ValueError` naming the unsupported encoding
instead of mis-reading it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CountMatrix(NamedTuple):
    counts: object  # (cells, genes) ndarray or scipy sparse, on-disk dtype
    gene_names: list
    cell_names: list


def _decode(arr):
    return [x.decode() if isinstance(x, bytes) else str(x) for x in np.asarray(arr)]


def _attr(attrs, name, default=None):
    v = attrs.get(name, default)
    if isinstance(v, bytes):
        v = v.decode()
    return v


def _sparse_group_to_scipy(g, shape, key):
    """CSR/CSC group ('data', 'indices', 'indptr') -> scipy matrix in the
    on-disk dtype (no densification, no float64 widening)."""
    import scipy.sparse as sp

    enc = _attr(g.attrs, "encoding-type") or _attr(g.attrs, "h5sparse_format")
    if enc is None and all(k in g for k in ("data", "indices", "indptr")):
        # no declared encoding but the canonical CSR layout: anndata's CSR
        # indptr has n_obs + 1 entries, CSC has n_var + 1. For a SQUARE
        # matrix the indptr length matches both layouts and guessing wrong
        # silently transposes the data — refuse instead of mis-reading.
        if shape[0] == shape[1]:
            raise ValueError(
                f"sparse group {key!r} declares no encoding (no "
                "'encoding-type'/'h5sparse_format' attr) and the matrix is "
                f"square ({shape[0]}x{shape[1]}), so CSR vs CSC cannot be "
                "inferred from the indptr length; re-write the file with "
                "anndata >= 0.7 or add the encoding attr"
            )
        n = g["indptr"].shape[0] - 1
        enc = "csr" if n == shape[0] else "csc"
    if enc is None or not ("csr" in enc or "csc" in enc):
        raise ValueError(
            f"unsupported sparse encoding {enc!r} for {key!r} (expected a "
            "csr_matrix/csc_matrix group with data/indices/indptr)"
        )
    cls = sp.csr_matrix if "csr" in enc else sp.csc_matrix
    return cls((g["data"][:], g["indices"][:], g["indptr"][:]), shape=shape)


def _decode_index_like(node, key):
    """An obs/var index column: a plain string/bytes dataset, or an
    anndata >= 0.8 categorical group (categories + codes)."""
    import h5py

    if isinstance(node, h5py.Group):
        if "categories" in node and "codes" in node:
            cats = _decode(node["categories"][:])
            codes = np.asarray(node["codes"][:])
            return [cats[c] if c >= 0 else "" for c in codes]
        raise ValueError(
            f"unsupported index encoding for {key!r}: group with members "
            f"{sorted(node.keys())} (expected a dataset or a categorical "
            "group with 'categories' + 'codes')"
        )
    return _decode(node[:])


def _read_names(h5, group_name, fallback_n):
    """Extract the index column of an AnnData obs/var group."""
    if group_name not in h5:
        return [str(i) for i in range(fallback_n)]
    import h5py

    g = h5[group_name]
    index_col = _attr(g.attrs, "_index", "index")
    # membership tests on a DATASET iterate+compare rows (and crash on
    # structured dtypes), so branch on the container type first
    if isinstance(g, h5py.Group):
        if index_col in g:
            return _decode_index_like(g[index_col], f"{group_name}/{index_col}")
    elif g.dtype.names and "index" in g.dtype.names:
        # pre-0.7 anndata: obs/var stored as a structured dataset
        return _decode(g["index"])
    return [str(i) for i in range(fallback_n)]


def read_h5ad(path: str, layer: str = None) -> CountMatrix:
    """Read an AnnData ``.h5ad``: X (dense or sparse), obs_names, var_names.

    ``layer`` selects ``layers/<name>`` (e.g. "counts") instead of ``X`` —
    useful because scanpy pipelines usually leave normalized data in X (the
    fit API rejects fractional values with a message pointing here).

    Sparse X stays a scipy matrix (nnz-bound host memory); dense X keeps its
    on-disk dtype.
    """
    import h5py

    with h5py.File(path, "r") as f:
        key = f"layers/{layer}" if layer else "X"
        if key not in f:
            raise ValueError(f"{key!r} not found in {path}")
        X = f[key]
        if isinstance(X, h5py.Group):
            for attr_src, attr in ((X.attrs, "shape"), (X.attrs, "h5sparse_shape"), (f.attrs, "shape")):
                if attr in attr_src:
                    shape = tuple(int(v) for v in attr_src[attr])
                    break
            else:
                raise ValueError(
                    f"sparse group {key!r} has no shape attribute "
                    "(looked for 'shape' and legacy 'h5sparse_shape')"
                )
            counts = _sparse_group_to_scipy(X, shape, key)
        else:
            counts = X[:]
            if counts.ndim != 2:
                raise ValueError(
                    f"{key!r} in {path} is {counts.ndim}-D; expected a 2-D "
                    "cells x genes matrix"
                )
        n_obs, n_var = counts.shape
        cell_names = _read_names(f, "obs", n_obs)
        gene_names = _read_names(f, "var", n_var)
    return CountMatrix(counts, gene_names, cell_names)


def read_10x_h5(path: str) -> CountMatrix:
    """Read a CellRanger ``.h5`` (CSC genes x cells under the ``matrix``
    group, or legacy per-genome groups). Returns cells-by-genes counts as a
    scipy CSR matrix in the on-disk dtype (CellRanger writes int32)."""
    import h5py
    import scipy.sparse as sp

    with h5py.File(path, "r") as f:
        if "matrix" in f:
            g = f["matrix"]
            features = _decode(g["features/id"][:]) if "features" in g else _decode(g["genes"][:])
        else:
            # legacy format: one group per genome
            genome = next(iter(f.keys()))
            g = f[genome]
            features = _decode(g["genes"][:])
        shape = tuple(g["shape"][:])  # (genes, cells)
        mat = sp.csc_matrix(
            (g["data"][:], g["indices"][:], g["indptr"][:]), shape=shape
        )
        barcodes = _decode(g["barcodes"][:])
    # transpose of CSC is CSR — cells x genes without an element copy
    return CountMatrix(mat.T.tocsr(), features, barcodes)

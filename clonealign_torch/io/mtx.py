"""MatrixMarket / 10x-CellRanger ingestion; a copy of
``clonealign_tpu/io/mtx.py`` that loads the same native reader.

Backed by the native C++ loader (native/src/mtx_reader.cpp: mmap +
multi-threaded parse, gzip streaming) loaded via ctypes, with a pure-Python
fallback when no compiler is available. The native library is built lazily on
first use and cached under native/build/, shared with the JAX package;
``CLONEALIGN_TPU_NO_NATIVE=1`` selects the pure-Python reader in both.
"""

from __future__ import annotations

import ctypes
import gzip
import os
import subprocess
import threading
from typing import NamedTuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libclonealign_native.so")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _load_native():
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or os.environ.get("CLONEALIGN_TPU_NO_NATIVE") == "1":
        return None
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = os.path.join(_NATIVE_DIR, "src", "mtx_reader.cpp")
        stale = not os.path.exists(_LIB_PATH) or (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
        )
        if stale:
            try:
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.mtx_read_info.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, ctypes.c_char_p]
        lib.mtx_read_info.restype = ctypes.c_int
        lib.mtx_read_triplets.argtypes = [
            ctypes.c_char_p, i64p, i64p, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, i64p, ctypes.c_char_p,
        ]
        lib.mtx_read_triplets.restype = ctypes.c_int
        lib.mtx_read_dense.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
            ctypes.c_char_p,
        ]
        lib.mtx_read_dense.restype = ctypes.c_int
        _lib = lib
        return _lib


class COOMatrix(NamedTuple):
    rows: np.ndarray  # (nnz,) int64
    cols: np.ndarray  # (nnz,) int64
    vals: np.ndarray  # (nnz,) float64
    shape: tuple

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    def tocsr(self):
        """scipy CSR (duplicates summed, matching todense's add-at)."""
        import scipy.sparse as sp

        return sp.coo_matrix(
            (self.vals, (self.rows, self.cols)), shape=self.shape
        ).tocsr()


def _err_buf():
    return ctypes.create_string_buffer(256)


def read_mtx_info(path: str):
    """(rows, cols, nnz) exactly as declared by the header.

    (The native mtx_read_info doubles nnz for symmetric files — it is an
    ALLOCATION bound used internally by read_mtx — so the public API always
    parses the header in Python for a consistent answer.)"""
    return _py_read_header(path)[:3]


def read_mtx(path: str, dense: bool = True, transpose: bool = False):
    """Read a .mtx / .mtx.gz file.

    dense=True returns a float64 ndarray ((rows, cols), or (cols, rows) when
    ``transpose`` — the common cells-by-genes orientation for gene-major
    files); dense=False returns a :class:`COOMatrix` (``transpose`` swaps
    indices).
    """
    lib = _load_native()
    if lib is None:
        return _py_read_mtx(path, dense=dense, transpose=transpose)

    r = ctypes.c_int64()
    c = ctypes.c_int64()
    n = ctypes.c_int64()
    err = _err_buf()
    if lib.mtx_read_info(path.encode(), ctypes.byref(r), ctypes.byref(c), ctypes.byref(n), err):
        raise ValueError(f"mtx_read_info({path}): {err.value.decode()}")
    rows, cols, nnz_bound = r.value, c.value, n.value

    if dense:
        shape = (cols, rows) if transpose else (rows, cols)
        out = np.zeros(shape, np.float64)
        if lib.mtx_read_dense(
            path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            1 if transpose else 0, err,
        ):
            raise ValueError(f"mtx_read_dense({path}): {err.value.decode()}")
        return out

    ri = np.empty(nnz_bound, np.int64)
    ci = np.empty(nnz_bound, np.int64)
    vv = np.empty(nnz_bound, np.float64)
    out_n = ctypes.c_int64()
    if lib.mtx_read_triplets(
        path.encode(),
        ri.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        nnz_bound, ctypes.byref(out_n), err,
    ):
        raise ValueError(f"mtx_read_triplets({path}): {err.value.decode()}")
    k = out_n.value
    if transpose:
        return COOMatrix(ci[:k], ri[:k], vv[:k], (cols, rows))
    return COOMatrix(ri[:k], ci[:k], vv[:k], (rows, cols))


def load_cellranger_dir(path: str, transpose: bool = True, dense: bool = False):
    """Load a CellRanger-style directory (matrix.mtx[.gz], features/genes.tsv,
    barcodes.tsv). Returns (Y cells-by-genes, gene_ids, barcodes).

    ``Y`` is a scipy CSR matrix by default (the fit path's ingestion is
    nnz-bound — scRNA counts are >90% zeros, so densifying here would
    multiply host memory ~20x); pass ``dense=True`` for a float64 ndarray."""

    def find(*names):
        for nm in names:
            for suffix in ("", ".gz"):
                p = os.path.join(path, nm + suffix)
                if os.path.exists(p):
                    return p
        return None

    mtx = find("matrix.mtx")
    if mtx is None:
        raise FileNotFoundError(f"no matrix.mtx[.gz] in {path}")
    if dense:
        Y = read_mtx(mtx, dense=True, transpose=transpose)  # genes-major on disk
    else:
        Y = read_mtx(mtx, dense=False, transpose=transpose).tocsr()

    def read_tsv_col(p, col=0):
        if p is None:
            return None
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rt") as fh:
            return [line.rstrip("\n").split("\t")[col] for line in fh if line.strip()]

    genes = read_tsv_col(find("features.tsv", "genes.tsv"))
    barcodes = read_tsv_col(find("barcodes.tsv"))
    return Y, genes, barcodes


# ---------------------------------------------------------------------------
# Pure-Python fallback
# ---------------------------------------------------------------------------

def _py_open(path):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    return gzip.open(path, "rt") if magic == b"\x1f\x8b" else open(path, "rt")


def _py_read_header(path):
    with _py_open(path) as fh:
        banner = fh.readline()
        if not banner.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file")
        lower = banner.lower()
        if "coordinate" not in lower:
            raise ValueError("only coordinate (sparse) MatrixMarket supported")
        if "complex" in lower or "hermitian" in lower:
            # four-column complex entries would misalign the token stream
            raise ValueError("complex/hermitian MatrixMarket not supported")
        pattern = "pattern" in lower
        skew = "skew" in lower
        symmetric = "symmetric" in lower or skew
        for line in fh:
            if not line.startswith("%") and line.strip():
                rows, cols, nnz = (int(x) for x in line.split()[:3])
                if symmetric and rows != cols:
                    raise ValueError("symmetric matrix must be square")
                return rows, cols, nnz, pattern, symmetric, skew
        raise ValueError("malformed MatrixMarket file: no dimensions line")


def _py_read_mtx(path, dense=True, transpose=False):
    rows, cols, nnz, pattern, symmetric, skew = _py_read_header(path)
    # pattern files: 3-column dims line followed by 2-column entries would
    # make loadtxt raise on the ragged widths — read only the shared columns
    data = np.loadtxt(
        _py_open(path), skiprows=0, comments="%", ndmin=2,
        usecols=(0, 1) if pattern else None,
    )
    data = data[1:]  # drop dims line (first non-comment row)
    ri = data[:, 0].astype(np.int64) - 1
    ci = data[:, 1].astype(np.int64) - 1
    vv = data[:, 2] if not pattern and data.shape[1] > 2 else np.ones(len(ri))
    if symmetric:
        off = ri != ci
        mirror = -1.0 if skew else 1.0  # skew-symmetric mirrors with -v
        ri, ci, vv = (
            np.concatenate([ri, ci[off]]),
            np.concatenate([ci, ri[off]]),
            np.concatenate([vv, mirror * vv[off]]),
        )
    # lower bound too: a 1-based index of 0 (parsed to -1) would WRAP via
    # negative numpy indexing and silently scatter to the last row/column
    if (ri < 0).any() or (ci < 0).any() or (ri >= rows).any() or (ci >= cols).any():
        raise ValueError("entry index out of declared bounds")
    if transpose:
        ri, ci = ci, ri
        rows, cols = cols, rows
    if dense:
        out = np.zeros((rows, cols))
        np.add.at(out, (ri, ci), vv)
        return out
    return COOMatrix(ri, ci, vv, (rows, cols))

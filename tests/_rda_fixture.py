"""The reference package's three ``.rda`` datasets, rebuilt from the
committed ``data/*.npz`` as R's ``save()`` lays them out: gzip over an
"RDX2" header and an XDR serialization stream (format 2) of the pairlist
that maps each name to its object. Hand-encoded here (the package's writers
write neither S4 objects nor environments), in exactly the layout
``convert_reference_data`` walks:

* ``example_sce``: an S4 SingleCellExperiment. ``@assays`` is an S4 whose
  ``.xData`` slot is an environment (R5 reference object) holding
  ``.->data``, an S4 SimpleList whose ``listData`` is a named list with the
  (genes x cells) integer ``counts`` matrix; ``@rowRanges`` holds the clone
  copy numbers as the named columns of ``@elementMetadata@listData`` and the
  gene names as ``@partitioning@NAMES``; ``@colData@rownames`` the cells.
* ``df_cnv``: a data.frame (a named list with class and compact row names).
* ``example_clonealign_fit``: the v1-era fit, a named list with ``clone``,
  ``retained_genes``, ``log_lik`` and ``ml_params`` (a named list holding
  the (cells x clones) ``clone_probs`` matrix, ``mu``, ``s``, ``alpha`` and a
  slot the conversion drops).

Format: R Internals, "Serialization Formats"; every integer big-endian.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

NILVALUE, SYM, LIST, ENV, CHAR, INT, REAL, STR, VEC, S4 = 254, 1, 2, 4, 9, 13, 14, 16, 19, 25
IS_OBJ, HAS_ATTR, HAS_TAG = 1 << 8, 1 << 9, 1 << 10
ASCII = 1 << 6 << 12  # CHARSXP's ASCII bit in the flags' gp field
R_NA_INT = -2**31


def _i4(v: int) -> bytes:
    return struct.pack(">i", v)


def _flags(ptype: int, obj=False, attrs=False, tag=False) -> bytes:
    return _i4(ptype | (IS_OBJ if obj else 0) | (HAS_ATTR if attrs else 0) | (HAS_TAG if tag else 0))


def _char(s: str) -> bytes:
    b = s.encode()
    return _i4(CHAR | ASCII) + _i4(len(b)) + b


def _sym(name: str) -> bytes:
    return _flags(SYM) + _char(name)


def _pairlist(items: dict) -> bytes:
    """A tagged pairlist (attributes, an environment's frame, the .rda's
    top level), NILVALUE-terminated."""
    out = b"".join(_flags(LIST, tag=True) + _sym(k) + v for k, v in items.items())
    return out + _i4(NILVALUE)


def _with(ptype: int, body: bytes, attrs: dict | None, obj=False) -> bytes:
    return _flags(ptype, obj=obj, attrs=bool(attrs)) + body + (_pairlist(attrs) if attrs else b"")


def strsxp(values, attrs=None) -> bytes:
    return _with(STR, _i4(len(values)) + b"".join(_char(str(v)) for v in values), attrs)


def intsxp(values, attrs=None) -> bytes:
    a = np.asarray(values, ">i4")
    return _with(INT, _i4(a.size) + a.tobytes(), attrs)


def realsxp(values, attrs=None) -> bytes:
    a = np.asarray(values, ">f8")
    return _with(REAL, _i4(a.size) + a.tobytes(), attrs)


def vecsxp(items, attrs=None, obj=False) -> bytes:
    return _with(VEC, _i4(len(items)) + b"".join(items), attrs, obj)


def s4(slots: dict, cls: str, package: str) -> bytes:
    """An S4 object: its slots as attributes, then its class (with the
    package attribute R writes)."""
    slots = dict(slots, **{"class": strsxp([cls], {"package": strsxp([package])})})
    return _flags(S4, obj=True, attrs=True) + _pairlist(slots)


def envsxp(frame: dict, attrs: dict | None = None) -> bytes:
    """An (unlocked) environment: its enclosure (the global environment, an
    empty one here), its frame as a pairlist, no hash table, attributes."""
    return (_flags(ENV) + _i4(0) + _i4(253) + _pairlist(frame) + _i4(NILVALUE)
            + (_pairlist(attrs) if attrs else _i4(NILVALUE)))


def matrix(a: np.ndarray) -> bytes:
    """A matrix in R's column-major order, with its dim attribute."""
    dim = intsxp(a.shape)
    body = np.asarray(a).ravel(order="F")
    return (intsxp if a.dtype.kind in "iu" else realsxp)(body, {"dim": dim})


def rda(name: str, obj: bytes) -> bytes:
    """``save(name, file=)``'s bytes: gzip of the RDX2 header, the XDR
    stream's header (format 2, written by R 3.6.2, readable from 2.3.0) and
    the top-level pairlist."""
    return gzip.compress(b"RDX2\nX\n" + _i4(2) + _i4(0x030602) + _i4(0x020300)
                         + _pairlist({name: obj}))


def example_sce(z) -> bytes:
    counts = np.asarray(z["counts"]).T  # (genes, cells)
    L = np.asarray(z["copy_number"])
    simple_list = s4({"listData": vecsxp([matrix(counts.astype(np.int32))],
                                         {"names": strsxp(["counts"])}),
                      "elementType": strsxp(["ANY"])}, "SimpleList", "S4Vectors")
    assays = s4({".xData": envsxp({".->data": simple_list})}, "SimpleAssays",
                "SummarizedExperiment")
    element_meta = s4({"listData": vecsxp([realsxp(L[:, c]) for c in range(L.shape[1])],
                                          {"names": strsxp(list(z["clone_names"]))}),
                       "nrows": intsxp([L.shape[0]])}, "DataFrame", "S4Vectors")
    partitioning = s4({"NAMES": strsxp(list(z["gene_names"])),
                       "end": intsxp(np.arange(1, L.shape[0] + 1))},
                      "PartitioningByEnd", "IRanges")
    row_ranges = s4({"elementMetadata": element_meta, "partitioning": partitioning},
                    "CompressedGRangesList", "GenomicRanges")
    col_data = s4({"rownames": strsxp(list(z["cell_names"])),
                   "nrows": intsxp([counts.shape[1]])}, "DataFrame", "S4Vectors")
    return s4({"assays": assays, "rowRanges": row_ranges, "colData": col_data},
              "SingleCellExperiment", "SingleCellExperiment")


def data_frame(z) -> bytes:
    names = list(z.files)
    cols = [strsxp(list(z[k])) if z[k].dtype.kind == "U" else realsxp(z[k]) for k in names]
    n = len(z[names[0]])
    return vecsxp(cols, {"names": strsxp(names), "class": strsxp(["data.frame"]),
                         "row.names": intsxp([R_NA_INT, -n])}, obj=True)


def clonealign_fit(z) -> bytes:
    ml = vecsxp([matrix(np.asarray(z["clone_probs"])), realsxp(z["mu"]), realsxp(z["s"]),
                 realsxp(z["alpha"]), realsxp(np.zeros(3))],
                {"names": strsxp(["clone_probs", "mu", "s", "alpha", "phi"])})
    return vecsxp([strsxp(list(z["clone"])), ml, realsxp(z["log_lik"]),
                   strsxp(list(z["retained_genes"]))],
                  {"names": strsxp(["clone", "ml_params", "log_lik", "retained_genes"])})


def write_reference_data(data_dir: str, out_dir: str) -> None:
    """Write ``example_sce.rda``, ``df_cnv.rda`` and
    ``example_clonealign_fit.rda`` to out_dir from data_dir's ``.npz``."""
    os.makedirs(out_dir, exist_ok=True)
    for name, build in (("example_sce", example_sce), ("df_cnv", data_frame),
                        ("example_clonealign_fit", clonealign_fit)):
        with np.load(os.path.join(data_dir, f"{name}.npz")) as z:
            payload = rda(name, build(z))
        with open(os.path.join(out_dir, f"{name}.rda"), "wb") as fh:
            fh.write(payload)

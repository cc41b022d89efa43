"""clonealign_torch.io.rds and ClonealignFit.save_rds / load_rds against the
JAX package's: the same objects serialize to identical bytes, each reader
reads the other's files to equal objects, a fit carried across with
``convert.fit_from_numpy`` saves to identical decompressed ``.rds`` bytes
(gzip's header carries a timestamp, so the streams are compared after
``gzip.decompress``), and both packages load the same ``.rds`` / ``.rda``
files to equal fits. Every comparison is exact."""

import bz2
import gzip
import struct

import numpy as np
import pytest

from clonealign_torch import convert
from clonealign_torch.fit import ClonealignFit as TFit
from clonealign_torch.io import datasets as tds
from clonealign_torch.io import rds as tr
from clonealign_tpu.fit import ClonealignFit as JFit
from clonealign_tpu.fit import ConvergenceInfo as JConv
from clonealign_tpu.io import datasets as jds
from clonealign_tpu.io import rds as jr

# Each kind builds its object from the module given (the two packages'
# RObj and RSymbol are different classes): the kinds the JAX package's
# tests/test_rds_writer.py writes.
KINDS = {
    "null": lambda m: None,
    "double_na_inf": lambda m: np.array([1.5, -2.25, np.nan, np.inf]),
    "matrix": lambda m: np.arange(12, dtype=np.float64).reshape(3, 4),
    "int": lambda m: np.array([1, -7, 2**31 - 1], dtype=np.int64),
    "int_out_of_range": lambda m: np.array([0, 2**31], dtype=np.int64),
    "int_na_collision": lambda m: np.array([-(2**31)], dtype=np.int64),
    "uint64_past_int64": lambda m: np.array([2**63 + 2048, 3], dtype=np.uint64),
    "bool": lambda m: np.array([True, False, True]),
    "logical_na": lambda m: np.array([True, None, False], dtype=object),
    "strings_na_utf8": lambda m: ["alpha", None, "naïve-β"],
    "empty_strings": lambda m: np.asarray([], dtype=np.str_),
    "string_matrix": lambda m: np.array([["a", "b"], ["c", "d"]]),
    "scalar_double": lambda m: 3.5,
    "scalar_int": lambda m: 7,
    "scalar_str": lambda m: "x",
    "scalar_bool": lambda m: True,
    "complex": lambda m: np.array([1 + 2j, -3.5j]),
    "named_list_nested": lambda m: {"a": np.array([1.0, 2.0]), "b": ["x", "y"],
                                    "nested": {"c": 5}},
    "unnamed_list": lambda m: [np.array([1.0]), None, "s"],
    "class_dimnames": lambda m: m.RObj(
        np.eye(2), {"class": ["mymat"], "dimnames": m.RObj([None, ["c1", "c2"]])}),
    "named_int": lambda m: m.RObj(np.asarray([4, 3], np.int32), {"names": ["A", "B"]}),
    "symbol": lambda m: m.RSymbol("shared"),
    # the same tag symbols again and again, at several depths
    "repeated_names": lambda m: {"names": {"names": [1.5, {"names": "x"}]},
                                 "dim": m.RObj([1, 2], {"names": ["dim", "names"]})},
}


def canon(x):
    """A comparable form of a parsed R object, the same for both packages'
    classes; arrays by dtype, shape and bytes (NaN equal to NaN)."""
    if isinstance(x, (tr.RObj, jr.RObj)):
        return ("RObj", canon(x.value), canon(x.attributes))
    if isinstance(x, (tr.RSymbol, jr.RSymbol)):
        return ("RSymbol", x.name)
    if isinstance(x, np.ndarray):
        if x.dtype == object:
            return ("object", x.shape, tuple(canon(v) for v in x.ravel()))
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return ("dict", tuple((k, canon(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(canon(v) for v in x))
    return (type(x).__name__, x)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_r_serialize_bytes_identical(kind):
    assert tr.r_serialize(KINDS[kind](tr)) == jr.r_serialize(KINDS[kind](jr))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_readers_read_each_others_streams(kind):
    for data in (tr.r_serialize(KINDS[kind](tr)), jr.r_serialize(KINDS[kind](jr))):
        assert canon(tr.parse_r_serialized(data)) == canon(jr.parse_r_serialized(data))


def test_unsupported_type_raises_alike():
    for m in (tr, jr):
        with pytest.raises(TypeError, match="cannot serialize object to RDS"):
            m.r_serialize({"bad": object()})
    with pytest.raises(ValueError, match="only XDR format supported"):
        tr.parse_r_serialized(b"A\n" + b"\x00" * 12)


@pytest.mark.parametrize("compress", ["gzip", "bzip2", "xz", "none"])
def test_write_rds_files_cross_read(tmp_path, compress):
    obj = {"v": np.array([1.0, 2.0]), "s": ["a", None], "m": np.arange(6).reshape(2, 3)}
    tp, jp = str(tmp_path / "t.rds"), str(tmp_path / "j.rds")
    tr.write_rds(obj, tp, compress=compress)
    jr.write_rds(obj, jp, compress=compress)
    raw = [open(p, "rb").read() for p in (tp, jp)]
    if compress == "gzip":
        raw = [gzip.decompress(b) for b in raw]
        assert open(tp, "rb").read(2) == b"\x1f\x8b"
    assert raw[0] == raw[1]
    for p in (tp, jp):
        assert canon(tr.read_rds(p)) == canon(jr.read_rds(p))
    for m in (tr, jr):
        with pytest.raises(ValueError, match="unknown compress='zip'"):
            m.write_rds(obj, tp, compress="zip")


class _Stream:
    """A hand-encoded R serialization v2 stream, as R writes it (the JAX
    package's tests/test_rds_roundtrip.py encoder): symbols written once and
    then referred to by REFSXP, which the writer never emits."""

    def __init__(self):
        self.buf = bytearray(b"X\n")
        for v in (2, 0x030500, 0x020300):
            self.i4(v)

    def i4(self, v):
        self.buf += struct.pack(">i", v)

    def charsxp(self, s):
        self.i4(9)
        self.i4(len(s.encode()))
        self.buf += s.encode()


def _symbol_reuse_stream():
    w = _Stream()
    w.i4(19)  # VECSXP of 2 pairlists sharing the tag symbol
    w.i4(2)
    for k in range(2):
        w.i4(2 | 0x400)
        if k == 0:
            w.i4(1)
            w.charsxp("shared")
        else:
            w.i4((1 << 8) | 255)  # REFSXP, reference 1
        w.i4(13)
        w.i4(1)
        w.i4(k)
        w.i4(254)
    return bytes(w.buf)


def _int_with_names_stream():
    w = _Stream()
    w.i4(13 | 0x200)
    w.i4(3)
    for v in (7, 8, 9):
        w.i4(v)
    w.i4(2 | 0x400)
    w.i4(1)
    w.charsxp("names")
    w.i4(16)
    w.i4(3)
    for s in "abc":
        w.charsxp(s)
    w.i4(254)
    return bytes(w.buf)


@pytest.mark.parametrize("stream", [_symbol_reuse_stream, _int_with_names_stream])
def test_readers_agree_on_r_written_streams(tmp_path, stream):
    data = stream()
    assert canon(tr.parse_r_serialized(data)) == canon(jr.parse_r_serialized(data))
    p = str(tmp_path / "r.rds")
    with gzip.open(p, "wb") as fh:  # R's saveRDS default
        fh.write(data)
    assert canon(tr.read_rds(p)) == canon(jr.read_rds(p))
    if stream is _symbol_reuse_stream:
        d0, d1 = tr.parse_r_serialized(data).value
        assert list(d0) == list(d1) == ["shared"]


def _jax_fit(seed, multirun, snv):
    """A JAX package fit with every slot filled from a numpy seed (float32
    parameters, as its fits hold them)."""
    rng = np.random.default_rng(seed)
    N, G, C, K = 9, 7, 3, 1
    names = ["A", "B", "C"]
    probs = rng.dirichlet(np.ones(C), size=N).astype(np.float32)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    clone = [names[i] if p > 0.5 else "unassigned" for i, p in
             zip(probs.argmax(1), probs.max(1))]
    mr = None
    if multirun:
        mr = {"elbos": rng.normal(-100, 5, 4),
              "clone_prevalences_at_different_shrinks": [{"A": 4, "B": 5}, {"C": 9},
                                                         {"A": 3, "unassigned": 6}, {}],
              "median_correlations": rng.uniform(0, 1, 4),
              "initial_shrinks": np.asarray([0.0, 5, 10, 5]),
              "best_run": 2}
    return JFit(
        clone=clone,
        ml_params={"clone_probs": probs, "mu": f32(G), "s": f32(N), "alpha": f32(C),
                   "psi": f32(N, K), "W": f32(G, K), "chi": f32(K)},
        convergence_info=JConv(final_elbo=float(rng.normal(-100, 5)), sd_final_elbo=0.25,
                               elbo=rng.normal(-100, 5, 12), n_iters=11),
        retained_genes=[f"gene_{i}" for i in range(G)],
        correlations=rng.uniform(-1, 1, G),
        clone_names=names,
        clone_probs_from_snv=rng.dirichlet(np.ones(C), size=N) if snv else None,
        multirun_info=mr,
    )


FITS = {"plain": (0, False, False), "multirun": (1, True, False), "snv": (2, False, True),
        "multirun+snv": (3, True, True)}


def assert_fits_equal(a, b):
    """Field by field, exactly (arrays by dtype and value, NaN equal)."""
    assert (a.clone, a.clone_names, a.retained_genes) == (b.clone, b.clone_names,
                                                          b.retained_genes)
    assert sorted(a.ml_params) == sorted(b.ml_params)
    for k in a.ml_params:
        assert a.ml_params[k].dtype == b.ml_params[k].dtype, k
        np.testing.assert_array_equal(a.ml_params[k], b.ml_params[k], err_msg=k)
    ca, cb = a.convergence_info, b.convergence_info
    np.testing.assert_array_equal([ca.final_elbo, ca.sd_final_elbo, ca.n_iters],
                                  [cb.final_elbo, cb.sd_final_elbo, cb.n_iters])
    np.testing.assert_array_equal(ca.elbo, cb.elbo)
    np.testing.assert_array_equal(a.correlations, b.correlations)
    assert (a.clone_probs_from_snv is None) == (b.clone_probs_from_snv is None)
    if a.clone_probs_from_snv is not None:
        np.testing.assert_array_equal(a.clone_probs_from_snv, b.clone_probs_from_snv)
    assert (a.multirun_info is None) == (b.multirun_info is None)
    if a.multirun_info is not None:
        assert sorted(a.multirun_info) == sorted(b.multirun_info)
        for k, v in a.multirun_info.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, b.multirun_info[k], err_msg=k)
            else:
                assert v == b.multirun_info[k], k


@pytest.mark.parametrize("name", sorted(FITS))
def test_save_rds_bytes_identical_and_cross_load(tmp_path, name):
    jfit = _jax_fit(*FITS[name])
    tfit = convert.fit_from_numpy(jfit)
    tp, jp = str(tmp_path / "t.rds"), str(tmp_path / "j.rds")
    tfit.save_rds(tp)
    jfit.save_rds(jp)
    assert gzip.decompress(open(tp, "rb").read()) == gzip.decompress(open(jp, "rb").read())
    for p in (tp, jp):
        assert_fits_equal(TFit.load_rds(p), JFit.load_rds(p))
    # the round trip keeps the fit, float32 parameters as R's doubles
    back = TFit.load_rds(tp)
    assert back.clone == tfit.clone and repr(back) == repr(tfit)
    for k, v in tfit.ml_params.items():
        np.testing.assert_array_equal(back.ml_params[k], v.astype(np.float64), err_msg=k)


def test_load_rds_r_native_layout(tmp_path):
    """A fit as the R package saves it: no n_iters slot, a 1-based best_run,
    clone names only in clone_probs's dimnames."""
    rng = np.random.default_rng(4)
    N, G = 7, 5
    gamma = rng.dirichlet(np.ones(3), size=N)

    def r_fit(m):
        return m.RObj({
            "clone": np.asarray([["A", "B", "C"][i] for i in gamma.argmax(1)], np.str_),
            "ml_params": {
                "clone_probs": m.RObj(gamma, {"dimnames": m.RObj([None, ["A", "B", "C"]])}),
                "mu": rng.uniform(0.5, 2.0, G), "s": rng.uniform(100, 200, N),
                "alpha": np.asarray([0.3, 0.3, 0.4]), "psi": rng.normal(size=(N, 1)),
                "W": rng.normal(size=(G, 1)), "chi": np.asarray([1.0])},
            "convergence_info": {"final_elbo": -90.0, "sd_final_elbo": 0.25,
                                 "elbo": np.linspace(-100.0, -90.0, 13)},
            "retained_genes": np.asarray([f"g{i}" for i in range(G)], np.str_),
            "correlations": rng.uniform(-1, 1, G),
            "clone_probs_from_snv": None,
            "multirun_info": {
                "elbos": np.asarray([-95.0, -90.0]),
                "clone_prevalences_at_different_shrinks": [
                    m.RObj(np.asarray([4, 3], np.int32), {"names": ["A", "B"]}),
                    m.RObj(np.asarray([7], np.int32), {"names": ["C"]})],
                "median_correlations": np.asarray([0.1, 0.2]),
                "initial_shrinks": np.asarray([0.0, 5.0]), "best_run": 2},
        }, {"class": ["clonealign_fit"]})

    p = str(tmp_path / "rfit.rds")
    jr.write_rds(r_fit(jr), p)
    tfit, jfit = TFit.load_rds(p), JFit.load_rds(p)
    assert_fits_equal(tfit, jfit)
    assert tfit.convergence_info.n_iters == 12 and tfit.multirun_info["best_run"] == 1


def _rda(objs):
    """An .rda workspace of the named objects, bzip2-compressed as R saves
    it: the RDX2 magic, then a pairlist (tag symbol -> object)."""
    out = b"RDX2\n" + tr.r_serialize(None)[:14]
    for name, obj_bytes in objs.items():
        out += struct.pack(">iiii", 2 | 0x400, 1, 9, len(name)) + name.encode()
        out += obj_bytes[14:]  # the object after r_serialize's header
    return bz2.compress(out + struct.pack(">i", 254))


def _v1_fit(m):
    """The v1-era layout of the R package's bundled example fit, built from
    data/example_clonealign_fit.npz: clone, ml_params (with phi), log_lik,
    retained_genes, basis_means."""
    raw = jds.load_example_fit()
    probs = raw["clone_probs"]
    rng = np.random.default_rng(6)
    return m.RObj({
        "clone": raw["clone"],
        "ml_params": {"clone_probs": m.RObj(probs, {"dimnames": m.RObj([None, ["A", "B", "C"]])}),
                      "mu": raw["mu"], "s": raw["s"], "alpha": raw["alpha"],
                      "phi": rng.uniform(1, 5, (len(probs), 3, len(raw["mu"])))},
        "log_lik": raw["log_lik"],
        "retained_genes": raw["retained_genes"],
        "basis_means": rng.uniform(0, 10, 20),
    })


def test_load_rds_v1_layout_rds_and_rda(tmp_path):
    rds, rda = str(tmp_path / "v1.rds"), str(tmp_path / "ws.rda")
    tr.write_rds(_v1_fit(tr), rds)
    with open(rda, "wb") as fh:
        fh.write(_rda({"example_clonealign_fit": tr.r_serialize(_v1_fit(tr))}))
    for p in (rds, rda):
        tfit, jfit = TFit.load_rds(p), JFit.load_rds(p)
        assert_fits_equal(tfit, jfit)
        assert tfit.clone_names == ["A", "B", "C"]
        assert tfit.ml_params["phi"].shape == (200, 3, 100)
        assert tfit.ml_params["basis_means"].shape == (20,)
        assert tfit.convergence_info.n_iters == len(jds.load_example_fit()["log_lik"]) - 1
    assert canon(tr.read_rda(rda)) == canon(jr.read_rda(rda))


def test_load_rds_refusals_alike(tmp_path):
    cases = {
        "notfit.rds": lambda m: m.RObj({"clone": ["A"]}, {"class": ["lm"]}),
        "nolayout.rds": lambda m: {"clone": ["A"], "ml_params": {"mu": np.ones(2)},
                                   "retained_genes": ["g"]},
        "unnamed.rds": lambda m: [1.0, 2.0],
    }
    for fname, obj in cases.items():
        p = str(tmp_path / fname)
        tr.write_rds(obj(tr), p)
        with pytest.raises(ValueError) as te:
            TFit.load_rds(p)
        with pytest.raises(ValueError) as je:
            JFit.load_rds(p)
        assert str(te.value) == str(je.value)
    two = str(tmp_path / "two.rda")  # a workspace of two objects, neither a fit
    with open(two, "wb") as fh:
        fh.write(_rda({"a": tr.r_serialize(1.0), "b": tr.r_serialize("x")}))
    with pytest.raises(ValueError, match="expected exactly one clonealign_fit") as te:
        TFit.load_rds(two)
    with pytest.raises(ValueError) as je:
        JFit.load_rds(two)
    assert str(te.value) == str(je.value)


def test_example_clonealign_fit_loads_alike():
    assert_fits_equal(tds.load_example_clonealign_fit(), jds.load_example_clonealign_fit())

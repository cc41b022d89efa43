"""Accuracy and card time of variants of the gene-major backward kernel.

    python3 gene_variants.py [VARIANT ...]

Each variant is ``clonealign_torch/ops/csrc/fused_likelihood.cu`` with one
or two lines replaced (see ``VARIANTS``), built with the package's nvcc
flags into ``build/gene_variants/`` (all builds run at once) and called
through ``fl_backward_gene``. ``adopted`` is the source as it stands. For
each shape of the ``cuda`` tests it prints the largest error of dW,
dlog mu and d(muL) in units of the tests' tolerance (|err| / (1e-4 + 3e-5
|want|)), against the float64 plain version, first for the float32 plain
versions (``reference_likelihood_vjp``, then ``reference_gene``) and then
for each variant; a value above 1 fails. Then, at the full width of the fit
(100,000 x 5,000, S*C = 10, Kf = 1, A2 off), with Y stored as float32 and
as int8, each variant's time in turns, twice, as ``chip_smoke.cuda_ms``
measures it (packing, kernel and reduction). Needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

from chip_smoke import FULL, cuda_ms, kernel_inputs, kernel_resources
from clonealign_torch.ops import _build
from clonealign_torch.ops import fused_likelihood as fl

# The test module by path: an installed package may also be named "tests".
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from test_torch_fused_likelihood import CUDA_SHAPES, _cotangents, _inputs  # noqa: E402

SPLIT = "split_tf32_int(__expf(lr[e]), a_hi[e], a_lo[e]);"
SUM = ("            const float s = acc_hi[t][e] + x[t][e];\n"
       "            acc_lo[t][e] += x[t][e] - (s - acc_hi[t][e]);\n"
       "            acc_hi[t][e] = s;\n")
VARIANTS = {
    "adopted": [],
    # the A operand split with two cvt.rna (split_tf32), as the forward and dpsi do
    "cvt_split": [(SPLIT, "split_tf32(__expf(lr[e]), a_hi[e], a_lo[e]);")],
    # hi by truncation (a mask), lo = x - hi rounded by one cvt.rna
    "mask_split": [(SPLIT, "{ const float v = __expf(lr[e]); a_hi[e] = __float_as_uint(v) & 0xffffe000u; "
                           "a_lo[e] = to_tf32(v - __uint_as_float(a_hi[e])); }")],
    # a plain float32 running sum in place of the hi + lo pairs
    "f32_sum": [(SUM, "            acc_hi[t][e] += x[t][e];\n")],
    # the Y terms' loop over the tile's rows unrolled by two everywhere
    "y_unroll_2": [("#pragma unroll kYUnroll", "#pragma unroll 2")],
}
OUT = os.path.join("build", "gene_variants")


def build(names):
    src = open(_build.SOURCES[0]).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", os.path.join(OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        res = kernel_resources(log, "gene_kernel")
        spilled = sorted(k for k, (_, st, ld) in res.items() if st or ld)
        print(f"{name}: gene_kernel registers " + " ".join(
            f"{k}{r}" for k, (r, _, _) in sorted(res.items())) + f"; spilling {spilled}", flush=True)
        lib = ctypes.CDLL(os.path.abspath(os.path.join(OUT, f"{name}.so")))
        lib.fl_backward_gene.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.fl_backward_gene_scratch.argtypes = [ctypes.c_int] * 6
        lib.fl_backward_gene_scratch.restype = ctypes.c_size_t
        libs[name] = lib
    return libs


def gene(lib, Y, psi, W, muL, dA1, dA2, dZ):
    """kernel_gene's launch, through ``lib``."""
    (N, G), Kf, SC = Y.shape, psi.shape[1], muL.shape[1]
    n_a2 = 0 if dA2 is None else dA2.shape[1]
    rows = -(-max(fl._ROWS_PER_CHUNK, -(-N // 65535)) // 64) * 64
    scratch = torch.empty(lib.fl_backward_gene_scratch(N, G, Kf, n_a2, SC, rows), device="cuda")
    dgene = torch.empty(Kf + SC + n_a2, G, device="cuda")
    ptr = [None if t is None else ctypes.c_void_p(t.data_ptr())
           for t in (Y, psi, W, muL, dA1, dA2, dZ, scratch, dgene)]
    err = lib.fl_backward_gene(*ptr, N, G, Kf, n_a2, SC, rows, fl.Y_DTYPES[Y.dtype],
                               ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err:
        raise RuntimeError(f"fl_backward_gene failed with CUDA error {err}")
    return dgene[:Kf].T, None if dA2 is None else dgene[Kf + SC:], dgene[Kf:Kf + SC].T


def tol_units(got, want):
    """Largest |got - want| / (atol + rtol |want|) over dW, dlog mu, d(muL)."""
    worst = 0.0
    for g, w in zip(got, want):
        if w is not None and w.numel():
            err = (g.double() - w).abs() / (1e-4 + 3e-5 * w.abs())
            worst = max(worst, float(err.max()))
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("gene_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = build(sys.argv[1:] or list(VARIANTS))
    print("error in tolerance units against float64: shape | plain32 reference_gene32 | "
          + " ".join(libs), flush=True)
    for shape in CUDA_SHAPES:
        N, G, C, K, S = shape
        Y, psi, W, _log_mu, muL = [torch.from_numpy(a).cuda() for a in _inputs(N, G, C, K, S, seed=N)]
        dA1, dA2, dZ = [torch.from_numpy(a).cuda() for a in _cotangents(N, S, S * C, seed=N)]
        args = (Y, psi, W, muL, dA1, dA2, dZ)
        exact = fl.reference_likelihood_vjp(*[t.double() for t in args])[1:]
        row = [tol_units(fl.reference_likelihood_vjp(*args)[1:], exact),
               tol_units(fl.reference_gene(*args), exact)]
        row += [tol_units(gene(lib, *args), exact) for lib in libs.values()]
        print(f"{str(shape):22s} | " + " ".join(f"{v:.2f}" for v in row), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x = kernel_inputs(gen, FULL["N"], FULL["G"], FULL["C"], S=1, Kf=1, device="cuda")
    for storage in (torch.float32, torch.int8):
        args = (x["Y"].to(storage), x["psi"], x["W"], x["muL"], x["dA1"], None, x["dZ"])
        for _ in range(2):
            print(f"full width, Y {storage}, ms: " + " ".join(
                f"{name} {cuda_ms(lambda lib=lib: gene(lib, *args), reps=10):.4f}"
                for name, lib in libs.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

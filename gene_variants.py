"""Card time of variants of the CUDA kernels, for reading what sets their
time, and the accuracy of the gene-major backward's variants.

    python3 gene_variants.py [VARIANT ...]

Each variant is ``clonealign_torch/ops/csrc/fused_likelihood.cu`` with one
or two lines replaced (``VARIANTS``: the kernel it is about and its
replacements), built with the package's nvcc flags into
``build/gene_variants/`` (every variant at once) and called through the
package's wrappers with the variant's library in place of the package's.
``adopted`` is the source as it stands, and is in every comparison.

* ``gene``, the narrow gene-major backward (``kernel_gene`` at Kf <= 4,
  S*C <= 32): for each shape of the ``cuda`` tests the largest error of
  dW, dlog mu and d(muL) in units of the tests' tolerance (|err| / (1e-4 +
  3e-5 |want|)) against the float64 plain version, first for the float32
  plain versions (``reference_likelihood_vjp``, then ``reference_gene``) and
  then for each variant (a value above 1 fails); then, at the full width of
  the fit (100,000 x 5,000, S*C = 10, Kf = 1, A2 off), with Y stored as
  float32 and as int8, each variant's time in turns, twice.
* ``fwd_wide``, ``dpsi_wide`` and ``gene_wide``, the wide forward
  (``kernel_forward``), dpsi (``kernel_dpsi``) and gene part
  (``kernel_gene``) past a narrow limit: each variant but ``gene_rolled``
  and ``dpsi_pairs`` takes one piece of work out, so its results are
  wrong by design, and ``adopted``'s time less the variant's is what that
  work costs, an upper bound on what any other way of doing it could save
  (so ``fwd_no_logrfe`` bounds what forming log_rfe on the CUDA cores
  instead of by MMA could gain, ``gene_no_dw`` what dW by CUDA-core FMAs
  could gain). Timed at the full width of the fit with Y int8, A2 off,
  C = 10 and (Kf, S) each of ``WIDE_CONFIGS``, in turns, twice.

* ``fwd_f64``, ``dpsi_f64`` and ``gene_f64``, the float64 family's
  forward, dpsi and gene part
  (``clonealign_torch/ops/csrc/fused_likelihood_f64.cu``, the variant's
  source in its place): ``f64_*_no_exp`` takes the double exp() out (rfe =
  log_rfe), ``f64_*_no_mma`` the products on the FP64 tensor cores (the
  forward's tiles; the gene part's d(muL), dlog mu and dW), ``f64_*_one_a``
  issues each tile's MMA with one A operand where the kernels choose
  between two by a predicate (Y's or rfe's), ``f64_gene_no_drfe`` and
  ``f64_dpsi_no_drfe`` take drfe's MMAs out (drfe = 0), and
  ``f64_dpsi_no_dmma`` dpsi's MMAs with W (t summed as it is). All are
  wrong by design and read as above. Timed at the full width of the fit
  with float64 operands, Y int8, A2 off, C = 10 and (Kf, S) each of
  ``F64_CONFIGS``, in turns, twice.

Times are ``chip_smoke.cuda_ms``'s (packing, kernels and reduction). Needs
an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

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
FWD_LOGRFE = "      mma_3xtf32(d, ph, pl, tab[(ks * RW + kc) * kWarp + lane]);\n"
GENE_LOGRFE = "          mma_3xtf32(d, wh, wl, pair_b(q[0], q[4]));\n"
GENE_DRFE = "            mma_3xtf32(d, mh, ml, pair_b(q[8 * jj], q[8 * jj + 4]));\n"
GENE_DMUL = "            mma_3xtf32(d, ah, al, pair_b(q_dz[8 * t], q_dz[sdz + 8 * t]));\n"
GENE_H2 = "#pragma unroll\n      for (int h2 = 0; h2 < kSteps2; ++h2) {\n"
GENE_DW = "              mma_3xtf32(d, ah, al, pair_b(q_ps[k8], q_ps[sps + k8]));\n"
DPSI_LOGRFE = "          mma_3xtf32(d, ph, pl, b[kc * kWarp]);\n"
DPSI_DRFE = "          mma_3xtf32(d, zh[t], zl[t], b[(NK + t) * kWarp]);\n"
DPSI_MMA = ("          mma_3xtf32(d, th, tl, b[(NK + NZ + kc) * kWarp]);\n"
            "          add4(sacc[kc], d);\n")
DPSI_EXP = "tv[e] = __expf(lr[e]) * dr[e];"
DPSI_KS = "#pragma unroll 1\n      for (int ks = 0; ks < p.dsteps; ++ks) {\n"
DPSI_BOUNDS = "__launch_bounds__(kDpsiWarps * kWarp, NK == 1 ? 3 : 2)"
F64_EXP_FWD = "#pragma unroll\n        for (int e = 0; e < 4; ++e) rf[e] = exp(lr[e]);\n"
F64_EXP_GENE = "          for (int e = 0; e < 4; ++e) rf[e] = exp(lr[e]);\n"
F64_FWD_PAIR = ("        if (c < ny)\n          dmma(acc[c], y, b);\n        else if (c < nt)\n"
                "          dmma(acc[c], rf, b);\n")
F64_GENE_PAIR = ("          if (c < ns)\n            dmma(acc[c], ya, b);\n          else if (c < nt)\n"
                 "            dmma(acc[c], ra, b);\n")
F64_GENE_DW = ("#pragma unroll\n"
               "          for (int kt = 0; kt < NK; ++kt) dmma(dw[kt], da, bk[(ct * NK + kt) * kWarp + lane]);\n")
F64_GENE_DRFE = "          if (c >= ns && c < nt) dmma(dr, amu[c], bt[(ct * NT + c) * kWarp + lane]);\n"
F64_DPSI_EXP = "tv[e] = exp(lr[e]) * dr[e];"
F64_DPSI_DRFE = "        for (int z = 0; z < NZ; ++z) dmma(dc[z % NC], az[z], b[z * kWarp + lane]);\n"
F64_DPSI_MMA = ("        for (int kc = 0; kc < NK; ++kc) dmma(acc[kc], ta, "
                "b[(NZ + kc) * kWarp + lane]);\n")
# name: (the kernel it is about, its replacements)
VARIANTS = {
    "adopted": (None, []),
    # the A operand split with two cvt.rna (split_tf32), as the forward and dpsi do
    "cvt_split": ("gene", [(SPLIT, "split_tf32(__expf(lr[e]), a_hi[e], a_lo[e]);")]),
    # hi by truncation (a mask), lo = x - hi rounded by one cvt.rna
    "mask_split": ("gene", [(SPLIT, "{ const float v = __expf(lr[e]); a_hi[e] = __float_as_uint(v) & 0xffffe000u; "
                                    "a_lo[e] = to_tf32(v - __uint_as_float(a_hi[e])); }")]),
    # a plain float32 running sum in place of the hi + lo pairs
    "f32_sum": ("gene", [(SUM, "            acc_hi[t][e] += x[t][e];\n")]),
    # the Y terms' loop over the tile's rows unrolled by two everywhere
    "y_unroll_2": ("gene", [("#pragma unroll kYUnroll", "#pragma unroll 2")]),
    # the wide forward without log_rfe = psi W^T (rfe = 1)
    "fwd_no_logrfe": ("fwd_wide", [(FWD_LOGRFE, "")]),
    # the wide gene part without log_rfe^T = W psi^T, drfe = muL dZ^T,
    # d(muL) = rfe^T dZ or dW = dlog_rfe^T psi
    "gene_no_logrfe": ("gene_wide", [(GENE_LOGRFE, "")]),
    "gene_no_drfe": ("gene_wide", [(GENE_DRFE, "")]),
    "gene_no_dmul": ("gene_wide", [(GENE_DMUL, "")]),
    "gene_no_dw": ("gene_wide", [(GENE_DW, "")]),
    # the wide gene part with its two k-steps a stage one after the other
    # (a correct variant: fewer registers, less overlap)
    "gene_rolled": ("gene_wide", [(GENE_H2, "#pragma unroll 1\n      for (int h2 = 0; h2 < kSteps2; ++h2) {\n")]),
    # the wide dpsi without log_rfe = psi W^T (rfe = 1: no exps either),
    # without the exps (t = log_rfe drfe), without drfe = dZ muL^T (t = 0),
    # or without dpsi's product with W (its split and MMAs: t summed as it is)
    "dpsi_no_logrfe": ("dpsi_wide", [(DPSI_LOGRFE, "")]),
    "dpsi_no_exp": ("dpsi_wide", [(DPSI_EXP, "tv[e] = lr[e] * dr[e];")]),
    "dpsi_no_drfe": ("dpsi_wide", [(DPSI_DRFE, "")]),
    "dpsi_no_dmma": ("dpsi_wide", [(DPSI_MMA, "          add4(sacc[kc], tv);\n")]),
    # the wide dpsi with two k-steps unrolled, so that one's chain of
    # products runs beside the other's, at two blocks an SM (a correct
    # variant: more registers, more overlap)
    "dpsi_pairs": ("dpsi_wide", [(DPSI_KS, "#pragma unroll 2\n      for (int ks = 0; ks < p.dsteps; ++ks) {\n"),
                                 (DPSI_BOUNDS, "__launch_bounds__(kDpsiWarps * kWarp, 2)")]),
    "f64_fwd_no_exp": ("fwd_f64", [(F64_EXP_FWD, F64_EXP_FWD.replace("exp(lr[e])", "lr[e]"))]),
    "f64_fwd_no_mma": ("fwd_f64", [(F64_FWD_PAIR, "")]),
    "f64_fwd_one_a": ("fwd_f64", [(F64_FWD_PAIR, "        dmma(acc[c], rf, b);\n")]),
    "f64_gene_no_exp": ("gene_f64", [(F64_EXP_GENE, F64_EXP_GENE.replace("exp(lr[e])", "lr[e]"))]),
    "f64_gene_no_mma": ("gene_f64", [(F64_GENE_PAIR, ""), (F64_GENE_DW, "")]),
    "f64_gene_one_a": ("gene_f64", [(F64_GENE_PAIR, "          dmma(acc[c], ra, b);\n")]),
    "f64_gene_no_drfe": ("gene_f64", [(F64_GENE_DRFE, "          ;\n")]),
    "f64_dpsi_no_exp": ("dpsi_f64", [(F64_DPSI_EXP, "tv[e] = lr[e] * dr[e];")]),
    "f64_dpsi_no_drfe": ("dpsi_f64", [(F64_DPSI_DRFE, "        ;\n")]),
    "f64_dpsi_no_dmma": ("dpsi_f64", [(F64_DPSI_MMA, "        for (int kc = 0; kc < NK; ++kc)\n"
                                                     "          for (int e = 0; e < 4; ++e) "
                                                     "acc[kc][e] += ta[e];\n")]),
}
KERNELS = {"gene": ("gene_kernel",), "fwd_wide": ("fwd_wide_kernel",),
           "dpsi_wide": ("dpsi_wide_kernel",), "gene_wide": ("gene_wide_kernel",),
           "fwd_f64": ("fwd_f64_kernel",), "dpsi_f64": ("dpsi_f64_kernel",),
           "gene_f64": ("gene_f64_kernel",)}
# the source each kernel's variants edit (_build.SOURCES' index)
SOURCE_OF = {"fwd_f64": 1, "dpsi_f64": 1, "gene_f64": 1}
# (Kf, S) of the wide and the float64 variants' timing, C = 10
WIDE_CONFIGS = ((5, 8), (64, 8), (5, 1))
F64_CONFIGS = ((1, 1), (1, 8))
OUT = os.path.join("build", "gene_variants")


def build(names):
    """Each variant's library (all built at once), its entry points declared
    as the package's; prints the registers and spills of the kernels each
    variant is about (``adopted``: all of them)."""
    os.makedirs(OUT, exist_ok=True)
    paths = {}
    for name in names:
        index = SOURCE_OF.get(VARIANTS[name][0], 0)
        text = open(_build.SOURCES[index]).read()
        for old, new in VARIANTS[name][1]:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        sources = [str(src) for src in _build.SOURCES]
        sources[index] = cu
        paths[name] = (sources, os.path.abspath(os.path.join(OUT, f"{name}.so")))
    with ThreadPoolExecutor(len(names)) as pool:
        # the variant's source beside the package's other source, so that the
        # library has every entry point the package declares
        logs = dict(zip(names, pool.map(
            lambda n: _build.compile_library(paths[n][0], paths[n][1]), names)))
    libs = {}
    for name in names:
        target = VARIANTS[name][0]
        for kernel in KERNELS[target] if target else sum(KERNELS.values(), ()):
            res = kernel_resources(logs[name], kernel)
            spilled = sorted(k for k, (_, st, ld) in res.items() if st or ld)
            print(f"{name}: {kernel} registers up to {max(r for r, _, _ in res.values())}, "
                  f"spilling {spilled}", flush=True)
        libs[name] = _build.declare(ctypes.CDLL(paths[name][1]))
    return libs


def through(lib, fn, *args):
    """``fn(*args)`` with the package's wrappers launching ``lib``'s kernels."""
    _build._lib = lib
    return fn(*args)


def tol_units(got, want):
    """Largest |got - want| / (atol + rtol |want|) over dW, dlog mu, d(muL)."""
    worst = 0.0
    for g, w in zip(got, want):
        if w is not None and w.numel():
            err = (g.double() - w).abs() / (1e-4 + 3e-5 * w.abs())
            worst = max(worst, float(err.max()))
    return worst


def in_turns(label, libs, fn, args, reps):
    for _ in range(2):
        print(f"{label} ms: " + " ".join(
            f"{name} {cuda_ms(lambda lib=lib: through(lib, fn, *args), reps=reps):.4f}"
            for name, lib in libs.items()), flush=True)


def gene_phase(libs):
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
        row += [tol_units(through(lib, fl.kernel_gene, *args), exact) for lib in libs.values()]
        print(f"{str(shape):22s} | " + " ".join(f"{v:.2f}" for v in row), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x = kernel_inputs(gen, FULL["N"], FULL["G"], FULL["C"], S=1, Kf=1, device="cuda")
    for storage in (torch.float32, torch.int8):
        args = (x["Y"].to(storage), x["psi"], x["W"], x["muL"], x["dA1"], None, x["dZ"])
        in_turns(f"full width, Y {storage}", libs, fl.kernel_gene, args, reps=10)


def wide_phase(fwd_libs, dpsi_libs, gene_libs):
    for Kf, S in WIDE_CONFIGS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        x = kernel_inputs(gen, FULL["N"], FULL["G"], FULL["C"], S=S, Kf=Kf, device="cuda")
        Y = x["Y"].to(torch.int8)
        label = f"int8 Kf={Kf} S*C={S * FULL['C']}"
        if fwd_libs:
            in_turns(f"{label} fwd", fwd_libs, fl.kernel_forward,
                     (Y, x["psi"], x["W"], None, x["muL"]), reps=5)
        if dpsi_libs:
            YW = x["Y"] @ x["W"]
            in_turns(f"{label} dpsi", dpsi_libs, fl.kernel_dpsi,
                     (x["psi"], x["W"], x["muL"], x["dA1"], x["dZ"], YW), reps=5)
            del YW
        if gene_libs:
            in_turns(f"{label} gene", gene_libs, fl.kernel_gene,
                     (Y, x["psi"], x["W"], x["muL"], x["dA1"], None, x["dZ"]), reps=5)
        del x, Y
        torch.cuda.empty_cache()


def f64_phase(fwd_libs, dpsi_libs, gene_libs):
    for Kf, S in F64_CONFIGS:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(4)
        x = {k: v.double() for k, v in kernel_inputs(gen, FULL["N"], FULL["G"], FULL["C"], S=S,
                                                     Kf=Kf, device="cuda").items()}
        Y = x["Y"].to(torch.int8)
        label = f"float64, int8 Kf={Kf} S*C={S * FULL['C']}"
        if fwd_libs:
            in_turns(f"{label} fwd", fwd_libs, fl.kernel_forward,
                     (Y, x["psi"], x["W"], None, x["muL"]), reps=5)
        if dpsi_libs:
            YW = x["Y"] @ x["W"]
            in_turns(f"{label} dpsi", dpsi_libs, fl.kernel_dpsi,
                     (x["psi"], x["W"], x["muL"], x["dA1"], x["dZ"], YW), reps=5)
            del YW
        if gene_libs:
            in_turns(f"{label} gene", gene_libs, fl.kernel_gene,
                     (Y, x["psi"], x["W"], x["muL"], x["dA1"], None, x["dZ"]), reps=5)
        del x, Y
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("gene_variants: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    names = list(dict.fromkeys(["adopted", *(sys.argv[1:] or VARIANTS)]))
    libs = build(names)
    about = {t: {n: lib for n, lib in libs.items() if VARIANTS[n][0] in (None, t)}
             for t in KERNELS}
    if len(about["gene"]) > 1 or not sys.argv[1:]:
        gene_phase(about["gene"])
    wide_phase(*(about[t] if len(about[t]) > 1 or not sys.argv[1:] else {}
                 for t in ("fwd_wide", "dpsi_wide", "gene_wide")))
    f64_phase(*(about[t] if len(about[t]) > 1 or not sys.argv[1:] else {}
                for t in ("fwd_f64", "dpsi_f64", "gene_f64")))
    return 0


if __name__ == "__main__":
    sys.exit(main())

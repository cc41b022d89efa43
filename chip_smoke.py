"""Smoke test of the PyTorch port (clonealign_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout and holds each
kernel against its plain PyTorch version on the card: for every Y storage
type the kernels load (float32, bfloat16, int16, int8) at a ragged shape
(scalar Y loads) and at one with G % 4 == 0 (vectorized loads), each at
Kf = 3 and 4 besides (the columns of [psi, X]: K latent factors and P
covariates), and at the golden oracle's rich shape (Kf = 4, S = 3, C = 3);
at a wide shape; and at the full width of the main path for float32, int16
and int8 (Kf = 1), and for int8 and float32 at Kf = 3 and 4, each timed
beside its bound. Then it drives the fit at full width —
100,000 cells x 5,000 genes x 10 clones, clone-structured counts made on the
card from a seed — through ``clonealign_torch.clonealign`` under the exact
likelihood with Y stored as float32 and as ``y_storage="auto"`` resolves,
and under "auto" with two covariate columns (K = 1, P = 2), in turns, each
with its launches counted from zero and its peak memory in the inference,
and, also in turns, under "auto" with allele data (1,000 variants around
the true clones, made with numpy by the golden oracle's recipe) and from the
same counts as a scipy CSR matrix (which must give the dense fit's labels
and final ELBO), each printing its setup seconds and setup peak besides;
then, under "auto" storage, the Chebyshev normalizer (z_cheb) and the exact
one in turns, printing each fit's ms per iteration; the full-width sweep of
ten restarts through ``run_clonealign`` three ways (exact in sequence,
exact as lanes of one batched loop, z_cheb as lanes), the lanes also with
float32 Y in turns, and once with the covariates and ``restart_batching=
"auto"``, each with its kernel launches counted from zero and checked
against its lanes' iterations; the kernels at the streaming fit's chunk
shapes (the full chunk and the ragged tail, Y the leading rows of the chunk
feeder's device buffer), then the streaming fit (``fit_streaming``, "auto"
storage and chunks, "reuse") in turns with the in-core fit on the same
data, seed and monitoring, which it must match (iterations, labels, final
ELBO bar) with the launches its chunks give and a peak below Y's bytes at
int8, beside what a chunk's upload costs and how much of each training
step's copy time runs beside the chunks' work (CUDA events); serving
(``assign_cells``) of the training cells against the in-core fit under
"ignore" and "refine", held to accuracy, agreement and, on cells spread
over every row block, to the CPU port's float64 log-posteriors; a small
sweep; the golden
oracle's allele data as a sweep of three restarts, "map" and "vmap" in
turns, which must run the same iterations and give the same labels; and the
four converged fits of the golden oracle (tests/golden/tpu_parity_oracle.npz:
example, synth, rich, allele), each held to that oracle's bar, and its synth
fit streamed in chunks of 1,024 cells, held to the same bar after the
kernels are checked at its chunk shapes; then the legacy v1
negative-binomial family (``inference_em``, one exact and one Chebyshev fit,
``gibbs_pi_rho`` and ``models.negbin.classify_cells``) at
``benchmarks/negbin_scale.py``'s width, 100,000 cells x 2,000 genes x 4
clones of model3 counts made on the card, each held to its accuracy bar,
serving's log-posteriors to the CPU port's in float64, and the JAX
package's golden pin in float32, with no fused-likelihood launch; and last
the command line (``clonealign_torch.__main__``) with its file formats: the
full-width ten-restart sweep from an uncompressed ``.npz`` of the same
counts and a CSV to an ``.rds`` in turns with the library sweep (labels,
best run, final ELBO bar, launches), the ``.rds`` read back against the
in-memory fit, ``assign`` from it against ``assign_cells``, a CellRanger
``.mtx.gz`` of 2,000 cells through ``fit`` and through the v1 family's
``fit`` and ``assign``, and ``info``, ``show`` and the imports in fresh
interpreters (no JAX module may load); and last the wide kernel family
(the kernels past the narrow ones' 4 columns of [psi, X], 4 samples and 32
sample x clone columns): each wide kernel against its plain version at
every Y storage at shapes crossing each limit alone and together and at a
streaming chunk shape, timed at full width beside its bound; the
full-width fit with K = 1, P = 4 covariates and mc_samples = 8 (Kf = 5,
S*C = 80), the same fit streamed in chunks (which must match it), its
sweep of three restarts as lanes, and a 2,000 x 500 x 12
fit (K = 2, P = 4, mc_samples = 6) on the card against the CPU port in
float64 from the same numpy draws, every launch of those paths a wide
one and every launch of every other path a narrow one; past the wide
family's old bound of 64 columns of [psi, X], 64 samples and 2,048 sample
x clone columns, each wide and float64 kernel against its plain version
at every Y storage at shapes crossing each of those alone (Kf 72; S 66;
S*C 2,178; the forward the split one, rfe by dlog_rfe_kernel and Z as a
tiled product; the backward the split one, dlog_rfe_kernel and the tiled
products, in the one call the fit makes and in its two parts alone; the
float64 gene part the split one, dlog_rfe_f64_kernel and
gene_product_f64_kernel), the wide kernels timed at full width at Kf 72,
S*C 660 beside their bounds and the times of the forms they replaced
(the forward and backward bit-identical across two launches), the split
backward and gene part at 2,100 x 200, S*C 2,178 beside the plain
backward, the full-width fit with K = 2, a one-hot of 70 batches (P = 70)
and mc_samples = 66 (every launch a wide one, the backward's the split one
call; its ms an iteration beside the earlier forms' and its inference
peak beside restarts._sweep_bytes', which must not be below it), and
a float64 fit past all three bounds on the card against the CPU port; and
last
``dtype="float64"`` through the float64 kernel family
(``ops/csrc/fused_likelihood_f64.cu``): each float64 kernel against its
plain float64 version at every Y storage it loads, at the shapes above
and at each contract bound, within 1e-12 of each element's absolute-term
sum and bit-identical across two launches, timed at full width beside its
float64 bound (an exp counted as the FP64 instructions of the built
``exp()``, read from ``cuobjdump -sass``); the full-width float64 fit
under "auto" and with float64 Y, its z_cheb fit, a three-restart float64
sweep as "vmap" and as "map" (equal), the float64 fit streamed in 8
chunks (equal to the in-core one), and the golden example and synth fits
and the v1 family's exact and Chebyshev fits in float64 on the card
against the CPU port's (run in a child process after the timed fits),
every launch of those paths a float64 one; then both torch examples
(``examples/quickstart_torch.py``, ``examples/full_workflow_torch.py``) on
the card in a temporary directory; and, after the v1 family, the
distributed fit (``clonealign_torch.parallel``): the full-width
ten-restart sweep through ``run_clonealign(mesh=make_mesh())`` in an NCCL
process group of one rank (equal to the one-process sweep), then two ranks
sharing the card over gloo, spawned with ``torch.multiprocessing``, each
reading and uploading only its half of the cells: the same sweep, a
float64 sweep, ``fit_streaming(mesh=)`` and ``sharded_negbin_fit`` on the
v1 counts, each held to its one-process counterpart, with each rank's
launches and its ms a step in collectives (sharing one card, this measures
correctness and the collectives' cost, not scale-out). Any
failed phase raises and the script exits nonzero, as it does when ptxas's
report lacks a kernel instantiation of the tensor-core, wide or float64
kernels or shows one spilling registers. The last line of standard output
is a JSON object naming the card; the line before it lists each kernel with its launches during the
main path's fit, its error against the plain version, its time, the plain
version's time and its bound (the least time the card could take for the
same work) at the Y storage "auto" resolves to (``y_storage``), the same
for each full-width storage (``by_storage``) and at Kf = 3 and 4
(``by_kf``), the launches of each other path (``paths``: the covariate,
allele and sparse fits, golden rich and allele, the allele sweep, the
streaming fit, the streamed golden synth fit and the command line's two
fits), the errors and times at
the streaming paths' chunk shapes (``stream_shapes``), the backward's entry also
listing its two parts (the Y-free dpsi kernel, and the gene-major kernel
with its packing and reduction kernels), each with its own launches, time,
plain version's time and bound; then one entry for each wide kernel, at
the wide fit's widths with each full-width configuration under
``by_config`` and the wide paths' launches under ``paths``, and at the
past-bound fit's widths one for the forward and one for the split
backward's one call (its launches, its checks past the bound under
``checks``, the small shape's times under ``small_shape``; the
backward's two parts alone, which no path calls, under ``parts``, each
held to the plain VJP and timed beside its terms); then one entry
for each float64 kernel, at the main path's widths (Kf 1, S*C 10) and the
storage "auto" resolves to, with each full-width configuration under
``by_config`` and the float64 paths' launches under ``paths``; the line
before that prints the narrow backward's parts' times.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import scipy.sparse

# A kernel output element passes when |kernel - plain| <= KERNEL_RTOL * scale,
# where scale is the same sum taken over absolute values of its terms. A1,
# A2, dpsi and dW are signed sums over thousands of genes or cells, so an
# error relative to the result itself means nothing where terms cancel; both
# sides accumulate in float32 in different orders, and 1e-4 of the absolute
# sum is about 800 float32 ulps of it.
KERNEL_RTOL = 1e-4

REPO = Path(__file__).resolve().parent

FULL = dict(N=100_000, G=5_000, C=10)     # bench.py's headline configuration
SMALL = dict(N=37, G=41, C=2)             # ragged: no dimension a multiple of a tile (scalar Y loads)
VEC = dict(N=45, G=260, C=4)              # G % 4 == 0: the vectorized Y loads
WIDE = dict(N=100, G=129, C=10)           # with S=2, Kf=3: S*C = 20, four n-tiles
RICH = dict(N=2_000, G=500, C=3)          # the golden rich fit's: with S=3, Kf=4
# Y storage types the kernels load (ops/fused_likelihood.py's Y_DTYPES), and
# those timed at full width
STORAGES = ("float32", "bfloat16", "int16", "int8")
FULL_STORAGES = ("float32", "int16", "int8")
# columns of [psi, X] timed at full width besides Kf = 1, and their storages
FULL_KF = (3, 4)
FULL_KF_STORAGES = ("int8", "float32")
SWEEP = dict(N=2_000, G=500, C=4)
SNV_V = 1_000  # variants of the full-width allele fit
# the full-width fits run in turns: Y as float32, as "auto" resolves, with
# covariates, with allele data, and as a CSR matrix
FIT_KINDS = ("float32", "auto", "auto+x", "auto+allele", "auto+sparse")
FIT_MAX_ITER = 100
MIN_ACCURACY = 0.99
# bench.py's sweep: ten restarts at one shrink, 100 iterations, the ELBO
# monitored from the training evaluation
LANES = dict(initial_shrinks=(5,), n_repeats=10, max_iter=100, elbo_eval="reuse")
GOLDEN_MAX_ITER = 500  # the oracle's converged-fit configuration
GOLDEN_STREAM_CHUNK = 1_024  # cells a chunk of the streamed golden synth fit
# the v1 negative-binomial family at benchmarks/negbin_scale.py's defaults
NEGBIN = dict(N=100_000, G=2_000, C=4)
NEGBIN_MAX_ITER = 100
NEGBIN_GIBBS_SWEEPS = 20
# the JAX package's golden pin of the v1 fit (tests/test_negbin.py:325-344):
# the ELBO at iteration 0 and after 30 iterations
NEGBIN_PIN = (-56595.67761509307, -56266.79825854022)
# serving: cells of the card-against-CPU check; its tolerance on each
# log-posterior, relative to the sum of its terms' absolute values: about
# 170 float32 ulps, room for sums of 5,000 terms in another order (the
# random-walk size is sqrt(5000) ulps, 4e-6) while one gene left out of the
# product (~1.5e-5 of that sum for a gene of average count) fails; and on the
# probabilities
SERVE_SLICE = 2_000
SERVE_RTOL = 1e-5
SERVE_ATOL = 1e-4
# The wide phase (the wide kernel family: Kf > 4, S > 4 or S*C > 32).
# Kernels vs plain at a ragged shape for (Kf, S, C) crossing each limit
# alone and together (S*C = 10, 33, 20, 96), then timed at full width
# (C = 10) for (Kf, S) below, at each of WIDE_FULL_STORAGES
WIDE_CHECK = dict(N=1_000, G=515)
WIDE_CHECKS = ((5, 1, 10), (1, 1, 33), (1, 5, 4), (6, 8, 12))
WIDE_FULL = ((5, 1), (1, 8), (5, 8))
WIDE_FULL_STORAGES = ("int8", "float32")
# the full-width wide fit (and its sweep): K = 1, P = 4 covariates (Kf = 5),
# mc_samples = 8 (S*C = 80); the sweep three restarts as lanes
WIDE_P = 4
WIDE_S = 8
WIDE_LANES = dict(initial_shrinks=(5,), n_repeats=3, max_iter=100, elbo_eval="reuse")
# the parity fit on the card against the CPU port in float64, the same
# numpy draws: Kf = 6, S*C = 72; its own counts (synth_counts seed 41)
PARITY = dict(N=2_000, G=500, C=12, K=2, P=4, mc_samples=6)
PARITY_MAX_ITER = 100
# Published peaks of one H100 SXM at 700 W: HBM bytes/s, float32 FLOP/s on
# CUDA cores (the kernels' contract is float32), TF32 FLOP/s on tensor
# cores, and exps/s on the special-function units: 16 a clock on each of 132
# SMs (the CUDA C++ Programming Guide's throughput table, compute capability
# 9.0) at the 1.98 GHz clock behind the 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
EXP_PER_S = 132 * 16 * 1.98e9


def log(msg: str) -> None:
    print(msg, flush=True)


def launches_of(fl, family="narrow"):
    """One family's kernel launches since the last reset, keyed fwd, dpsi
    and gene (and for the wide family split: kernel_backward's one call for
    both parts past the old bound): the narrow kernels', the "wide"
    family's or the "float64" family's. Raises if another family launched: every path is one
    family's (the wide phase's paths the wide family's, the float64
    phase's the float64 family's, every other path the narrow kernels')."""
    counts = {
        "narrow": {"fwd": fl.fwd_launches, "dpsi": fl.dpsi_launches, "gene": fl.gene_launches},
        "wide": {"fwd": fl.fwd_wide_launches, "dpsi": fl.dpsi_wide_launches,
                 "gene": fl.gene_wide_launches, "split": fl.split_launches},
        "float64": {"fwd": fl.fwd_f64_launches, "dpsi": fl.dpsi_f64_launches,
                    "gene": fl.gene_f64_launches, "split": fl.split_f64_launches}}
    other = {name: n for name, n in counts.items() if name != family and any(n.values())}
    if other:
        raise AssertionError(f"the {', '.join(other)} kernels launched on a {family} path: "
                             f"{other}")
    return counts[family]


# ---------------------------------------------------------------------------
# Kernel vs plain
# ---------------------------------------------------------------------------

def kernel_inputs(gen, N, G, C, S, Kf, device):
    import torch

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    mu = torch.exp(0.5 * randn(S, G))
    L = torch.randint(1, 5, (G, C), generator=gen, device=device).float()
    rates = 0.4 * torch.exp(0.5 * randn(1, G)).expand(N, G)
    return dict(
        Y=torch.poisson(rates.contiguous(), generator=gen),
        psi=randn(N, Kf),
        W=0.3 * randn(G, Kf),
        log_mu=torch.log(mu),
        muL=(mu[:, None, :] * L.T[None]).permute(2, 0, 1).reshape(G, S * C).contiguous(),
        dA1=randn(N),
        dA2=randn(N, S),
        dZ=randn(N, S * C),
    )


def abs_scales(x, with_a2):
    """Per-element sums over absolute terms, for the tolerance."""
    import torch

    Y, psi, W, muL = x["Y"], x["psi"], x["W"], x["muL"]
    log_rfe = psi @ W.T
    rfe = torch.exp(log_rfe)
    fwd = {
        "A1": (Y * log_rfe.abs()).sum(1),
        "Z": rfe @ muL,
    }
    if with_a2:
        fwd["A2"] = Y @ x["log_mu"].abs().T
    dlog = Y * x["dA1"].abs()[:, None] + rfe * (x["dZ"].abs() @ muL.T)
    bwd = {
        "dpsi": dlog @ W.abs(),
        "dW": dlog.T @ psi.abs(),
        "dmuL": rfe.T @ x["dZ"].abs(),
    }
    if with_a2:
        bwd["dlog_mu"] = x["dA2"].abs().T @ Y
    return fwd, bwd


def compare(got: dict, want: dict, scale: dict, label: str, errs=None, rtol=KERNEL_RTOL):
    """Raise unless every element is within ``rtol`` (KERNEL_RTOL) of its
    scale; return the largest absolute error (and record each output's in
    ``errs``)."""
    worst = 0.0
    for name in want:
        if want[name].numel() == 0:
            continue
        err = (got[name] - want[name]).abs()
        rel = float((err / scale[name].clamp_min(1e-30)).max())
        max_abs = float(err.max())
        ok = bool((err <= rtol * scale[name]).all())
        log(f"  {label} {name:8s} max|err| {max_abs:.3e}  max err/scale {rel:.3e}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} {name}: kernel disagrees with the plain version")
        worst = max(worst, max_abs)
        if errs is not None:
            errs[name] = max_abs
    return worst


def cuda_ms(fn, reps, batch=10):
    """Median milliseconds per call over ``reps`` rounds, each timing
    ``batch`` calls queued between two CUDA events after a warm-up: the host
    queues calls faster than the card runs them at full width, so the time
    is the card's, not the wrapper's."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return float(np.median(times))


def bound(y_bytes, vec_floats, exps, mma_flops, fp32_ops):
    """(ms, "bytes" or "operations", unit): the slowest of the bytes over the
    HBM rate (Y's y_bytes and vec_floats float32 values, each input read
    once and each output written once), the exps on the special-function
    units, the products on tensor cores as three TF32 MMA passes (float32
    accuracy), and the other float32 operations on CUDA cores."""
    units = {"bytes": 1e3 * (y_bytes + 4 * vec_floats) / HBM_BYTES_PER_S,
             "exps": 1e3 * exps / EXP_PER_S,
             "3xTF32 MMA": 1e3 * 3 * mma_flops / TF32_OPS_PER_S,
             "float32 operations": 1e3 * fp32_ops / FP32_OPS_PER_S}
    unit = max(units, key=units.get)
    return units[unit], "bytes" if unit == "bytes" else "operations", unit


def kernel_bounds(N, G, Kf, SC, y_itemsize):
    """Bounds of the A2-off forward and backward and of the backward's two
    parts, each by the unit that runs each part of its formulas, with Y read
    once at y_itemsize bytes an element, at any widths (the wide family's
    too: the same functions, whichever kernels compute them). The bound
    counts the least work of each function, not the kernels' own schemes:
    the products with muL do not grow with Kf, the columns of [psi, X]
    (drfe = dZ muL^T is formed once, and each dpsi_k and dW_k is then an
    elementwise sum), so Kf scales only the CUDA-core operations: the Kf
    FMAs an element of log_rfe, of Y W and of each dpsi_k or dW_k."""
    NG = N * G
    # forward: Y, psi, W, muL in; A1, Z, YW out. Z = rfe muL on tensor
    # cores; log_rfe and Y W (A1 = sum_k psi_k (Y W)_k) on CUDA cores.
    fwd = bound(y_itemsize * NG, N * Kf + G * Kf + G * SC + N + N * SC + N * Kf,
                NG, 2 * NG * SC, NG * 4 * Kf)
    # dpsi part: psi, W, muL, dA1, dZ, YW in; dpsi out. drfe = dZ muL^T on
    # tensor cores; log_rfe and dpsi_k = sum_g (rfe drfe) W_k on CUDA cores.
    dpsi = bound(0, N * Kf + G * Kf + G * SC + N + N * SC + N * Kf + N * Kf,
                 NG, 2 * NG * SC, NG * 3 * Kf)
    # gene part: Y, psi, W, muL, dA1, dZ in; dW, dmuL out. drfe = dZ muL^T
    # and dmuL = rfe^T dZ on tensor cores; log_rfe and dW_k = sum_n
    # (rfe drfe + dA1 Y) psi_k on CUDA cores.
    gene = bound(y_itemsize * NG, N * Kf + G * Kf + G * SC + N + N * SC + G * Kf + G * SC,
                 NG, 4 * NG * SC, NG * 4 * Kf)
    # the whole backward: Y, psi, W, muL, dA1, dZ, YW in; dpsi, dW, dmuL
    # out. drfe = dZ muL^T and dmuL = rfe^T dZ on tensor cores; log_rfe,
    # dlog_rfe, dpsi and dW on CUDA cores.
    bwd = bound(y_itemsize * NG, N * Kf + G * Kf + G * SC + N + N * SC + N * Kf
                + N * Kf + G * Kf + G * SC, NG, 4 * NG * SC, NG * (2 * Kf + 3 + 4 * Kf))
    return {"fwd": fwd, "bwd": bwd, "dpsi": dpsi, "gene": gene}


def check_kernels(shape, S, Kf, seed, reps, storage="float32", buffer_rows=None,
                  a2_timed=True, vjp_parts=False, batch=10, identical=False):
    """Compare forward (A2 on and off) and backward with the plain versions
    at one shape, with Y stored as ``storage``, the backward taking Y W from
    the forward kernel as the fit does, and the backward's dpsi and gene
    parts called alone (kernel_dpsi, kernel_gene) with the same plain VJP;
    return the errors (the largest, and each output's under ``errs``; the
    parts' under ``part_errs``) and the times of the A2-off calls (the
    training step's form), with the parts also timed alone; the A2-on calls
    are timed too unless ``a2_timed`` is false. With ``identical``, the
    backward is launched twice more and must give the same bits (raises
    otherwise), and so is the forward: ``identical`` says they did (None
    where not checked). With ``buffer_rows``, Y is handed to the kernels as the streaming
    fit's chunk feeder hands a chunk out: the leading rows of a device
    buffer of ``buffer_rows`` rows, whose other rows hold other counts. With
    ``vjp_parts`` the backward's parts are timed beside the plain VJP's terms
    (dpsi = dlog_rfe W; dW and d(muL) by reference_likelihood_vjp) instead
    of the re-associated reference_dpsi and reference_gene, whose (N, Kf,
    G) and (N, S*C*Kf) products do not fit the card at full width past Kf
    64. ``batch``: calls between a timing's two CUDA events (cuda_ms)."""
    import torch

    from clonealign_torch.ops import fused_likelihood as fl

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = kernel_inputs(gen, shape["N"], shape["G"], shape["C"], S, Kf, "cuda")
    Yf = x["Y"]
    x["Y"] = Yf.to(getattr(torch, storage))
    if not torch.equal(x["Y"].float(), Yf):
        raise AssertionError(f"the test counts do not fit {storage} exactly")
    label = f"{shape['N']}x{shape['G']} S*C={S * shape['C']} Kf={Kf} Y {storage}"
    if buffer_rows is not None:
        buf = torch.full((buffer_rows, shape["G"]), 7, dtype=x["Y"].dtype, device="cuda")
        buf[: shape["N"]] = x["Y"]
        x["Y"] = buf[: shape["N"]]
        label += f" (rows 0:{shape['N']} of a {buffer_rows}-row buffer)"
    result = {}
    for with_a2 in (True, False):
        log_mu = x["log_mu"] if with_a2 else None
        dA2 = x["dA2"] if with_a2 else None
        args_f = (x["Y"], x["psi"], x["W"], log_mu, x["muL"])
        args_b = (x["Y"], x["psi"], x["W"], x["muL"], x["dA1"], dA2, x["dZ"])
        fwd_scale, bwd_scale = abs_scales(dict(x, Y=Yf), with_a2)
        fwd_scale["YW"] = Yf @ x["W"].abs()
        names_f = ("A1", "A2", "Z", "YW")
        names_b = ("dpsi", "dW", "dlog_mu", "dmuL")

        def as_dict(names, out):
            return {n: t for n, t in zip(names, out) if t is not None}

        got = as_dict(names_f, fl.kernel_forward(*args_f))
        want = as_dict(names_f, fl.reference_likelihood_terms(*args_f))
        want["YW"] = Yf @ x["W"]
        torch.cuda.synchronize()
        tag = f"{label} A2={'on' if with_a2 else 'off'}"
        errs = {}
        err_f = compare(got, want, fwd_scale, f"fwd {tag}", errs)
        YW = got["YW"]
        got = as_dict(names_b, fl.kernel_backward(*args_b, YW))
        want = as_dict(names_b, fl.reference_likelihood_vjp(*args_b))
        torch.cuda.synchronize()
        err_b = compare(got, want, bwd_scale, f"bwd {tag}", errs)
        parts = as_dict(names_b, (fl.kernel_dpsi(x["psi"], x["W"], x["muL"], x["dA1"], x["dZ"],
                                                 YW), *fl.kernel_gene(*args_b)))
        torch.cuda.synchronize()
        part_errs = {}
        compare(parts, want, bwd_scale, f"bwd parts alone {tag}", part_errs)
        del parts
        same = None  # whether the forward and backward gave the same bits twice, where checked
        if identical:
            same = True
            for part, names, call in (("fwd", names_f, lambda: fl.kernel_forward(*args_f)),
                                      ("bwd", names_b,
                                       lambda: fl.kernel_backward(*args_b, YW))):
                runs = [as_dict(names, call()) for _ in range(2)]
                differ = [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])]
                log(f"  {part} {tag}: two launches "
                    + (f"DIFFER in {', '.join(differ)}" if differ else "bit-identical"))
                same = same and not differ
                if differ:
                    raise AssertionError(f"{part} {tag}: two launches differ in {differ}")
                del runs
        if with_a2 and not a2_timed:
            continue
        t = {
            "fwd_ms": cuda_ms(lambda: fl.kernel_forward(*args_f), reps, batch),
            "fwd_plain_ms": cuda_ms(lambda: fl.reference_likelihood_terms(*args_f), reps, batch),
            "bwd_ms": cuda_ms(lambda: fl.kernel_backward(*args_b, YW), reps, batch),
            "bwd_plain_ms": cuda_ms(lambda: fl.reference_likelihood_vjp(*args_b), reps, batch),
            "dpsi_ms": cuda_ms(lambda: fl.kernel_dpsi(
                x["psi"], x["W"], x["muL"], x["dA1"], x["dZ"], YW), reps, batch),
            "gene_ms": cuda_ms(lambda: fl.kernel_gene(*args_b), reps, batch),
        }
        log(f"  {tag}: fwd {t['fwd_ms']:.3f} ms (plain {t['fwd_plain_ms']:.3f} ms), "
            f"bwd {t['bwd_ms']:.3f} ms "
            f"(dpsi {t['dpsi_ms']:.3f} ms + gene {t['gene_ms']:.3f} ms; "
            f"plain {t['bwd_plain_ms']:.3f} ms)")
        if not with_a2:
            result = dict(t, fwd_err=err_f, bwd_err=err_b, errs=errs, part_errs=part_errs,
                          identical=same)
    result["bounds"] = kernel_bounds(shape["N"], shape["G"], Kf, S * shape["C"],
                                     x["Y"].element_size())
    if vjp_parts:
        def plain_dpsi():
            rfe = torch.exp(x["psi"] @ x["W"].T)
            return (x["Y"].float() * x["dA1"][:, None] + rfe * (x["dZ"] @ x["muL"].T)) @ x["W"]

        result["dpsi_plain_ms"] = cuda_ms(plain_dpsi, reps, batch)
        result["gene_plain_ms"] = cuda_ms(lambda: fl.reference_likelihood_vjp(
            x["Y"], x["psi"], x["W"], x["muL"], x["dA1"], None, x["dZ"]), reps, batch)
    else:
        result["dpsi_plain_ms"] = cuda_ms(lambda: fl.reference_dpsi(
            YW, x["psi"], x["W"], x["muL"], x["dA1"], x["dZ"]), reps, batch)
        result["gene_plain_ms"] = cuda_ms(lambda: fl.reference_gene(
            x["Y"], x["psi"], x["W"], x["muL"], x["dA1"], None, x["dZ"]), reps, batch)
    del x, Yf, YW
    torch.cuda.empty_cache()
    return result


def check_stream_shapes(bounds, G, C, storage, seed):
    """Hold the kernels against their plain versions at the shapes a
    streaming fit gives them (K = 1, one sample: Kf = 1, S = 1): each chunk
    size in ``bounds`` (the full chunks and the ragged tail) at G genes and
    C clones, Y in ``storage`` as the leading rows of the feeder's buffer.
    Returns one entry per shape for the kernels line."""
    sizes = sorted({j - i for i, j in bounds}, reverse=True)
    out = []
    for k, n in enumerate(sizes):
        r = check_kernels(dict(N=n, G=G, C=C), S=1, Kf=1, seed=seed + k, reps=3,
                          storage=storage, buffer_rows=sizes[0])
        out.append({"shape": f"{n}x{G} C={C}", "buffer_rows": sizes[0],
                    "y_storage": storage, "fwd_max_abs_err": r["fwd_err"],
                    "bwd_max_abs_err": r["bwd_err"], "fwd_ms": r["fwd_ms"],
                    "fwd_plain_ms": r["fwd_plain_ms"], "bwd_ms": r["bwd_ms"],
                    "bwd_plain_ms": r["bwd_plain_ms"]})
    return out


def kernel_resources(build_log, kernel):
    """ptxas's report (-v) for each instantiation of one kernel template,
    keyed by its template arguments: {"<1,2,0>": (registers, spill store
    bytes, spill load bytes)}; a kernel that is no template is keyed "<>"."""
    found, name, spills = {}, None, (0, 0)
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        f = re.search(r"\d" + kernel + r"(?:I((?:L[ib]\d+E)+)E|E)", name or "")
        if m and f:
            label = "<" + ",".join(re.findall(r"L[ib](\d+)E", f.group(1) or "")) + ">"
            found[label] = (int(m.group(1)), *spills)
    return found


def tc_kernels(fl):
    """The instantiations each kernel must have in the report: the
    tensor-core kernels fwd_kernel<YT, KF, NT, A2> (96), dpsi_kernel<KF, NT>
    (12) and gene_kernel<YT, KF, NT, A2> (88), YT the Y storage code (0-3),
    and the wide family's: fwd_wide_kernel<NZ, STEPS> (16, STEPS the
    k-steps a stage, 2 or 4), fwd_wide_y_kernel<YT, NY> (20),
    gene_wide_kernel<YT, NJ> (32) and dpsi_wide_kernel<NK, NZ> (24) at the
    built tile counts (``fl.WIDE_TILE_COUNTS``, ``fl.WIDE_Y_TILE_COUNTS``,
    ``fl.WIDE_DPSI_K_COUNTS`` x ``fl.WIDE_DPSI_Z_COUNTS``), and their
    packing kernels (no templates); the split backward past the old bound,
    dlog_rfe_kernel<YT, OUT> (6: dlog_rfe with Y read at each storage, t =
    rfe drfe, and the split forward's rfe alone), gene_product_kernel<YT,
    YV> (5: Y read at each storage, and the Y-free form) and dpsi_product_kernel and
    dpsi_sum_kernel (no templates); and the float64 family's
    fwd_f64_kernel<YT, NT> (28: ``fl.F64_FWD_TILE_COUNTS``),
    dpsi_f64_kernel<NK, NZ> (24: ``fl.F64_DPSI_K_COUNTS`` x
    ``fl.F64_DPSI_Z_COUNTS``) and
    gene_f64_kernel<YT, NT, NK> (40: ``fl.F64_GENE_TILE_COUNTS``), their
    packing kernels and reduce_chunks_f64_kernel, and past the old bound
    its split kernels, dlog_rfe_f64_kernel<YT, OUT> (9: dlog_rfe and the
    forward's rfe with A1, Y read at each storage, and dpsi's t),
    gene_product_f64_kernel<YT, YV> (5: dlog mu's at each storage, and the
    Y-free form), dpsi_product_f64_kernel and dpsi_sum_f64_kernel (no
    templates: Z's and dpsi's products over gene ranges, their sums)."""
    return {
        "fwd_kernel": {f"<{y},{k},{t},{a}>" for y in range(4) for k in (1, 2, 3, 4)
                       for t in (1, 2, 4) for a in (0, 1)},
        "dpsi_kernel": {f"<{k},{t}>" for k in (1, 2, 3, 4) for t in (1, 2, 4)},
        "gene_kernel": {f"<{y},{k},{t},{a}>" for y in range(4) for k in (1, 2, 3, 4)
                        for t in range(1, (4, 3, 2, 2)[k - 1] + 1) for a in (0, 1)},
        "fwd_wide_kernel": {f"<{t},{s}>" for t in fl.WIDE_TILE_COUNTS for s in (2, 4)},
        "fwd_wide_y_kernel": {f"<{y},{t}>" for y in range(4) for t in fl.WIDE_Y_TILE_COUNTS},
        "fwd_wide_pack_kernel": {"<>"},
        "dpsi_wide_kernel": {f"<{k},{z}>" for k in fl.WIDE_DPSI_K_COUNTS
                             for z in fl.WIDE_DPSI_Z_COUNTS},
        "dpsi_wide_pack_kernel": {"<>"},
        "gene_wide_kernel": {f"<{y},{t}>" for y in range(4) for t in fl.WIDE_TILE_COUNTS},
        "gene_wide_pack_kernel": {"<>"},
        "dlog_rfe_kernel": {"<0,0>", "<0,2>"} | {f"<{y},1>" for y in range(4)},
        "gene_product_kernel": {"<0,0>"} | {f"<{y},1>" for y in range(4)},
        "dpsi_product_kernel": {"<>"},
        "dpsi_sum_kernel": {"<>"},
        "fwd_f64_kernel": {f"<{y},{t}>" for y in range(4) for t in fl.F64_FWD_TILE_COUNTS},
        "fwd_f64_pack_kernel": {"<>"},
        "dpsi_f64_kernel": {f"<{k},{z}>" for k in fl.F64_DPSI_K_COUNTS
                            for z in fl.F64_DPSI_Z_COUNTS},
        "dpsi_f64_pack_kernel": {"<>"},
        "gene_f64_pack_kernel": {"<>"},
        "gene_f64_kernel": {f"<{y},{t},{k}>" for y in range(4)
                            for k, counts in fl.F64_GENE_TILE_COUNTS.items() for t in counts},
        "dlog_rfe_f64_kernel": {"<0,0>"} | {f"<{y},{o}>" for y in range(4) for o in (1, 2)},
        "gene_product_f64_kernel": {"<0,0>"} | {f"<{y},1>" for y in range(4)},
        "dpsi_product_f64_kernel": {"<>"},
        "dpsi_sum_f64_kernel": {"<>"},
        "reduce_chunks_f64_kernel": {"<>"},
    }


def log_tc_resources(build_log, fl):
    """Print the tensor-core kernels' and the wide family's registers and
    spills, one line per kernel; raise if an instantiation spills or is
    missing from the report."""
    for kernel, want in tc_kernels(fl).items():
        res = kernel_resources(build_log, kernel)
        log(f"{kernel} ptxas: " + "; ".join(
            f"{k} {r} registers, {st}/{ld} B spill stores/loads"
            for k, (r, st, ld) in sorted(res.items())))
        if set(res) != want:
            raise AssertionError(f"{kernel}: the ptxas report lacks {sorted(want - set(res))}")
        spilled = [k for k, (_, st, ld) in res.items() if st or ld]
        if spilled:
            raise AssertionError(f"{kernel} spills registers in {spilled}")


# ---------------------------------------------------------------------------
# Fit
# ---------------------------------------------------------------------------

def synth_counts(seed, N, G, C):
    """Clone-structured Poisson counts made on the card (bench.py's recipe):
    L in {1..4}, mu = exp(0.5 N(0,1)), row totals about 2000, and a count
    added to gene 0 of any all-zero row. Returns host int16 counts, L and
    the true clone of each cell."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    L = torch.randint(1, 5, (G, C), generator=gen, device="cuda").float()
    mu = torch.exp(0.5 * torch.randn(G, generator=gen, device="cuda"))
    z = torch.randint(0, C, (N,), generator=gen, device="cuda")
    Y = torch.empty(N, G, dtype=torch.int16, device="cuda")
    for i in range(0, N, 10_000):
        rates = mu[None, :] * L[:, z[i:i + 10_000]].T
        rates = rates * (2000.0 / rates.sum(1, keepdim=True))
        y = torch.poisson(rates, generator=gen)
        y[:, 0] += (y.sum(1) == 0).float()
        if float(y.max()) > 32767:
            raise AssertionError("synthetic counts exceed int16")
        Y[i:i + 10_000] = y.to(torch.int16)
    return Y.cpu().numpy(), L.cpu().numpy().astype(np.float64), z.cpu().numpy()


def snv_data(z, C, V, seed):
    """V variants around the true clones z, made with numpy by the golden
    oracle's recipe (tests/golden/make_tpu_parity_oracle.py:49-60): clone
    copy numbers 1-3, Poisson(8) coverage, alternative counts binomial at
    0.5 where the true clone's copy number is 2, else at 0.05 or 0.95;
    ``ref = cov - alt``."""
    rng = np.random.default_rng(seed)
    clone_allele = rng.integers(1, 4, (V, C)).astype(np.float64)
    cov = rng.poisson(8.0, (len(z), V)).astype(np.float64)
    cn = clone_allele[:, z]  # (V, N)
    p = np.where(cn == 2, 0.5, np.where(rng.random(cn.shape) < 0.5, 0.05, 0.95))
    alt = rng.binomial(cov.T.astype(np.int64), p).astype(np.float64)
    return dict(clone_allele=clone_allele, cov=cov, ref=cov - alt.T)


def accuracy(fit, z_true) -> float:
    index = {name: i for i, name in enumerate(fit.clone_names)}
    called = np.asarray([index.get(c, -1) for c in fit.clone])  # unassigned counts wrong
    return float(np.mean(called == z_true))


def check_trace(trace):
    trace = np.asarray(trace, np.float64)
    if not np.isfinite(trace).all():
        raise AssertionError("ELBO trace has non-finite values")
    rising = float(np.mean(np.diff(trace) > 0))
    if not (trace[-1] > trace[0] and rising >= 0.5):
        raise AssertionError(
            f"ELBO trace is not mostly increasing: first {trace[0]}, last "
            f"{trace[-1]}, share of rising steps {rising:.2f}"
        )
    return rising


@contextlib.contextmanager
def inference_peaks():
    """Collect the card's peak allocated bytes over each call of the
    inference (a single fit's loop, the sweep's lane-batched loop, or each
    restart of the sequential one), to hold against restarts._sweep_bytes;
    setup's transients, which precede the loop, are not in it. Each entry
    is (the loop's name, peak bytes), so the name shows whether a sweep ran
    as lanes ("run_inference_lanes") or in sequence ("run_inference")."""
    import torch

    from clonealign_torch import api, restarts

    targets = ((api, "run_inference"), (restarts, "run_inference"),
               (restarts, "run_inference_lanes"))
    peaks, originals = [], {(m, n): getattr(m, n) for m, n in targets}

    def measured(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            peaks.append((name, torch.cuda.max_memory_allocated()))
            return out
        return call

    for (m, n), fn in originals.items():
        setattr(m, n, measured(n, fn))
    try:
        yield peaks
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)


@contextlib.contextmanager
def setup_measures():
    """Collect each call of setup_fit's wall seconds and the card's peak
    allocated bytes over it, and the wall seconds of the allele term's own
    setup within it (``api._setup_allele``: the beta-binomial passes and
    their products, in blocks of cells), after synchronizing the card."""
    import torch

    from clonealign_torch import api, restarts

    found = {"setup": [], "allele_s": []}
    originals = {(m, n): getattr(m, n) for m, n in ((api, "setup_fit"), (restarts, "setup_fit"),
                                                    (api, "_setup_allele"))}

    def measured(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            if name == "setup":
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            found[name].append((seconds, torch.cuda.max_memory_allocated())
                               if name == "setup" else seconds)
            return out
        return call

    for (m, n), fn in originals.items():
        setattr(m, n, measured("allele_s" if n == "_setup_allele" else "setup", fn))
    try:
        yield found
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)


def snv_accuracy(fit, z_true) -> float:
    """The clone calls of the SNV term alone: argmax of clone_probs_from_snv."""
    return float(np.mean(np.argmax(fit.clone_probs_from_snv, axis=1) == z_true))


def full_fit(clonealign_torch, fl, Y, L, z, y_storage, x=None, allele=None, label=None,
             mc_samples=1, wide=False, dtype="float32", K=1, max_iter=FIT_MAX_ITER):
    """One full-width exact fit through clonealign in ``dtype`` with Y
    stored as ``y_storage``, the covariates ``x`` (or none), the allele
    data ``allele`` (a dict of clone_allele, cov and ref, or none) and
    ``mc_samples`` (K latent factors), at most ``max_iter`` iterations, its
    kernel launches counted from zero (the wide
    family's with ``wide``, the float64 family's in float64, and none of
    another family); checks its ELBO trace, accuracy and launches (and
    beta's shape, or the SNV probabilities) and returns its numbers."""
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    with inference_peaks() as peaks, setup_measures() as setups:
        fit = clonealign_torch.clonealign(
            Y, L, device="cuda", max_iter=max_iter, seed=0, verbose=False,
            likelihood_impl="xla", y_storage=y_storage, x=x, mc_samples=mc_samples,
            dtype=dtype, K=K, **(allele or {}),
        )
    wall = time.perf_counter() - t0
    family = "float64" if dtype == "float64" else "wide" if wide else "narrow"
    launches = launches_of(fl, family)
    ci, tm = fit.convergence_info, fit.timings
    n_iters = ci.n_iters
    (_, setup_peak), = setups["setup"]
    out = {"iter_ms": 1000 * tm["loop"] / max(n_iters, 1), "setup_s": tm["setup"],
           "peak_gb": max(b for _, b in peaks) / 1e9, "setup_peak_gb": setup_peak / 1e9,
           "final_elbo": ci.final_elbo, "sd_final": ci.sd_final_elbo, "labels": fit.clone,
           "accuracy": accuracy(fit, z), "launches": launches, "n_iters": n_iters}
    P = 0 if x is None else x.shape[1]
    if P:
        beta = fit.ml_params["beta"]
        if beta.shape != (FULL["G"], P) or not np.isfinite(beta).all():
            raise AssertionError(f"beta has shape {beta.shape} or is not finite")
        log(f"  beta: |beta| max {np.abs(beta).max():.4g}, mean {np.abs(beta).mean():.4g}")
    if allele is not None:
        probs = fit.clone_probs_from_snv
        if probs is None or probs.shape != (FULL["N"], FULL["C"]) or not np.isfinite(probs).all():
            raise AssertionError("the allele fit's clone_probs_from_snv is missing or not finite")
        (out["allele_s"],) = setups["allele_s"]
        out["snv_accuracy"] = snv_accuracy(fit, z)
        log(f"  allele term: V={allele['clone_allele'].shape[0]} variants, "
            f"{out['allele_s']:.3f} s of setup; SNV-alone accuracy {out['snv_accuracy']:.4f}")
    elif fit.clone_probs_from_snv is not None:
        raise AssertionError("a fit without allele data carries clone_probs_from_snv")
    log(f"fit {FULL['N']}x{FULL['G']}x{FULL['C']} {label or y_storage} y_storage={y_storage} "
        f"dtype={dtype} K={K} P={P} mc_samples={mc_samples}: {wall:.2f} s wall, "
        f"setup {tm['setup']:.2f} s (peak allocated {out['setup_peak_gb']:.3f} GB), "
        f"init {tm['init']:.2f} s, "
        f"inference {tm['inference']:.2f} s ({n_iters} iterations, "
        f"{out['iter_ms']:.2f} ms per iteration), package {tm['package']:.2f} s; "
        f"peak allocated in the inference {out['peak_gb']:.3f} GB")
    rising = check_trace(ci.elbo)
    log(f"  ELBO {ci.elbo[0]:.6g} -> {ci.elbo[-1]:.6g} (rising steps {rising:.2f}), final "
        f"{ci.final_elbo:.9g} +- {ci.sd_final_elbo:.3g}; accuracy {out['accuracy']:.4f}; "
        f"launches{' (wide)' if wide else ''} fwd {launches['fwd']} dpsi {launches['dpsi']} "
        f"gene {launches['gene']}" + (f" split {launches['split']}" if "split" in launches else ""))
    if out["accuracy"] < MIN_ACCURACY:
        raise AssertionError(f"{label or y_storage}: accuracy {out['accuracy']:.4f} < {MIN_ACCURACY}")
    # warm start + initial ELBO + (train + fresh eval) per iteration + 20
    # final, and one backward (a dpsi and a gene-major launch; past the old
    # bound one split launch for both) per iteration
    want = {"fwd": 2 + 2 * n_iters + 20, "dpsi": n_iters, "gene": n_iters}
    if family != "narrow":
        past = fl.split_route(K + P, 0, mc_samples * FULL["C"])
        want.update(dpsi=0 if past else n_iters, gene=0 if past else n_iters,
                    split=n_iters if past else 0)
    if launches != want:
        raise AssertionError(f"{label or y_storage}: kernel launches {launches} do not match "
                             f"{n_iters} iterations (expected {want})")
    return out


def run_sweep(clonealign_torch, fl, Y, L, z, name, impl, batching, y_storage, y_itemsize,
              x=None, lanes=LANES, mc_samples=1, wide=False, dtype="float32"):
    """One full-width sweep through run_clonealign in ``dtype`` with Y
    stored as ``y_storage`` (y_itemsize bytes an element), the covariates
    ``x`` (or none), the restarts ``lanes`` and ``mc_samples``; returns its
    lanes' iterations, the kernel launches it made (the wide family's with
    ``wide``, the float64 family's in float64, and none of another family),
    its ms per lane iteration, its peak allocated bytes in the inference,
    how its lanes ran ("vmap" or "map", as the loop it called shows) and
    the best fit's labels."""
    from clonealign_torch.restarts import _sweep_bytes

    fl.reset_launch_counts()
    t0 = time.perf_counter()
    with inference_peaks() as loop_peaks:
        fit = clonealign_torch.run_clonealign(
            Y, L, device="cuda", seed=0, verbose=False, likelihood_impl=impl,
            restart_batching=batching, y_storage=y_storage, x=x, mc_samples=mc_samples,
            dtype=dtype, **lanes,
        )
    wall = time.perf_counter() - t0
    launches = launches_of(fl, "float64" if dtype == "float64" else "wide" if wide else "narrow")
    tm, iters = fit.timings, fit.timings["iterations"]
    R = len(iters)
    acc = accuracy(fit, z)
    ran = "vmap" if [n for n, _ in loop_peaks] == ["run_inference_lanes"] else "map"
    P = 0 if x is None else x.shape[1]
    plan = _sweep_bytes(FULL["N"], FULL["G"], FULL["C"], 1, mc_samples, R,
                        8 if dtype == "float64" else 4, "cuda", y_itemsize, P, impl == "z_cheb",
                        batching=ran) / 1e9
    peak = max(b for _, b in loop_peaks) / 1e9
    log(f"sweep ({name}) {impl} {batching} (ran as {ran}) y_storage={y_storage} dtype={dtype} "
        f"P={P} "
        f"mc_samples={mc_samples}, {R} lanes: "
        f"{wall:.2f} s wall, setup "
        f"{tm['setup']:.2f} s, init {tm['init']:.2f} s, loop {tm['loop']:.2f} s "
        f"({sum(iters)} lane iterations: {1000 * tm['loop'] / sum(iters):.2f} ms per lane "
        f"iteration, {1000 * tm['loop'] / max(iters):.2f} ms per sweep iteration), "
        f"inference {tm['inference']:.2f} s, package {tm['package']:.2f} s; iterations {iters}; "
        f"best lane {fit.multirun_info['best_run']} accuracy {acc:.4f}; launches {launches}; "
        f"peak allocated in the inference {peak:.4f} GB, restarts._sweep_bytes reckons "
        f"{plan:.4f} GB ({plan / peak:.3f} of it{', UNDER the peak' if plan < peak else ''})")
    if acc < MIN_ACCURACY:
        raise AssertionError(f"sweep ({name}): best lane accuracy {acc:.4f} < {MIN_ACCURACY}")
    want = {"fwd": sum(2 + n + 20 for n in iters) if impl == "xla" else 20 * R,
            "dpsi": sum(iters) if impl == "xla" else 0}
    want["gene"] = want["dpsi"]
    if "split" in launches:
        want["split"] = 0
    if launches != want:
        raise AssertionError(f"sweep ({name}): launches {launches}, expected {want}")
    return {"iterations": iters, "launches": launches, "ran": ran, "plan_gb": plan,
            "lane_iter_ms": 1000 * tm["loop"] / sum(iters), "peak_gb": peak, "labels": fit.clone,
            "elbos": np.asarray(fit.multirun_info["elbos"])}


def allele_sweep(clonealign_torch, fl):
    """The golden allele data's sweep of three restarts (100 iterations)
    through run_clonealign as "map" and "vmap", in turns, each with its
    launches counted from zero: every lane must run the same iterations
    under both, the labels must agree, and the fit must carry
    clone_probs_from_snv. Returns each batching's launches."""
    oracle = np.load(REPO / "tests" / "golden" / "tpu_parity_oracle.npz")
    allele = {k: oracle[f"allele_{k}"] for k in ("clone_allele", "cov", "ref")}
    runs = []
    for batching in ("map", "vmap", "map", "vmap"):
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        fit = clonealign_torch.run_clonealign(
            oracle["allele_Y"], oracle["allele_L"], initial_shrinks=(0, 5, 10), n_repeats=1,
            device="cuda", max_iter=FIT_MAX_ITER, seed=0, verbose=False,
            restart_batching=batching, **allele)
        launches = launches_of(fl)
        iters = fit.timings["iterations"]
        want = {"fwd": sum(2 + 2 * n + 20 for n in iters), "dpsi": sum(iters),
                "gene": sum(iters)}
        log(f"allele sweep {batching}: {time.perf_counter() - t0:.2f} s, iterations {iters}, "
            f"ELBOs {fit.multirun_info['elbos'].tolist()}, best {fit.multirun_info['best_run']}, "
            f"launches {launches}")
        if launches != want or fit.clone_probs_from_snv is None:
            raise AssertionError(f"allele sweep {batching}: launches {launches} (expected {want}) "
                                 "or no clone_probs_from_snv")
        runs.append((batching, iters, fit.clone, launches))
    for (_, iters, clone, _), (b, iters_b, clone_b, _) in zip(runs[::2], runs[1::2]):
        if iters_b != iters or clone_b != clone:
            raise AssertionError(f"allele sweep: {b} differs from map in iterations or labels")
    return {b: launches for b, _, _, launches in runs[:2]}


@contextlib.contextmanager
def feeder_marks():
    """Have every chunk feeder the streaming fit makes collect its timing
    events (``stream._ChunkFeeder.marks``); yields the list of feeders."""
    from clonealign_torch import stream

    feeders, original = [], stream._ChunkFeeder

    class Marked(original):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.marks = []
            feeders.append(self)

    stream._ChunkFeeder = Marked
    try:
        yield feeders
    finally:
        stream._ChunkFeeder = original


def copy_overlap(feeder, sweeps):
    """For each of the feeder's sweeps in ``sweeps`` (a slice of its
    marks), on the card's clock (CUDA events): the share of the sweep's
    copy time that falls inside the compute stream's chunk spans (the union
    over the whole fit of each chunk's span, from its copy landing to the
    end of the work queued for it; a span includes any gap in which the
    card waits for the host to queue that work), the sweep's copy
    milliseconds, the mean compute span of a chunk and each chunk's copy's
    own share. Unclipped: a share is a ratio of two measured times."""
    marks = feeder.marks
    ref = marks[0]["copy"][0][0]

    def span(pair):
        return ref.elapsed_time(pair[0]), ref.elapsed_time(pair[1])

    union = []
    for a, b in sorted(span(p) for sw in marks for p in sw["compute"]):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    out = []
    for sw in marks[sweeps]:
        copies = [span(p) for p in sw["copy"]]
        inside = [sum(max(0.0, min(b, e) - max(a, s)) for s, e in union) for a, b in copies]
        total = sum(b - a for a, b in copies)
        spans = [e - s for s, e in map(span, sw["compute"])]
        out.append({"share": sum(inside) / total, "copy_ms": total,
                    "span_ms": float(np.mean(spans)),
                    "by_chunk": [h / (b - a) for h, (a, b) in zip(inside, copies)]})
    return out


def stream_turns(clonealign_torch, fl, Y, L, z):
    """The full-width streaming fit (``fit_streaming``, "auto" storage and
    chunks, "reuse") and the in-core fit on the same data, seed and
    monitoring, in turns: each with its launches counted from zero and the
    card's peak allocated bytes over the call, from a reset with the data
    on the host (the bytes allocated before it subtracted). The streamed
    fit must match the in-core fit of its turn (iterations, labels, final
    ELBO within max(1e-4 |ELBO|, 3 sd_final)), reach the accuracy bar,
    launch what its chunks and evaluations give, and peak below Y's bytes at
    int8. Each streamed turn also measures, from its feeder's CUDA events,
    how much of each training step's copy time runs beside the chunks' work
    (:func:`copy_overlap`). Returns each turn's numbers, the last in-core
    fit (to serve against) and the number of chunks."""
    import torch

    from clonealign_torch import stream

    n_chunks = len(stream._chunk_bounds(FULL["N"], stream._resolve_chunk_cells(
        "auto", FULL["N"], FULL["G"])))
    kw = dict(device="cuda", max_iter=FIT_MAX_ITER, seed=0, verbose=False, elbo_eval="reuse")
    turns, core_fit = [], None
    for kind in ("stream", "core", "core", "stream"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        if kind == "stream":
            with feeder_marks() as feeders:
                fit = clonealign_torch.fit_streaming(Y, L, chunk_cells="auto", **kw)
        else:
            fit = core_fit = clonealign_torch.clonealign(Y, L, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        launches = launches_of(fl)
        ci, tm, n = fit.convergence_info, fit.timings, fit.convergence_info.n_iters
        acc = accuracy(fit, z)
        per = n_chunks if kind == "stream" else 1
        # warm start + initial ELBO + the training evaluation of each step +
        # 20 final draws, each over every chunk; one backward a chunk a step
        want = {"fwd": per * (2 + n + 20), "dpsi": per * n, "gene": per * n}
        out = dict(kind=kind, wall=wall, iter_ms=1000 * tm["loop"] / max(n, 1), n_iters=n,
                   final_elbo=ci.final_elbo, sd_final=ci.sd_final_elbo, labels=fit.clone,
                   accuracy=acc, launches=launches, peak_gb=peak / 1e9, timings=tm)
        if kind == "stream":
            (feeder,) = feeders
            if len(feeder.marks) != n + 3:  # warm, initial ELBO, n steps, final
                raise AssertionError(f"the feeder made {len(feeder.marks)} sweeps for {n} steps")
            out["overlap"] = copy_overlap(feeder, slice(2, 2 + n))
            shares = [o["share"] for o in out["overlap"]]
            log(f"  copies beside the chunks' work, {n} training steps (CUDA events): share of "
                f"the copy time inside the compute spans median {np.median(shares):.4f}, min "
                f"{min(shares):.4f}, max {max(shares):.4f}; copies "
                f"{np.median([o['copy_ms'] for o in out['overlap']]):.3f} ms a step (median), "
                f"a chunk's compute span {np.median([o['span_ms'] for o in out['overlap']]):.3f} "
                "ms (median); each chunk's copy's share (median) " + ", ".join(
                    f"{v:.3f}" for v in np.median([o["by_chunk"] for o in out["overlap"]], axis=0)))
        log(f"{'streaming' if kind == 'stream' else 'in-core'} fit {FULL['N']}x{FULL['G']}x"
            f"{FULL['C']} auto reuse{f' ({n_chunks} chunks)' if per > 1 else ''}: {wall:.2f} s "
            f"wall (setup {tm['setup']:.2f}, init {tm['init']:.2f}, inference "
            f"{tm['inference']:.2f}, package {tm['package']:.2f} s), {n} iterations, "
            f"{out['iter_ms']:.2f} ms per iteration; final ELBO {ci.final_elbo:.9g} +- "
            f"{ci.sd_final_elbo:.3g}; accuracy {acc:.4f}; launches {launches}; peak allocated "
            f"over the call {out['peak_gb']:.3f} GB")
        check_trace(ci.elbo)
        if acc < MIN_ACCURACY or launches != want:
            raise AssertionError(f"{kind} fit: accuracy {acc:.4f}, launches {launches} "
                                 f"(expected {want})")
        turns.append(out)
    y_int8_gb = FULL["N"] * FULL["G"] / 1e9
    for s_fit, c_fit in ((turns[0], turns[1]), (turns[3], turns[2])):
        diff = abs(s_fit["final_elbo"] - c_fit["final_elbo"])
        bar = max(1e-4 * abs(c_fit["final_elbo"]), 3.0 * s_fit["sd_final"])
        same = s_fit["labels"] == c_fit["labels"]
        log(f"streamed against in-core: iterations {s_fit['n_iters']} / {c_fit['n_iters']}, "
            f"final ELBO |diff| {diff:.6g} (bar {bar:.6g}), labels "
            f"{'identical' if same else 'DIFFER'}; streaming peak {s_fit['peak_gb']:.3f} GB "
            f"against Y's {y_int8_gb:.3f} GB at int8")
        if not (same and diff <= bar and s_fit["n_iters"] == c_fit["n_iters"]):
            raise AssertionError("the streamed fit differs from the in-core fit")
        if not s_fit["peak_gb"] < y_int8_gb:
            raise AssertionError("the streaming fit held Y's bytes on the card")
    return turns, core_fit, n_chunks


def upload_rates(Y):
    """What streaming the chunks costs, for one sweep over the "auto"
    chunks: the card time of copying one chunk from a pinned host buffer
    into a device buffer (3 rounds of 10 copies between CUDA events), and
    the wall time of the host conversion alone (each chunk's int16 rows
    into a pinned buffer, 3 sweeps). Returns a dict of those numbers, each
    round's and sweep's kept."""
    import torch

    from clonealign_torch import api, stream

    store = api._auto_y_storage(Y)
    rows = stream._resolve_chunk_cells("auto", FULL["N"], FULL["G"])
    host = torch.empty((rows, FULL["G"]), dtype=store, pin_memory=True)
    dev = torch.empty_like(host, device="cuda")
    nbytes = host.numel() * host.element_size()
    copy_ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), 3, batch=10)
    gbps = nbytes / (copy_ms / 1e3) / 1e9
    src = stream._RowSource(Y, None)
    bounds = stream._chunk_bounds(FULL["N"], rows)
    convs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for i, j in bounds:
            host[: j - i].copy_(src.tensor(i, j))
        convs.append(1e3 * (time.perf_counter() - t0))
    del host, dev
    torch.cuda.empty_cache()
    return dict(gbps=gbps, chunk_bytes=nbytes, n_chunks=len(bounds),
                copy_ms=Y.size * store.itemsize / (gbps * 1e9) * 1e3, conv_ms=convs)


def serve_reference(fit, Y, L, latent):
    """The CPU port's unnormalized log-posteriors of the cells ``Y`` in
    float64 (``serve._posterior_log_probs``, or its refinement for
    "refine"), and per (cell, clone) the sum of the absolute values of the
    plain log-posterior's terms, |log alpha_c| + sum_g y_g |log(mu_g L_gc)|
    + t |log Z_c|: the scale of the serving tolerance."""
    import torch

    from clonealign_torch import serve

    mu = np.asarray(fit.ml_params["mu"], np.float64)
    L = np.minimum(L, 6.0)
    alpha = np.asarray(fit.ml_params["alpha"], np.float64)
    log_alpha = np.log(alpha / alpha.sum())
    Yf = np.asarray(Y, np.float64)
    args = [torch.as_tensor(a) for a in (Yf, L, mu, log_alpha)]
    if latent == "refine":
        W = torch.as_tensor(np.asarray(fit.ml_params["W"], np.float64))
        want = serve._posterior_log_probs_refined(*args, W, 8)
    else:
        want = serve._posterior_log_probs(*args)
    rates = mu[:, None] * L
    log_r = np.log(np.where(rates > 0, rates, 1.0))
    scale = (np.abs(log_alpha)[None, :] + Yf @ np.abs(log_r)
             + Yf.sum(1)[:, None] * np.abs(np.log(rates.sum(0)))[None, :])
    return want.numpy(), scale


def serve_full(clonealign_torch, fit, Y, L, z):
    """Score the fit's own training cells through ``assign_cells`` on the
    card under "ignore" and "refine", each timed (host clock, after a
    synchronize) with its peak allocated bytes from a reset (the bytes
    allocated before it subtracted): accuracy against the true clones and
    agreement with the fit's calls. Then the card's unnormalized
    log-posteriors of all the cells (``serve._log_posteriors``, float32)
    against the CPU port's in float64 on SERVE_SLICE cells spread over
    every row block: each within SERVE_RTOL of its absolute-term sum
    (:func:`serve_reference`), the probabilities within SERVE_ATOL, and the
    same labels away from the threshold."""
    import torch

    from clonealign_torch import serve

    out = {}
    fit_calls = np.asarray(fit.clone)
    idx = np.linspace(0, len(Y) - 1, SERVE_SLICE).round().astype(np.int64)
    for latent in ("ignore", "refine"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        clones, probs = clonealign_torch.assign_cells(fit, Y, L, latent=latent, device="cuda")
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        index = {c: i for i, c in enumerate(fit.clone_names)}
        acc = float(np.mean(np.asarray([index.get(c, -1) for c in clones]) == z))
        served = np.asarray(clones)
        both = (fit_calls != "unassigned") & (served != "unassigned")
        agree = float(np.mean(fit_calls[both] == served[both]))
        card = serve._log_posteriors(fit, Y, L, True, 6, latent, 8, device="cuda")
        card = card[idx].double().cpu().numpy()
        want, scale = serve_reference(fit, Y[idx], L, latent)
        if not (np.isfinite(card) == np.isfinite(want)).all():
            raise AssertionError(f"serve ({latent}): the card's -inf entries differ")
        fin = np.isfinite(want)
        rel = float((np.abs(card - want)[fin] / scale[fin]).max())
        p_want = np.exp(want - want.max(1, keepdims=True))
        p_want /= p_want.sum(1, keepdims=True)
        err = float(np.abs(probs[idx] - p_want).max())
        near = np.abs(p_want.max(axis=1) - 0.95) < 0.01
        off = int(((np.argmax(p_want, 1) != np.argmax(probs[idx], 1)) & ~near).sum())
        out[latent] = dict(ms=1000 * seconds, cells_per_s=len(clones) / seconds, peak_gb=peak,
                           accuracy=acc, agreement=agree, log_rel_err=rel, prob_err=err)
        log(f"serve {FULL['N']} cells x {FULL['G']} genes x {FULL['C']} clones, latent={latent}: "
            f"{1000 * seconds:.1f} ms ({len(clones) / seconds:.4g} cells per second), peak "
            f"allocated {peak:.3f} GB; accuracy {acc:.4f}, agreement with the fit's calls "
            f"{agree:.4f}; against the CPU port in float64 on {SERVE_SLICE} cells: log-posteriors "
            f"max |diff| / absolute-term sum {rel:.3e} (tolerance {SERVE_RTOL:g}), max |dp| "
            f"{err:.3e}, {off} labels differ away from the threshold")
        if (acc < MIN_ACCURACY or agree < 0.95 or rel > SERVE_RTOL or err > SERVE_ATOL
                or off):
            raise AssertionError(f"serve ({latent}) misses its bars")
    return out


def golden_stream(clonealign_torch, fl):
    """The golden oracle's synthetic config through ``fit_streaming`` in
    chunks of GOLDEN_STREAM_CHUNK cells, monitored as the in-core golden
    fit ("fresh"), held to the same float64 oracle bar as ``golden``, after
    the kernels are held to their plain versions at its chunks' shapes;
    returns its launches, which must be its chunks' share of each pass, and
    those kernel checks."""
    from clonealign_torch import api, stream
    from clonealign_torch.synth import simulate_multinomial

    oracle = np.load(REPO / "tests" / "golden" / "tpu_parity_oracle.npz")
    sim = simulate_multinomial(N=5000, G=1000, C=4, seed=3, mean_total=2000)
    bounds = stream._chunk_bounds(5000, GOLDEN_STREAM_CHUNK)
    n_chunks = len(bounds)
    store = api._auto_y_storage(sim.Y)
    shapes = check_stream_shapes(bounds, 1000, 4, "float32" if store is None else
                                 str(store).removeprefix("torch."), seed=31)
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    fit = clonealign_torch.fit_streaming(sim.Y, sim.L, chunk_cells=GOLDEN_STREAM_CHUNK,
                                         max_iter=GOLDEN_MAX_ITER, seed=11, device="cuda",
                                         verbose=False, elbo_eval="fresh")
    ci, n = fit.convergence_info, fit.convergence_info.n_iters
    launches = launches_of(fl)
    want = {"fwd": n_chunks * (2 + 2 * n + 20), "dpsi": n_chunks * n, "gene": n_chunks * n}
    e64 = float(oracle["synth_elbo64"])
    tol = max(1e-4 * abs(e64), 3.0 * ci.sd_final_elbo)
    probs = fit.ml_params["clone_probs"]
    flips = np.flatnonzero(np.asarray(fit.clone) != oracle["synth_clone64"])
    off = [int(i) for i in flips if abs(probs[i].max() - 0.95) >= 0.01]
    log(f"golden synth streamed ({n_chunks} chunks of {GOLDEN_STREAM_CHUNK}, fresh): "
        f"{time.perf_counter() - t0:.1f} s, {n} iterations "
        f"({1000 * fit.timings['loop'] / max(n, 1):.2f} ms per iteration), final ELBO "
        f"{ci.final_elbo:.8g} +- {ci.sd_final_elbo:.3g} against the float64 oracle {e64:.8g}: "
        f"|diff| {abs(ci.final_elbo - e64):.4g}, bar {tol:.4g}; {len(flips)} labels differ from "
        f"the float64 oracle, {len(off)} away from the 0.95 threshold; launches {launches}")
    if not abs(ci.final_elbo - e64) < tol or off or launches != want:
        raise AssertionError(f"golden synth streamed misses the oracle's bar or its launches "
                             f"(expected {want})")
    return launches, shapes


def golden(clonealign_torch, fl):
    """Fit the oracle's four configurations (tests/test_tpu_hardware.py:101-116,
    172-200, 266-287) on the card in float32 and hold each to its bar (there
    :70-98): the final ELBO within max(1e-4 |e64|, 3 sd_final) of the
    float64 oracle, and labels that differ from the float64 oracle's only
    where the max probability is within 0.01 of 0.95. The synthetic config
    runs under "auto" (the exact likelihood) and under z_cheb, as the JAX
    package's hardware test pins it; the rich one (K = 2, two covariate
    columns, three Monte Carlo samples, fixed alpha: Kf = 4, S x C = 9) with
    the oracle's own x; the allele one with the oracle's own SNV data, its
    clone_probs_from_snv also held to the float32 oracle's at rtol 1e-3 /
    atol 1e-4 (there :195-198). Each exact fit's launches are counted from
    zero and checked against its iterations; returns the rich and allele
    fits' launches, by name."""
    from clonealign_torch.synth import simulate_multinomial

    oracle = np.load(REPO / "tests" / "golden" / "tpu_parity_oracle.npz")
    ex = np.load(REPO / "data" / "example_sce.npz")
    sim = simulate_multinomial(N=5000, G=1000, C=4, seed=3, mean_total=2000)
    rich = dict(x=oracle["rich_x"], K=2, mc_samples=3, fix_alpha=True)
    allele = {k: oracle[f"allele_{k}"] for k in ("clone_allele", "cov", "ref")}
    found = {}
    for name, Y, L, seed, impl, opts in (
            ("example", ex["counts"], ex["copy_number"], 7, "auto", {}),
            ("synth", sim.Y, sim.L, 11, "auto", {}),
            ("synth", sim.Y, sim.L, 11, "z_cheb", {}),
            ("rich", oracle["rich_Y"], oracle["rich_L"], 17, "auto", rich),
            ("allele", oracle["allele_Y"], oracle["allele_L"], 13, "auto", allele)):
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        fit = clonealign_torch.clonealign(Y, L, max_iter=GOLDEN_MAX_ITER, seed=seed,
                                          dtype="float32", device="cuda", verbose=False,
                                          likelihood_impl=impl, **opts)
        ci = fit.convergence_info
        launches = launches_of(fl)
        n = ci.n_iters
        if impl == "auto" and launches != {"fwd": 2 + 2 * n + 20, "dpsi": n, "gene": n}:
            raise AssertionError(f"golden {name}: launches {launches} for {n} iterations")
        e64 = float(oracle[f"{name}_elbo64"])
        tol = max(1e-4 * abs(e64), 3.0 * ci.sd_final_elbo)
        probs = fit.ml_params["clone_probs"]
        flips = np.flatnonzero(np.asarray(fit.clone) != oracle[f"{name}_clone64"])
        off = [int(i) for i in flips if abs(probs[i].max() - 0.95) >= 0.01]
        log(f"golden {name} ({impl}): {time.perf_counter() - t0:.1f} s, {ci.n_iters} iterations, "
            f"final ELBO {ci.final_elbo:.8g} +- {ci.sd_final_elbo:.3g} against the float64 "
            f"oracle {e64:.8g}: |diff| {abs(ci.final_elbo - e64):.4g}, bar {tol:.4g} "
            f"({abs(ci.final_elbo - e64) / abs(e64):.2e} relative); {len(flips)} labels differ "
            f"from the float64 oracle, {len(off)} away from the 0.95 threshold; launches {launches}")
        if not abs(ci.final_elbo - e64) < tol or off:
            raise AssertionError(f"golden {name} ({impl}) misses the oracle's bar")
        if name == "allele":
            got, want = fit.clone_probs_from_snv, oracle["allele_snv32"]
            err = np.abs(got - want)
            log(f"  clone_probs_from_snv against the float32 oracle: max |diff| {err.max():.3e}, "
                f"{int((err > 1e-4 + 1e-3 * np.abs(want)).sum())} of {err.size} outside rtol 1e-3 "
                f"/ atol 1e-4")
            if not np.allclose(got, want, rtol=1e-3, atol=1e-4):
                raise AssertionError("golden allele: clone_probs_from_snv misses the oracle")
        found[name] = launches
    return found


# ---------------------------------------------------------------------------
# The legacy v1 negative-binomial family
# ---------------------------------------------------------------------------

def model3_genes(seed, G, C):
    """The gene-level draws of the model3 spec on the card
    (benchmarks/negbin_scale.py:29-61, reference
    inst/create_model3_synthetic.R:3-29): rho ~ Bernoulli(0.9/1.1),
    mu ~ U(1, 2), beta = mu, phi ~ Gamma(4, 1), L uniform on {1..C}."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rho = (torch.rand(G, generator=gen, device="cuda") < 0.9 / 1.1).float()
    mu = 1.0 + torch.rand(G, generator=gen, device="cuda")
    phi = torch._standard_gamma(torch.full((G,), 4.0, device="cuda"), generator=gen)
    L = torch.randint(1, C + 1, (G, C), generator=gen, device="cuda").float()
    return dict(rho=rho, mu=mu, phi=phi, L=L)


def model3_cells(genes, seed, N, chunk=10_000):
    """N cells of the model3 spec on the card: clones uniform, size factors
    U(500, 10000), counts NB(mean s ((1 - rho) mu + rho beta Lp[:, pi]),
    size phi) drawn as the gamma-Poisson mixture, in chunks of cells.
    Returns Y (N, G) float32 on the card and the true clones (numpy)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rho, mu, phi, L = genes["rho"], genes["mu"], genes["phi"], genes["L"]
    G, C = L.shape
    Lp = L / L.mean(0, keepdim=True)
    pi = torch.randint(0, C, (N,), generator=gen, device="cuda")
    s = 500.0 + 9500.0 * torch.rand(N, generator=gen, device="cuda")
    Y = torch.empty(N, G, device="cuda")
    for i in range(0, N, chunk):
        j = min(i + chunk, N)
        m = s[i:j, None] * ((1 - rho) * mu + (rho * mu) * Lp[:, pi[i:j]].T)
        shape = phi.expand(j - i, G).contiguous()
        Y[i:j] = torch.poisson(torch._standard_gamma(shape, generator=gen) * (m / phi),
                               generator=gen)
    return Y, pi.cpu().numpy()


def negbin_iteration_bound(N, G, C, m_steps):
    """The least time of one exact EM iteration at N x G x C (ms), from the
    code's passes over Y: the E-step's two clone scans, ``m_steps`` M-step
    value-and-gradient passes and the monitored ELBO read Y (float32) once
    each; per element a scan takes C + 1 logs, an M-step pass C + 1 logs,
    one lgamma and one digamma, the ELBO one log and two lgammas, each
    counted as one special-function operation (a lower bound on an
    lgamma's cost). Returns (ms, "bytes" or "operations")."""
    passes = 2 + m_steps + 1
    bytes_ms = passes * N * G * 4 / HBM_BYTES_PER_S * 1e3
    sfu = N * G * (2 * (C + 1) + m_steps * (C + 3) + 3)
    ops_ms = sfu / EXP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def negbin_pass_times(fit, Y, L, reps=3):
    """Card ms of each pass of one EM iteration at full width, under the
    exact fit's rates and posterior (CUDA events around ``reps`` calls,
    after one warm-up): the E-step's A scan (float32) and B scan (float64
    elements), one M-step value-and-gradient pass, the monitored ELBO's
    netted llk0 pass; and of the Chebyshev loop's E-step products (A, and
    the gamma statistics) and one of its Adam steps' gradient."""
    import torch

    from clonealign_torch.models import negbin
    from clonealign_torch.utils.device import full_fp32_matmul

    data = negbin.prepare_negbin_data(Y, L, device="cuda", dtype=torch.float32)
    f32 = dict(dtype=torch.float32, device="cuda")
    params = negbin.NegbinParams(*(torch.log(torch.as_tensor(v, **f32))
                                   for v in (fit.mu, fit.beta, fit.phi, fit.alpha)))
    post = negbin.NegbinPosterior(torch.as_tensor(fit.clone_probs, **f32),
                                  torch.as_tensor(fit.rho_probs, **f32))
    consts = negbin._nb_constants(data)
    stats = negbin.negbin_cheb_stats(data)
    coeffs = negbin._netted_cheb_coeffs(params, data, stats)
    ps = negbin._gamma_stats(data, stats, post.gamma)
    rates = (params.log_mu, params.log_beta, params.log_phi)

    def cheb_grad():
        r = [t.detach().requires_grad_(True) for t in rates]
        with torch.enable_grad():
            p = params._replace(log_mu=r[0], log_beta=r[1], log_phi=r[2])
            obj = negbin._mstep_objective_cheb(p, data, stats, ps, post.r, 1.0, consts)
            return torch.autograd.grad(obj, r)

    passes = {
        "exact E-step A scan": lambda: negbin._scan(params, data, gene_w=post.r),
        "exact E-step B scan (float64)": lambda: negbin._scan(params, data, cell_w=post.gamma,
                                                              dtype=torch.float64),
        "exact M-step value and gradient": lambda: negbin._mstep_value_and_grad(
            rates, data, post, 1.0, consts),
        "exact ELBO netted llk0 (float64)": lambda: negbin._llk0_netted_sum(params, data),
        "cheb E-step A product": lambda: negbin._estep_A_cheb(data, stats, coeffs, post.r),
        "cheb E-step gamma statistics": lambda: negbin._gamma_stats(data, stats, post.gamma),
        "cheb M-step gradient (one Adam step's)": cheb_grad,
    }
    out = {}
    with full_fp32_matmul():
        for name, fn in passes.items():
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize()
            out[name] = dict(event_ms=start.elapsed_time(end) / reps,
                             host_ms=1000 * (time.perf_counter() - t0) / reps,
                             busy_ms=device_busy_ms(fn))
    log("negbin passes at full width, a call: stream ms between CUDA events / host ms / "
        "kernel ms (torch.profiler; the rest of the stream time is the card idle): " + "; ".join(
            f"{k} {v['event_ms']:.2f} / {v['host_ms']:.2f} / "
            + ("not measured" if v["busy_ms"] is None else f"{v['busy_ms']:.2f}")
            for k, v in out.items()))
    return out


def device_busy_ms(fn):
    """The summed device time of the kernels (and copies) one call of
    ``fn`` runs, from ``torch.profiler``'s device events alone (an
    operator's own entry repeats its kernels' time), or None where the
    profiler records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1000 if total > 0 else None


def negbin_serve_reference(fit, Y, L):
    """The CPU port's float64 log-posteriors log alpha_c + A[n, c] of the
    cells ``Y`` (``models/negbin._log_posteriors``) and per (cell, clone)
    the sum of the absolute values of their terms: |log alpha_c| + sum_g
    r_g (|(y + phi) log(phi + m0)| + |(y + phi) log(phi + m1_c)| + |y q_c|),
    the scale of the tolerance."""
    import torch

    from clonealign_torch.models import negbin

    Yf = np.asarray(Y, np.float64)
    want = negbin._log_posteriors(fit, Yf, L, device="cpu", dtype=torch.float64)
    s = Yf.sum(1) / fit.s_mean
    Lp = L / L.mean(0, keepdims=True)
    phi, mu, beta, r = fit.phi, fit.mu, fit.beta, fit.rho_probs
    Yp = Yf + phi
    base = np.abs(Yp * np.log(phi + s[:, None] * mu)) @ r
    scale = np.empty_like(want.numpy())
    for c in range(L.shape[1]):
        q = np.log(beta * Lp[:, c]) - np.log(mu)
        pm1 = np.abs(Yp * np.log(phi + s[:, None] * (beta * Lp[:, c])))
        scale[:, c] = np.abs(np.log(fit.alpha[c])) + base + (pm1 + np.abs(Yf * q)) @ r
    return want.numpy(), scale


def negbin_phase(clonealign_torch, fl):
    """The v1 family on the card at benchmarks/negbin_scale.py's width
    (100,000 cells x 2,000 genes x 4 clones, Y float32, made on the card):
    ``inference_em`` exact (m_steps 5) and Chebyshev (m_steps 30), one each
    (a second turn of both would add ~60 s to the script's 1,000),
    NEGBIN_MAX_ITER iterations at rel_tol 1e-6; ``gibbs_pi_rho`` under the
    exact fit's rates; ``classify_cells`` of 100,000 fresh cells of the same
    genes, its log-posteriors on NEGBIN_SERVE_SLICE of them held to the CPU
    port's in float64; and the JAX package's golden pin in float32. No
    fused-likelihood kernel may launch. Returns the numbers it prints."""
    import torch

    from clonealign_torch.models import negbin

    N, G, C = NEGBIN["N"], NEGBIN["G"], NEGBIN["C"]
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    genes = model3_genes(41, G, C)
    Y, z = model3_cells(genes, 42, N)
    L = genes["L"].cpu().numpy().astype(np.float64)
    rho_true = genes["rho"].cpu().numpy() > 0.5
    torch.cuda.synchronize()
    log(f"negbin: model3 counts {N}x{G}x{C} float32 on the card ({Y.numel() * 4 / 1e9:.2f} GB, "
        f"largest {float(Y.max()):.0f}): {time.perf_counter() - t0:.1f} s")
    bound_ms, bound_by = negbin_iteration_bound(N, G, C, 5)
    fits, out = {}, {"exact": [], "cheb": []}
    for impl in ("exact", "cheb"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fit = clonealign_torch.inference_em(Y, L, max_iter=NEGBIN_MAX_ITER, rel_tol=1e-6,
                                            likelihood_impl=impl, verbose=False, device="cuda")
        peak = (torch.cuda.max_memory_allocated() - before) / 1e9
        n = fit.n_iter
        acc = float(np.mean(np.argmax(fit.clone_probs, 1) == z))
        rho_acc = float(np.mean((fit.rho_probs > 0.5) == rho_true))
        finite = bool(np.isfinite(fit.elbo_trace).all() and np.isfinite(fit.final_elbo))
        row = dict(iterations=n, s_per_iter=fit.timings["loop"] / max(n, 1),
                   setup_s=fit.timings["setup"], accuracy=acc, rho_accuracy=rho_acc,
                   peak_gb=peak, final_elbo=fit.final_elbo)
        out[impl].append(row)
        fits[impl] = fit
        log(f"negbin inference_em {impl}: {n} iterations, {row['s_per_iter']:.4f} s per iteration "
            f"({fit.timings['loop']:.2f} s loop), setup {row['setup_s']:.2f} s, clone accuracy "
            f"{acc:.4f}, rho accuracy {rho_acc:.4f}, final ELBO {fit.final_elbo:.9g}, peak "
            f"allocated {peak:.3f} GB above the resident Y ({Y.numel() * 4 / 1e9:.2f} GB)"
            + (f"; bound {bound_ms:.3f} ms an iteration by {bound_by}" if impl == "exact" else ""))
        if acc < MIN_ACCURACY or not finite:
            raise AssertionError(f"negbin {impl}: accuracy {acc:.4f}, finite trace {finite}")
    fe, fc = fits["exact"], fits["cheb"]
    pass_ms = negbin_pass_times(fe, Y, L)
    agree = float(np.mean(np.argmax(fe.clone_probs, 1) == np.argmax(fc.clone_probs, 1)))
    rel = abs(fc.final_elbo - fe.final_elbo) / abs(fe.final_elbo)
    log(f"negbin cheb against exact: labels agree {agree:.4f}, final (exact-evaluated) ELBOs "
        f"{rel:.3e} relative")
    if agree < 0.99 or rel > 1e-3:
        raise AssertionError("negbin: the Chebyshev fit departs from the exact fit")

    # Gibbs under the exact fit's rates
    params = negbin.NegbinParams(log_mu=np.log(fe.mu), log_beta=np.log(fe.beta),
                                 log_phi=np.log(fe.phi), alpha_logits=np.log(fe.alpha))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traces = clonealign_torch.gibbs_pi_rho(Y, L, params=params, n_iter=NEGBIN_GIBBS_SWEEPS,
                                           seed=0, device="cuda")
    gibbs_s = time.perf_counter() - t0
    probs = clonealign_torch.clone_probs_from_gibbs(traces["pi_trace"], C)
    gibbs_acc = float(np.mean(np.argmax(probs, 1) == z))
    rho_gibbs = clonealign_torch.rho_probs_from_gibbs(traces["rho_trace"])
    log(f"negbin gibbs_pi_rho: {NEGBIN_GIBBS_SWEEPS} sweeps in {gibbs_s:.2f} s, clone accuracy "
        f"{gibbs_acc:.4f}, rho accuracy "
        f"{float(np.mean((rho_gibbs[:, 1] > 0.5) == rho_true)):.4f}")
    if gibbs_acc < MIN_ACCURACY:
        raise AssertionError("negbin gibbs: accuracy below the bar")

    # serving: fresh cells of the same genes
    del Y
    Y2, z2 = model3_cells(genes, 43, N)
    negbin.classify_cells(fe, Y2[:1000], L, device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clones, probs = negbin.classify_cells(fe, Y2, L, device="cuda")
    serve_s = time.perf_counter() - t0
    serve_acc = float(np.mean(np.argmax(probs, 1) == z2))
    idx = np.linspace(0, N - 1, SERVE_SLICE).round().astype(np.int64)
    card = negbin._log_posteriors(fe, Y2, L, device=torch.device("cuda"), dtype=torch.float32)
    rows = torch.as_tensor(idx, device="cuda")
    card = card[rows].double().cpu().numpy()
    want, scale = negbin_serve_reference(fe, Y2[rows].cpu().numpy(), L)
    serve_rel = float((np.abs(card - want) / scale).max())
    log(f"negbin classify_cells {N} fresh cells: {1000 * serve_s:.1f} ms ({N / serve_s:.4g} cells "
        f"per second), accuracy {serve_acc:.4f}; log-posteriors against the CPU port in float64 "
        f"on {SERVE_SLICE} cells: max |diff| / absolute-term sum {serve_rel:.3e} (tolerance "
        f"{SERVE_RTOL:g})")
    if serve_acc < MIN_ACCURACY or serve_rel > SERVE_RTOL:
        raise AssertionError("negbin classify_cells misses its bars")
    del Y2

    # the JAX package's golden pin, in float32
    from clonealign_torch.synth import simulate_model3

    sim = simulate_model3(N=100, G=60, C=3, seed=99)
    data = negbin.prepare_negbin_data(sim.Y, sim.L, device="cuda", dtype=torch.float32)
    pin = negbin.run_negbin_em(data, max_iter=30, rel_tol=0.0)
    rel0 = abs(pin.elbo_trace[0] - NEGBIN_PIN[0]) / abs(NEGBIN_PIN[0])
    relf = abs(pin.final_elbo - NEGBIN_PIN[1]) / abs(NEGBIN_PIN[1])
    log(f"negbin golden pin (float32): iteration 0 {pin.elbo_trace[0]:.9g} ({rel0:.2e} relative, "
        f"bar 1e-5), final {pin.final_elbo:.9g} ({relf:.2e} relative, bar 1e-3)")
    if not (rel0 <= 1e-5 and relf <= 1e-3):
        raise AssertionError("negbin golden pin missed")
    launches = launches_of(fl)
    if any(launches.values()):
        raise AssertionError(f"negbin: the fused-likelihood kernels launched {launches}")
    return dict(fits=out, pass_ms=pass_ms, bound_ms=bound_ms, bound_by=bound_by, gibbs_s=gibbs_s,
                gibbs_accuracy=gibbs_acc, serve_ms=1000 * serve_s, serve_accuracy=serve_acc,
                serve_log_rel_err=serve_rel, pin=(float(pin.elbo_trace[0]), pin.final_elbo),
                exact={"labels": np.argmax(fe.clone_probs, 1), "final_elbo": fe.final_elbo,
                       "rho": fe.rho_probs > 0.5, "iterations": fe.n_iter})


# ---------------------------------------------------------------------------
# The command line and its file formats
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def phase_clock(*targets):
    """Wrap each (owner, attribute, label) function for the block: each call
    adds its wall seconds, read after a synchronize, to ``clock[label]``
    and leaves its result in ``results[label]``. Yields (clock, results)."""
    import torch

    clock, results, saved = {}, {}, []
    for owner, name, label in targets:
        fn = getattr(owner, name)

        def wrapped(*args, _fn=fn, _label=label, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            torch.cuda.synchronize()
            clock[_label] = clock.get(_label, 0.0) + time.perf_counter() - t0
            results[_label] = out
            return out

        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)
    try:
        yield clock, results
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def cli_run(argv):
    """``clonealign_torch.__main__.main(argv)`` in this process; raises on a
    nonzero exit."""
    from clonealign_torch.__main__ import main as cli_main

    rc = cli_main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"python -m clonealign_torch {' '.join(map(str, argv))}: rc {rc}")


def write_cellranger_mtx(path, Y):
    """Y (cells x genes) as CellRanger writes its matrix: gene-major,
    integer coordinate format, gzip level 1."""
    genes, cells = np.nonzero(Y.T)
    vals = Y.T[genes, cells]
    with gzip.open(path, "wt", compresslevel=1) as fh:
        fh.write("%%MatrixMarket matrix coordinate integer general\n%\n")
        fh.write(f"{Y.shape[1]} {Y.shape[0]} {len(vals)}\n")
        fh.write("\n".join(f"{g} {c} {v}" for g, c, v in
                           zip((genes + 1).tolist(), (cells + 1).tolist(), vals.tolist())))
        fh.write("\n")


def same_fit_payload(back, fit):
    """Whether the fit read back from ``.rds`` equals the in-memory fit:
    labels, names, retained genes and the sweep's record exactly, the clone
    probabilities, correlations and the ELBO trace in float64."""
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    mr, mb = fit.multirun_info, back.multirun_info
    ci, cb = fit.convergence_info, back.convergence_info
    return {
        "clone": back.clone == list(fit.clone),
        "clone_names": back.clone_names == list(fit.clone_names),
        "retained_genes": back.retained_genes == [str(g) for g in fit.retained_genes],
        "multirun_info": (sorted(mb) == sorted(mr) and mb["best_run"] == mr["best_run"]
                          and mb["clone_prevalences_at_different_shrinks"]
                          == mr["clone_prevalences_at_different_shrinks"]
                          and all(np.array_equal(f64(mb[k]), f64(mr[k]), equal_nan=True)
                                  for k in ("elbos", "median_correlations", "initial_shrinks"))),
        "clone_probs": np.array_equal(back.ml_params["clone_probs"],
                                      f64(fit.ml_params["clone_probs"])),
        "correlations": np.array_equal(back.correlations, f64(fit.correlations), equal_nan=True),
        "elbo_trace": (np.array_equal(cb.elbo, f64(ci.elbo))
                       and (cb.final_elbo, cb.sd_final_elbo, cb.n_iters)
                       == (ci.final_elbo, ci.sd_final_elbo, ci.n_iters)),
    }


def cli_phase(clonealign_torch, fl):
    """The command line at full width, its inputs and outputs in a temporary
    directory: (a) ``fit --restarts 10`` from an uncompressed ``.npz`` of
    bench.py's counts and a CSV to an ``.rds``, in turns with the library
    sweep it stands for (labels, best run, final ELBO bar, accuracy, equal
    launches), each phase's wall time beside the library call's; (b) the
    ``.rds`` read back against the in-memory sweep; (c) ``assign`` of the
    100,000 cells from the ``.rds`` against ``assign_cells``; (d) a
    CellRanger ``.mtx.gz`` of 2,000 cells through ``fit`` (against
    ``clonealign``) and through ``fit --model negbin-v1`` and ``assign``
    (against ``classify_cells``); (e) ``info``, ``show`` and the imports in
    fresh interpreters. Returns the launches of the CLI's fits."""
    import torch

    import clonealign_torch.__main__ as cli
    from clonealign_torch import serve
    from clonealign_torch.io import mtx
    from clonealign_torch.models import negbin

    N, G, C = FULL["N"], FULL["G"], FULL["C"]
    names = [chr(ord("A") + k) for k in range(C)]
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        Y, L, z = synth_counts(3, N, G, C)
        t0 = time.perf_counter()
        np.savez(d / "counts.npz", counts=Y, gene_names=np.asarray([f"g{j}" for j in range(G)]))
        with open(d / "cnv.csv", "w") as fh:
            fh.write("gene," + ",".join(names) + "\n")
            fh.writelines(f"g{j}," + ",".join(str(int(v)) for v in row) + "\n"
                          for j, row in enumerate(L))
        log(f"cli: wrote counts.npz ({(d / 'counts.npz').stat().st_size / 1e9:.3f} GB, int16, "
            f"uncompressed) and cnv.csv in {time.perf_counter() - t0:.2f} s")

        # (a) the ten-restart sweep through the command line, in turns with
        # the library call it stands for
        fit_argv = ["fit", "--counts", d / "counts.npz", "--cnv", d / "cnv.csv", "--restarts",
                    10, "--max-iter", 100, "--seed", 0, "--out", d / "fit.rds", "--quiet"]
        cnv = dict(zip(names, L.T))
        turns = []
        for kind in ("cli", "library", "library", "cli"):
            fl.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "cli":
                with phase_clock((cli, "_load_counts", "read counts"),
                                 (cli, "_load_cnv", "read cnv"),
                                 (clonealign_torch, "run_clonealign", "sweep"),
                                 (cli, "_save_fit", "write rds")) as (clock, results):
                    cli_run(fit_argv)
                fit = results["sweep"]
            else:
                fit = clonealign_torch.run_clonealign(
                    Y, cnv, initial_shrinks=(5,), n_repeats=10, max_iter=100, seed=0,
                    rel_tol=1e-6, learning_rate=0.1, clone_call_probability=0.95,
                    verbose=False, print_elbos=False, device="cuda")
                clock = {}
            wall = time.perf_counter() - t0
            launches = launches_of(fl)
            ci = fit.convergence_info
            turns.append(dict(kind=kind, fit=fit, wall=wall, clock=clock, launches=launches))
            log(f"cli ({kind}) fit --restarts 10 {N}x{G}x{C}: {wall:.2f} s"
                + (" (" + ", ".join(f"{k} {v:.3f} s" for k, v in clock.items()) + ")"
                   if clock else "")
                + f"; best run {fit.multirun_info['best_run']}, final ELBO {ci.final_elbo:.9g} "
                f"(sd {ci.sd_final_elbo:.4g}), accuracy {accuracy(fit, z):.4f}, "
                f"iterations {fit.timings['iterations']}, launches {launches}")
        ref = turns[1]
        for t in turns:
            f, r = t["fit"], ref["fit"]
            diff = abs(f.convergence_info.final_elbo - r.convergence_info.final_elbo)
            bar = max(1e-6 * abs(r.convergence_info.final_elbo),
                      3.0 * f.convergence_info.sd_final_elbo)
            if (f.clone != r.clone or f.multirun_info["best_run"] != r.multirun_info["best_run"]
                    or diff > bar or accuracy(f, z) < MIN_ACCURACY
                    or t["launches"] != ref["launches"]):
                raise AssertionError(f"cli ({t['kind']}): the sweep departs from the library's "
                                     f"(final ELBO |diff| {diff:.6g}, bar {bar:.6g})")
        log("cli sweep against the library sweep: labels identical, best run, final ELBO within "
            "max(1e-6 |ELBO|, 3 sd), launches equal; wall " + " / ".join(
                f"{t['kind']} {t['wall']:.2f}" for t in turns) + " s")

        # (b) the .rds read back
        t0 = time.perf_counter()
        back = clonealign_torch.ClonealignFit.load_rds(str(d / "fit.rds"))
        read_s = time.perf_counter() - t0
        same = same_fit_payload(back, turns[3]["fit"])
        log(f"cli: fit.rds {(d / 'fit.rds').stat().st_size / 1e6:.2f} MB, written in "
            f"{turns[3]['clock']['write rds']:.3f} s, read back in {read_s:.3f} s; equal to the "
            f"in-memory sweep: {same}")
        if not all(same.values()):
            raise AssertionError("cli: the .rds round trip lost part of the fit")

        # (c) serving from the saved fit, through the command line
        with phase_clock((cli, "_load_counts", "read counts"),
                         (serve, "assign_cells", "assign_cells")) as (clock, _):
            t0 = time.perf_counter()
            cli_run(["assign", "--fit", d / "fit.rds", "--counts", d / "counts.npz", "--cnv",
                     d / "cnv.csv", "--out", d / "assigned.npz", "--quiet"])
            wall = time.perf_counter() - t0
        served = np.load(d / "assigned.npz")
        clones, probs = clonealign_torch.assign_cells(back, Y, L, device="cuda")
        err = float(np.abs(served["clone_probs"] - probs).max())
        calls, fit_calls = np.asarray(served["clone"]).astype(str), np.asarray(back.clone)
        both = (calls != "unassigned") & (fit_calls != "unassigned")
        agree = float(np.mean(calls[both] == fit_calls[both]))
        ms = 1000 * clock["assign_cells"]
        log(f"cli assign --latent auto (refine at K=1) {N} cells: {wall:.2f} s in all "
            f"(reading counts {clock['read counts']:.3f} s), assign_cells {ms:.1f} ms "
            f"({N / clock['assign_cells']:.4g} cells per second); clone_probs max |diff| "
            f"against assign_cells {err:.3e} (bar 1e-6), agreement with the fit {agree:.4f}")
        if err > 1e-6 or agree < 0.95 or list(calls) != list(clones):
            raise AssertionError("cli assign departs from assign_cells or from the fit")
        del served

        # (d) the mtx path: the first 2,000 cells as CellRanger writes them
        n_mtx = 2_000
        t0 = time.perf_counter()
        write_cellranger_mtx(d / "matrix.mtx.gz", Y[:n_mtx])
        write_s = time.perf_counter() - t0
        reader = "native" if mtx._load_native() is not None else "fallback (pure python)"
        fl.reset_launch_counts()
        with phase_clock((cli, "_load_counts", "read counts")) as (clock, results):
            cli_run(["fit", "--counts", d / "matrix.mtx.gz", "--cnv", d / "cnv.csv",
                     "--transpose", "--max-iter", 100, "--seed", 0, "--out", d / "mtx.npz",
                     "--quiet"])
        mtx_launches = launches_of(fl)
        Y_rows = scipy.sparse.csr_matrix(Y[:n_mtx].astype(np.float64))
        got = clonealign_torch.ClonealignFit.load(str(d / "mtx.npz"))
        want = clonealign_torch.clonealign(Y_rows, cnv, max_iter=100, seed=0, verbose=False,
                                           device="cuda")
        log(f"cli mtx: matrix.mtx.gz {n_mtx}x{G} written in {write_s:.2f} s "
            f"({(d / 'matrix.mtx.gz').stat().st_size / 1e6:.1f} MB), read by the {reader} reader "
            f"in {clock['read counts']:.3f} s; fit --transpose labels "
            f"{'equal' if got.clone == want.clone else 'DIFFER'} to clonealign's, accuracy "
            f"{accuracy(got, z[:n_mtx]):.4f}, launches {mtx_launches}")
        if got.clone != want.clone or accuracy(got, z[:n_mtx]) < MIN_ACCURACY:
            raise AssertionError("cli mtx fit departs from clonealign")
        t0 = time.perf_counter()
        cli_run(["fit", "--counts", d / "matrix.mtx.gz", "--cnv", d / "cnv.csv", "--transpose",
                 "--model", "negbin-v1", "--likelihood-impl", "cheb", "--max-iter", 20,
                 "--out", d / "v1.npz", "--quiet"])
        cli_run(["assign", "--fit", d / "v1.npz", "--counts", d / "matrix.mtx.gz", "--cnv",
                 d / "cnv.csv", "--transpose", "--out", d / "v1_assigned.npz", "--quiet"])
        v1_s = time.perf_counter() - t0
        v1 = clonealign_torch.ClonealignV1Fit.load(str(d / "v1.npz"))
        v1_clones, _ = negbin.classify_cells(v1, Y_rows, L, device="cuda")
        v1_served = [str(c) for c in np.load(d / "v1_assigned.npz")["clone"]]
        log(f"cli negbin-v1 cheb fit ({v1.n_iter} iterations) and assign: {v1_s:.2f} s; assign's "
            f"labels {'equal' if v1_served == list(v1_clones) else 'DIFFER'} to classify_cells'")
        if v1_served != list(v1_clones):
            raise AssertionError("cli assign of a v1 fit departs from classify_cells")
        del Y, Y_rows

        # (e) the module entry in fresh interpreters, all three at once
        code = ("import sys\n"
                "import clonealign_torch.__main__, clonealign_torch.cnv, clonealign_torch.plot\n"
                "import clonealign_torch.io.rds, clonealign_torch.io.mtx, clonealign_torch.io.h5\n"
                "import clonealign_torch.io.datasets, clonealign_torch.utils.profiling\n"
                "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
                "'jaxlib', 'clonealign_tpu'))))\n")
        commands = {"info": ["-m", "clonealign_torch", "info"],
                    "show": ["-m", "clonealign_torch", "show", str(d / "fit.rds")],
                    "imports": ["-c", code]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen([sys.executable, *argv], cwd=REPO, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, argv in commands.items()}
        outs = {}
        try:
            for k, proc in procs.items():
                out, err = proc.communicate(timeout=120)
                if proc.returncode != 0:
                    raise AssertionError(f"cli {k} in a fresh interpreter: rc {proc.returncode}"
                                         f"\n{err}")
                outs[k] = out
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        shown = json.loads(outs["show"][outs["show"].index("{"):])
        log(f"cli in fresh interpreters ({time.perf_counter() - t0:.1f} s): info says "
            + "; ".join(outs["info"].strip().splitlines())
            + f"; show's keys {sorted(shown)}; jax modules after the imports "
            + outs["imports"].strip())
        if not {"clone_counts", "final_elbo"} <= set(shown) or outs["imports"].strip() != "[]":
            raise AssertionError("cli show lacks its keys, or an import loaded jax")
    log(f"cli phase: {time.perf_counter() - t_phase:.1f} s")
    return turns[3]["launches"], mtx_launches


# ---------------------------------------------------------------------------
# The wide kernel family
# ---------------------------------------------------------------------------

def wide_covariates(N, seed):
    """WIDE_P covariate columns made with numpy: a 0/1 batch over halves of
    the cells, then standard normals."""
    rng = np.random.default_rng(seed)
    return np.stack([(np.arange(N) >= N // 2).astype(np.float64)]
                    + [rng.standard_normal(N) for _ in range(WIDE_P - 1)], axis=1)


class NumpyNoise:
    """A fit's standard normals from one numpy generator, in call order, in
    the caller's dtype on its device: a fit on the card and one on the CPU
    that make the same calls draw the same numbers."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def normal(self, what, shape, dtype, device):
        import torch

        del what
        return torch.from_numpy(self.rng.standard_normal(tuple(shape))).to(device, dtype)


def parity_fit(clonealign_torch, fl):
    """PARITY's fit on the card (float32, the wide family: Kf = 6, S*C = 72)
    against the CPU port's in float64 from the same numpy draws, both run
    for PARITY_MAX_ITER iterations (rel_tol 0, so that they make the same
    draws): the golden fits' bar, the final ELBO within max(1e-4 |e64|,
    3 sd_final), and the labels equal wherever the float64 fit's largest
    probability exceeds 0.99. Returns the card fit's launches."""
    N, G, C = PARITY["N"], PARITY["G"], PARITY["C"]
    Y, L, z = synth_counts(41, N, G, C)
    X = wide_covariates(N, seed=42)
    kw = dict(x=X, K=PARITY["K"], mc_samples=PARITY["mc_samples"], max_iter=PARITY_MAX_ITER,
              rel_tol=0.0, verbose=False)
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    fit = clonealign_torch.clonealign(Y, L, device="cuda", dtype="float32",
                                      noise=NumpyNoise(43), **kw)
    t1 = time.perf_counter()
    launches = launches_of(fl, "wide")
    ref = clonealign_torch.clonealign(Y, L, device="cpu", dtype="float64",
                                      noise=NumpyNoise(43), **kw)
    t2 = time.perf_counter()
    n = fit.convergence_info.n_iters
    e32, e64 = fit.convergence_info.final_elbo, ref.convergence_info.final_elbo
    tol = max(1e-4 * abs(e64), 3.0 * fit.convergence_info.sd_final_elbo)
    sure = ref.ml_params["clone_probs"].max(1) > 0.99
    differ = int(np.sum((np.asarray(fit.clone) != np.asarray(ref.clone)) & sure))
    log(f"parity fit {N}x{G}x{C} K={PARITY['K']} P={PARITY['P']} "
        f"mc_samples={PARITY['mc_samples']} (Kf={PARITY['K'] + PARITY['P']}, "
        f"S*C={PARITY['mc_samples'] * C}): card float32 {t1 - t0:.1f} s, CPU float64 "
        f"{t2 - t1:.1f} s, {n} iterations; final ELBO {e32:.8g} against {e64:.8g}: |diff| "
        f"{abs(e32 - e64):.4g}, bar {tol:.4g}; {differ} labels differ where the float64 fit's "
        f"largest probability exceeds 0.99 ({int(sure.sum())} cells); accuracy "
        f"{accuracy(fit, z):.4f} (float64 {accuracy(ref, z):.4f}); launches (wide) {launches}")
    want = {"fwd": 2 + 2 * n + 20, "dpsi": n, "gene": n, "split": 0}
    if not abs(e32 - e64) < tol or differ or launches != want:
        raise AssertionError(f"parity fit: |diff| {abs(e32 - e64)} (bar {tol}), {differ} "
                             f"labels differ, launches {launches} (expected {want})")
    return launches


# (Kf, n_a2, S*C) past WIDE_FULL whose plans wide_resources also holds to
# two blocks an SM at full width: the widest [psi, X] at the fit's S*C
# (not checked against plain there: the plain dpsi forms an (N, Kf, G)
# product, 119 GiB at full width), and every bound at once
WIDE_RESOURCE_WIDTHS = ((64, 0, 80), (64, 64, 2048))


def wide_resources(fl, storage, Kf, SC, n_a2=0, min_blocks=2):
    """The wide forward's, dpsi's and gene part's instantiations at full
    width for these widths (Y in ``storage``) under ``fl.wide_plan``'s plan, as the
    library lays them out (``fl_wide_resources``): each kernel's registers
    and spill bytes (ptxas), dynamic shared memory and blocks an SM (the
    occupancy query); past the old bound the split forward's rfe kernel
    (``fwd``: dlog_rfe_kernel<0, 2>, whose Z product is ``dpsi``'s kernel)
    and the split backward's kernels
    (``gene``: dlog_rfe_kernel with Y, ``dpsi``: dpsi_product_kernel, and
    the gene part's products, dlog mu's product and dpsi's dlog_rfe_kernel
    without Y); raises unless each runs at least ``min_blocks`` blocks an
    SM (two up to the old bound of Kf, S 64 and S*C 2,048; one past it),
    spill-free."""
    import ctypes

    import torch

    from clonealign_torch.ops import _build

    lib = _build.load()
    code = fl.Y_DTYPES[getattr(torch, storage)]
    plan = fl.wide_plan(FULL["N"], FULL["G"], Kf, n_a2, SC)
    out = (ctypes.c_int * 16)()
    err = lib.fl_wide_resources(fl._plan_arg(plan), FULL["N"], FULL["G"], Kf, n_a2, SC, code,
                                out)
    if err:
        raise AssertionError(f"the library refuses wide_plan's plan {plan} (CUDA error {err})")
    parts = [("fwd", 0, "dlog_rfe_kernel", "<0,2>") if plan["split"] else
             ("fwd", 0, "fwd_wide_kernel", f"<{plan['zt_group']},{out[8]}>"),
             ("fwd_y", 2, "fwd_wide_y_kernel", f"<{code},{plan['ny_pad']}>")]
    if plan["split"]:
        parts += [("gene", 4, "dlog_rfe_kernel", f"<{code},1>"),
                  ("dpsi", 6, "dpsi_product_kernel", "<>"),
                  ("gene_products", 10, "gene_product_kernel", "<0,0>"),
                  ("dlog_mu_product", 12, "gene_product_kernel", f"<{code},1>"),
                  ("dpsi_dlog_rfe", 14, "dlog_rfe_kernel", "<0,0>")]
    else:
        parts += [("gene", 4, "gene_wide_kernel", f"<{code},{plan['nj']}>"),
                  ("dpsi", 6, "dpsi_wide_kernel", f"<{plan['dk_pad']},{plan['dz_group']}>")]
    res = {}
    for part, i, kernel, args in parts:
        regs, spill_st, spill_ld = kernel_resources(_build.build_log, kernel)[args]
        res[part] = {"instantiation": kernel + args, "registers": regs,
                     "spill_bytes": spill_st + spill_ld, "smem_bytes": out[i],
                     "blocks_per_sm": out[i + 1]}
        if part == "dpsi" and not plan["split"]:
            res[part]["k_steps_a_stage"] = out[9]
        if out[i + 1] < min_blocks or spill_st or spill_ld:
            raise AssertionError(f"{kernel} at Y {storage}, Kf={Kf}, S={n_a2}, S*C={SC}: "
                                 f"{res[part]}")
    return res


def wide_stream(clonealign_torch, fl, Y, L, z, X, core):
    """The full-width wide fit (K = 1, P = 4, mc_samples = 8, "auto"
    storage, "fresh" as the in-core fit) streamed through ``fit_streaming``
    in the feeder's "auto" chunks, held to ``core``, full_fit's numbers of
    the in-core fit on the same data and seed: the same iterations and
    labels, the final ELBO within max(1e-4 |ELBO|, 3 sd_final) (the narrow
    streamed = in-core bar), every launch wide, forwards chunks x (2 + 2 n
    + 20) and dpsi = gene = chunks x n, and the card's peak over the call
    (from a reset with the data on the host) below Y's bytes at int8."""
    import torch

    from clonealign_torch import stream

    n_chunks = len(stream._chunk_bounds(FULL["N"], stream._resolve_chunk_cells(
        "auto", FULL["N"], FULL["G"])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    fit = clonealign_torch.fit_streaming(
        Y, L, x=X, mc_samples=WIDE_S, chunk_cells="auto", device="cuda", max_iter=FIT_MAX_ITER,
        seed=0, verbose=False, elbo_eval="fresh", likelihood_impl="xla", y_storage="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    launches = launches_of(fl, "wide")
    ci, tm, n = fit.convergence_info, fit.timings, fit.convergence_info.n_iters
    acc = accuracy(fit, z)
    want = {"fwd": n_chunks * (2 + 2 * n + 20), "dpsi": n_chunks * n, "gene": n_chunks * n,
            "split": 0}
    diff = abs(ci.final_elbo - core["final_elbo"])
    bar = max(1e-4 * abs(core["final_elbo"]), 3.0 * ci.sd_final_elbo)
    same = fit.clone == core["labels"]
    y_int8_gb = FULL["N"] * FULL["G"] / 1e9
    out = {"iter_ms": 1000 * tm["loop"] / max(n, 1), "n_iters": n, "launches": launches,
           "peak_gb": peak, "n_chunks": n_chunks}
    log(f"wide streaming fit {FULL['N']}x{FULL['G']}x{FULL['C']} auto K=1 P={WIDE_P} "
        f"mc_samples={WIDE_S} ({n_chunks} chunks, fresh): {wall:.2f} s wall (setup "
        f"{tm['setup']:.2f}, init {tm['init']:.2f}, inference {tm['inference']:.2f} s), {n} "
        f"iterations, {out['iter_ms']:.2f} ms per iteration against in-core "
        f"{core['iter_ms']:.2f}; final ELBO {ci.final_elbo:.9g} against {core['final_elbo']:.9g}: "
        f"|diff| {diff:.6g} (bar {bar:.6g}), labels {'identical' if same else 'DIFFER'}, "
        f"iterations {n} / {core['n_iters']}; accuracy {acc:.4f}; launches (wide) {launches}; "
        f"peak allocated over the call {peak:.3f} GB against Y's {y_int8_gb:.3f} GB at int8")
    check_trace(ci.elbo)
    if not (same and diff <= bar and n == core["n_iters"]) or acc < MIN_ACCURACY:
        raise AssertionError("the streamed wide fit differs from the in-core wide fit")
    if launches != want:
        raise AssertionError(f"streamed wide fit: launches {launches}, expected {want}")
    if not peak < y_int8_gb:
        raise AssertionError("the streamed wide fit held Y's bytes on the card")
    return out


# ---------------------------------------------------------------------------
# Past the old bound: K + P > 64, mc_samples > 64, S*C > 2,048
# ---------------------------------------------------------------------------

# Kernel checks at shapes that cross each old bound alone, (shape, S, Kf):
# Kf 72 (dpsi's and dW's column groups), S 66 (the Y products' column
# groups, dlog mu's pass of its own) and S*C 2,178 (S 33 x C 66)
PAST_CHECKS = ((dict(N=1_000, G=515, C=3), 2, 72), (dict(N=1_000, G=515, C=1), 66, 1),
               (dict(N=2_100, G=200, C=66), 33, 1))
# The full-width fit past the bound: K 2 and a one-hot of 70 batches over
# the cells (Kf 72), mc_samples 66 (S*C 660 at FULL's 10 clones)
PAST_K, PAST_BATCHES, PAST_S = 2, 70, 66
# ... its ms an iteration with the grouped kernels the split backward
# replaced and with the grouped forward the split forward replaced, and
# that forward's and the float64 grouped gene part's times at full width,
# int8, Kf 72, S*C 660 (PERF.md, H100 80GB HBM3 at 700 W), printed beside
# this run's; and the gene part's small past-bound shape, timed beside the
# plain backward: (shape, S, Kf)
PAST_GROUPED_ITER_MS = "424.5-426.4"
PAST_GROUPED_FWD_ITER_MS = "136.6-137.7"
PAST_GROUPED_FWD_MS = "42.67-43.5"
PAST_F64_GROUPED_GENE_MS = "1066.8-1074.8"
# ... and the float64 forward's and dpsi's grouped forms (PR 22), which the
# split ones replaced, at the same widths (PERF.md, H100 80GB HBM3 at 700 W)
PAST_F64_GROUPED_FWD_MS = "114.2-116.1"
PAST_F64_GROUPED_DPSI_MS = "162.6-164.0"
PAST_SMALL = (dict(N=2_100, G=200, C=66), 33, 1)
# The float64 fit past every bound at once (Kf 72, S 66, S*C 2,178: C 33),
# numpy counts, on the card against the CPU port from the same draws; and
# the full-width float64 fit past the bound (the float32 one's widths),
# PAST_F64_FULL_ITER iterations
PAST_F64 = dict(N=600, G=200, C=33)
PAST_F64_FULL_ITER = 30
PAST_F64_SEEDS = (19, 20, 21)  # counts, covariates, draws
PAST_F64_KW = dict(K=PAST_K, mc_samples=PAST_S, max_iter=30, rel_tol=0.0, dtype="float64",
                   verbose=False)


def batch_covariates(N, n_batches, seed):
    """A 0/1 one-hot of n_batches batches (a multi-sample atlas's samples)
    over N cells, each cell's batch drawn with numpy."""
    return np.eye(n_batches)[np.random.default_rng(seed).integers(0, n_batches, N)]


def past_f64_data():
    """PAST_F64's counts, copy numbers and covariates, made with numpy."""
    from clonealign_torch.synth import simulate_multinomial

    sim = simulate_multinomial(**PAST_F64, seed=PAST_F64_SEEDS[0], mean_total=2000)
    return sim.Y, sim.L, batch_covariates(PAST_F64["N"], PAST_BATCHES, PAST_F64_SEEDS[1])


def past_bound_checks(fl, auto_name):
    """The wide family past the old bound, by CUDA events only: each kernel
    against its plain version at every Y storage at PAST_CHECKS's shapes
    (the backward the split one: dlog_rfe_kernel and the tiled products,
    in kernel_backward's one call and in kernel_dpsi's and kernel_gene's),
    and at full width at the past-bound fit's widths (Kf 72, S*C 660, Y as
    "auto" stores it; the backward bit-identical across two launches, its
    parts alone beside the plain VJP's terms), timed beside its bound, with
    the plans' resources (at least one block an SM; none spilled); the
    backward and the gene part at PAST_SMALL (2,100 x 200, S*C 2,178) timed
    beside the plain backward; and at full width at Kf 64, S*C 80, timed
    beside its plain version in the same form. Returns the numbers for the
    kernels line."""
    log("past the old bound (Kf 64, S 64, S*C 2,048): wide kernels vs plain")
    checks = []
    for storage in STORAGES:
        for shape, S, Kf in PAST_CHECKS:
            r = check_kernels(shape, S=S, Kf=Kf, seed=35, reps=1, storage=storage,
                              a2_timed=False)
            checks.append({"shape": f"{shape['N']}x{shape['G']}", "y_storage": storage, "kf": Kf,
                           "s": S, "sc": S * shape["C"], "errs": r["errs"]})
    Kf, SC = PAST_K + PAST_BATCHES, PAST_S * FULL["C"]
    full = check_kernels(FULL, S=PAST_S, Kf=Kf, seed=36, reps=2, storage=auto_name,
                         a2_timed=False, vjp_parts=True, batch=3, identical=True)
    full["resources"] = wide_resources(fl, auto_name, Kf, SC, min_blocks=1)
    b = full["bounds"]
    log(f"past the old bound, full width, Y {auto_name}, Kf={Kf} S={PAST_S} S*C={SC}: "
        + ", ".join(f"{part} {full[f'{part}_ms']:.3f} ms (plain {full[f'{part}_plain_ms']:.3f}, "
                    f"bound {b[part][0]:.3f} by {b[part][2]}, "
                    f"{b[part][0] / full[f'{part}_ms']:.3f} of it)"
                    for part in ("fwd", "bwd", "dpsi", "gene"))
        + f" (fwd: the split forward, the grouped one took {PAST_GROUPED_FWD_MS} ms; bwd: "
        "kernel_backward's one split call, the fit's; dpsi and gene: the parts alone)")
    for n_a2 in (0, PAST_S):
        for part, q in wide_resources(fl, auto_name, Kf, SC, n_a2, min_blocks=1).items():
            log(f"  A2 columns {n_a2}: {q['instantiation']}: {q['registers']} registers, "
                f"{q['spill_bytes']} B spilled, {q['smem_bytes']} B shared memory, "
                f"{q['blocks_per_sm']} blocks an SM")
    shape, S, Kf_small = PAST_SMALL
    small = check_kernels(shape, S=S, Kf=Kf_small, seed=38, reps=5, storage=auto_name,
                          a2_timed=False, vjp_parts=True)
    slower = small["gene_ms"] > small["gene_plain_ms"]
    log(f"past the old bound, {shape['N']}x{shape['G']} S*C={S * shape['C']} Kf={Kf_small}, Y "
        f"{auto_name}: gene part {small['gene_ms']:.4f} ms against the plain backward's "
        f"{small['gene_plain_ms']:.4f} ({'SLOWER' if slower else 'no slower'}; bound "
        f"{small['bounds']['gene'][0]:.4f}), dpsi {small['dpsi_ms']:.4f} (plain "
        f"{small['dpsi_plain_ms']:.4f}); the backward's one call {small['bwd_ms']:.4f} (plain "
        f"{small['bwd_plain_ms']:.4f}, bound {small['bounds']['bwd'][0]:.4f})")
    # the widest [psi, X] up to the old bound (Kf 64, S*C 80), its plain
    # parts timed in the VJP's form as above
    kf64 = check_kernels(FULL, S=WIDE_S, Kf=64, seed=37, reps=1, storage=auto_name,
                         a2_timed=False, vjp_parts=True)
    log(f"wide, full width, Y {auto_name}, Kf=64 S*C={WIDE_S * FULL['C']}: "
        + ", ".join(f"{part} {kf64[f'{part}_ms']:.3f} ms (plain {kf64[f'{part}_plain_ms']:.3f}, "
                    f"bound {kf64['bounds'][part][0]:.3f} by {kf64['bounds'][part][2]})"
                    for part in ("fwd", "dpsi", "gene")))
    return {"checks": checks, "full": full, "kf64": kf64, "small": small}


def past_bound_fit(clonealign_torch, fl, Y, L, z, y_itemsize):
    """The full-width fit past the old bound through clonealign: K = 2,
    P = 70 (a one-hot of 70 batches, numpy seed 7), mc_samples = 66,
    y_storage "auto", FIT_MAX_ITER iterations; full_fit's checks (rising
    trace, accuracy, every launch a wide one); its ms an iteration beside
    the earlier grouped forms', its inference peak beside restarts._sweep_bytes' reckoning of
    one lane, which must not be below the peak ("auto" decides lane
    batching from it), and what "auto" picks for three such restarts."""
    from clonealign_torch import restarts

    X = batch_covariates(FULL["N"], PAST_BATCHES, seed=7)
    out = full_fit(clonealign_torch, fl, Y, L, z, "auto", x=X, mc_samples=PAST_S, wide=True,
                   K=PAST_K, label=f"past the old bound: auto K={PAST_K} P={PAST_BATCHES} "
                                   f"(one-hot batches) mc_samples={PAST_S}")
    sizes = (FULL["N"], FULL["G"], FULL["C"], PAST_K, PAST_S)
    out["reckoned_gb"] = restarts._sweep_bytes(*sizes, 1, 4, "cuda", y_itemsize, PAST_BATCHES) / 1e9
    out["auto_3"] = restarts._auto_restart_batching(*sizes, 3, 4, "cuda", y_itemsize, PAST_BATCHES)
    log(f"past the old bound: {out['iter_ms']:.2f} ms an iteration (with the grouped forward: "
        f"{PAST_GROUPED_FWD_ITER_MS}; with the grouped forward and backward: "
        f"{PAST_GROUPED_ITER_MS}); peak allocated in the inference {out['peak_gb']:.4f} GB "
        f"against _sweep_bytes' {out['reckoned_gb']:.4f} GB for one lane "
        f"({out['reckoned_gb'] / out['peak_gb']:.3f} of it); \"auto\" at three restarts: "
        f"{out['auto_3']}")
    if out["reckoned_gb"] < out["peak_gb"]:
        raise AssertionError(f"past the old bound: _sweep_bytes reckons {out['reckoned_gb']:.4f} GB, "
                             f"under the fit's peak {out['peak_gb']:.4f} GB")
    return out


def past_bound_f64(clonealign_torch, fl, cpu):
    """The float64 fit past every old bound (PAST_F64, PAST_F64_KW:
    Kf 72, S 66, S*C 2,178) on the card against the CPU port's
    (:func:`cpu_references_f64`), from the same numpy draws with the PCA's
    sign fixed: the same iterations and labels, the final ELBO within 1e-8
    of the CPU's relative, every launch a float64 one (the split forward
    2 + 2 n + 20 times, the backward kernel_backward's one call n times,
    no dpsi or gene part alone). Returns its launches and numbers."""
    Y, L, X = past_f64_data()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    with signed_pca():
        card = clonealign_torch.clonealign(Y, L, x=X, device="cuda",
                                           noise=NumpyNoise(PAST_F64_SEEDS[2]), **PAST_F64_KW)
    card_s = time.perf_counter() - t0
    launches = launches_of(fl, "float64")
    ref = cpu() if callable(cpu) else cpu
    ci, n = card.convergence_info, card.convergence_info.n_iters
    e_cpu = float(ref["past_elbo"])
    rel = abs(ci.final_elbo - e_cpu) / abs(e_cpu)
    same = list(card.clone) == ref["past_clone"].tolist()
    log(f"float64 fit past the old bound {PAST_F64['N']}x{PAST_F64['G']}x{PAST_F64['C']} "
        f"K={PAST_K} P={PAST_BATCHES} mc_samples={PAST_S} (Kf {PAST_K + PAST_BATCHES}, S*C "
        f"{PAST_S * PAST_F64['C']}): card {card_s:.1f} s, CPU {float(ref['past_s']):.1f} s, {n} "
        f"iterations; final ELBO {ci.final_elbo:.12g} against the CPU's {e_cpu:.12g} "
        f"({rel:.3e} relative, bar 1e-8), labels {'identical' if same else 'DIFFER'}; launches "
        f"(float64) {launches}")
    check_trace(ci.elbo)
    want = {"fwd": 2 + 2 * n + 20, "dpsi": 0, "gene": 0, "split": n}
    if not (same and rel <= 1e-8 and n == int(ref["past_n"])) or launches != want:
        raise AssertionError(f"the float64 fit past the old bound differs from the CPU's or "
                             f"launched {launches} (expected {want})")
    return {"launches": launches, "elbo_rel": rel, "card_s": card_s}


def past_bound_f64_fit(clonealign_torch, fl, Y, L, z, y_itemsize):
    """The full-width float64 fit past the old bound through clonealign:
    past_bound_fit's widths (K = 2, P = 70 one-hot batches, numpy seed 7,
    mc_samples = 66: Kf 72, S*C 660), y_storage "auto", dtype "float64",
    PAST_F64_FULL_ITER iterations; full_fit's checks (rising trace,
    accuracy, every launch a float64 one: the split forward and
    kernel_backward's one call), its inference peak beside
    restarts._sweep_bytes' reckoning of one lane, which must not be below
    it."""
    from clonealign_torch import restarts

    X = batch_covariates(FULL["N"], PAST_BATCHES, seed=7)
    out = full_fit(clonealign_torch, fl, Y, L, z, "auto", x=X, mc_samples=PAST_S, K=PAST_K,
                   dtype="float64", max_iter=PAST_F64_FULL_ITER,
                   label=f"float64 past the old bound: auto K={PAST_K} P={PAST_BATCHES} "
                         f"(one-hot batches) mc_samples={PAST_S}")
    sizes = (FULL["N"], FULL["G"], FULL["C"], PAST_K, PAST_S)
    out["reckoned_gb"] = restarts._sweep_bytes(*sizes, 1, 8, "cuda", y_itemsize, PAST_BATCHES) / 1e9
    log(f"float64 past the old bound: {out['iter_ms']:.2f} ms an iteration; peak allocated in "
        f"the inference {out['peak_gb']:.4f} GB against _sweep_bytes' {out['reckoned_gb']:.4f} GB "
        f"for one lane ({out['reckoned_gb'] / out['peak_gb']:.3f} of it)")
    if out["reckoned_gb"] < out["peak_gb"]:
        raise AssertionError(f"float64 past the old bound: _sweep_bytes reckons "
                             f"{out['reckoned_gb']:.4f} GB, under the fit's peak "
                             f"{out['peak_gb']:.4f} GB")
    del out["labels"]
    return out


# The torch examples on the card and the files each writes (the plots only
# where matplotlib is installed)
EXAMPLES = {"quickstart_torch.py": ("quickstart_torch_fit.npz", "quickstart_torch_elbo.png",
                                    "quickstart_torch_tracks.png"),
            "full_workflow_torch.py": ("full_workflow_torch_fit.npz",)}


def examples_on_card():
    """Run examples/quickstart_torch.py and examples/full_workflow_torch.py
    at their default sizes on the card (``--device`` "cuda", the default),
    both at once, each in its own process in a temporary directory: each
    exits 0, writes its files there (its plots where matplotlib is
    installed), reports its accuracies at MIN_ACCURACY or more (and 200
    cells served), and has imported neither jax nor clonealign_tpu.
    Returns each one's seconds."""
    import importlib.util

    plots = importlib.util.find_spec("matplotlib") is not None
    code = ("import runpy, sys; path, out = sys.argv[1:]; sys.argv = [path, '--out', out]; "
            "runpy.run_path(path, run_name='__main__'); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'clonealign_tpu')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               MPLBACKEND="Agg")
    seconds = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-c", code, str(REPO / "examples" / name), str(Path(d) / name)],
            cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name in EXAMPLES}
        try:
            outs = {name: p.communicate(timeout=600) for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for name, (stdout, stderr) in outs.items():
            seconds[name] = time.perf_counter() - t0
            accs = [float(a) for a in re.findall(r"accuracy(?: vs ground truth:)? (\d\.\d+)",
                                                   stdout)]
            files = [f for f in EXAMPLES[name] if not (Path(d) / name / f).exists()
                     and (plots or not f.endswith(".png"))]
            log(f"example {name} on the card: rc {procs[name].returncode}, accuracies {accs}, "
                f"missing files {files}; last lines: "
                + " | ".join(stdout.strip().splitlines()[-3:]))
            served = name != "full_workflow_torch.py" or "served 200 new cells" in stdout
            if procs[name].returncode or not accs or min(accs) < MIN_ACCURACY or files \
                    or not served:
                raise AssertionError(f"example {name} failed on the card:\n{stdout[-2000:]}\n"
                                     f"{stderr[-3000:]}")
    return seconds


def wide_kernel_checks(fl, auto_name):
    """The wide kernel family's checks, timed by CUDA events only: each
    kernel against its plain version at every Y storage at WIDE_CHECKS's
    shapes and at a streaming chunk shape (Y the leading rows of the
    feeder's buffer), timed at full width for WIDE_FULL beside its bound,
    with each plan's resources, and past the old bound
    (:func:`past_bound_checks`). ``auto_name`` names the Y storage "auto"
    resolves to for the full-width counts. Returns the numbers for
    :func:`wide_phase`."""
    from clonealign_torch import stream

    log("wide phase: kernels vs plain past the narrow limits (tolerance: KERNEL_RTOL="
        f"{KERNEL_RTOL:g} of the per-element absolute-term sum)")
    for storage in STORAGES:
        for Kf, S, C in WIDE_CHECKS:
            check_kernels(dict(WIDE_CHECK, C=C), S=S, Kf=Kf, seed=31, reps=1, storage=storage,
                          a2_timed=False)
    sizes = sorted({j - i for i, j in stream._chunk_bounds(FULL["N"], stream._resolve_chunk_cells(
        "auto", FULL["N"], FULL["G"]))})
    chunk = check_kernels(dict(FULL, N=sizes[0]), S=WIDE_S, Kf=1 + WIDE_P, seed=32, reps=1,
                          storage=auto_name, buffer_rows=sizes[-1], a2_timed=False)
    full = {(st, Kf, S): check_kernels(FULL, S=S, Kf=Kf, seed=33, reps=3, storage=st,
                                       a2_timed=False)
            for st in WIDE_FULL_STORAGES for Kf, S in WIDE_FULL}
    for (st, Kf, S), r in full.items():
        b = r["bounds"]
        r["resources"] = wide_resources(fl, st, Kf, S * FULL["C"])
        log(f"wide, full width, Y {st}, Kf={Kf} S*C={S * FULL['C']}: fwd_wide_pack_kernel + "
            f"fwd_wide_kernel + fwd_wide_y_kernel "
            f"{r['fwd_ms']:.3f} ms (plain {r['fwd_plain_ms']:.3f}, bound {b['fwd'][0]:.3f} by "
            f"{b['fwd'][2]}, {b['fwd'][0] / r['fwd_ms']:.3f} of it), dpsi_wide_pack_kernel + "
            f"dpsi_wide_kernel "
            f"{r['dpsi_ms']:.3f} ms (plain {r['dpsi_plain_ms']:.3f}, bound {b['dpsi'][0]:.3f} by "
            f"{b['dpsi'][2]}, {b['dpsi'][0] / r['dpsi_ms']:.3f} of it), gene_wide_pack_kernel + "
            f"gene_wide_kernel + reduce_chunks_kernel {r['gene_ms']:.3f} ms (plain "
            f"{r['gene_plain_ms']:.3f}, bound {b['gene'][0]:.3f} by {b['gene'][2]}, "
            f"{b['gene'][0] / r['gene_ms']:.3f} of it); backward {r['bwd_ms']:.3f} ms (plain "
            f"{r['bwd_plain_ms']:.3f})")
        for part, q in r["resources"].items():
            log(f"  {q['instantiation']}: {q['registers']} registers, {q['spill_bytes']} B "
                f"spilled, {q['smem_bytes']} B shared memory, {q['blocks_per_sm']} blocks an SM")
    for st in WIDE_FULL_STORAGES:
        for Kf, n_a2, SC in WIDE_RESOURCE_WIDTHS:
            for part, q in wide_resources(fl, st, Kf, SC, n_a2).items():
                log(f"wide, full width, Y {st}, Kf={Kf} S={n_a2} S*C={SC}: "
                    f"{q['instantiation']}: {q['registers']} registers, {q['spill_bytes']} B "
                    f"spilled, {q['smem_bytes']} B shared memory, {q['blocks_per_sm']} blocks "
                    f"an SM")
    return {"full": full, "chunk": chunk, "chunk_rows": (sizes[0], sizes[-1]),
            "past": past_bound_checks(fl, auto_name)}


def wide_phase(clonealign_torch, fl, y_itemsize, checks):
    """The wide kernel family's fits on the card, after its kernel checks
    ``checks`` (:func:`wide_kernel_checks`): the full-width fit with K = 1,
    P = 4 and mc_samples = 8 through clonealign (y_storage "auto"), the
    same fit streamed (:func:`wide_stream`), the sweep of three restarts as
    lanes at the same configuration, the parity fit and the fit past the
    old bound (:func:`past_bound_fit`), each of whose launches must all be
    wide. ``y_itemsize`` is the Y storage's "auto"
    resolves to for the full-width counts. Returns the numbers for the
    kernels line."""
    t_phase = time.perf_counter()
    Y, L, z = synth_counts(3, FULL["N"], FULL["G"], FULL["C"])
    X = wide_covariates(FULL["N"], seed=5)
    fit = full_fit(clonealign_torch, fl, Y, L, z, "auto", x=X, mc_samples=WIDE_S, wide=True,
                   label=f"wide: auto K=1 P={WIDE_P} mc_samples={WIDE_S}")
    streamed = wide_stream(clonealign_torch, fl, Y, L, z, X, fit)
    sweep = run_sweep(clonealign_torch, fl, Y, L, z, "wide", "xla", "vmap", "auto", y_itemsize,
                      x=X, lanes=WIDE_LANES, mc_samples=WIDE_S, wide=True)
    if sweep["ran"] != "vmap":
        raise AssertionError("the wide sweep did not run as lanes")
    past_fit = past_bound_fit(clonealign_torch, fl, Y, L, z, y_itemsize)
    del Y
    parity = parity_fit(clonealign_torch, fl)
    log(f"wide phase: {time.perf_counter() - t_phase:.1f} s after its kernel checks")
    return dict(checks, fit=fit, stream=streamed, sweep=sweep, parity=parity, past_fit=past_fit)


def wide_kernels(wide, auto_name):
    """The wide family's entries of the kernels line: the numbers at the
    wide fit's widths (Kf = 5, S*C = 80) and the storage "auto" resolves to,
    each full-width configuration's under ``by_config``, the streaming
    chunk shape's errors, and each wide path's launches. No single PyTorch
    call computes any of the three functions: library_ms is null."""
    st = auto_name if auto_name in WIDE_FULL_STORAGES else WIDE_FULL_STORAGES[0]
    main = wide["full"][(st, 1 + WIDE_P, WIDE_S)]
    src = "clonealign_torch/ops/csrc/fused_likelihood.cu"
    fwd_at = "clonealign_tpu/ops/fused_likelihood.py:125 (jnp.dot branches :91, :102, :105)"
    bwd_at = ("clonealign_tpu/ops/fused_likelihood.py:234 (jnp.dot branches :182, :187, "
              ":201-202, :211, :213)")
    paths = ((f"wide fit K=1 P={WIDE_P} mc_samples={WIDE_S} y_storage=auto", wide["fit"]["launches"]),
             (f"wide streaming fit, {wide['stream']['n_chunks']} chunks, fresh",
              wide["stream"]["launches"]),
             (f"wide sweep, {WIDE_LANES['n_repeats']} restarts, vmap", wide["sweep"]["launches"]),
             (f"parity fit {PARITY['N']}x{PARITY['G']}x{PARITY['C']} K={PARITY['K']} "
              f"P={PARITY['P']} mc_samples={PARITY['mc_samples']}", wide["parity"]))
    out = []
    for name, part, at, err in (
            ("fwd_wide_kernel", "fwd", fwd_at, ("A1", "Z", "YW")),
            ("dpsi_wide_pack_kernel+dpsi_wide_kernel", "dpsi", bwd_at, ("dpsi",)),
            ("gene_wide_kernel+reduce_chunks_kernel", "gene", bwd_at, ("dW", "dmuL"))):
        b = main["bounds"][part]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": at,
            "launches": wide["fit"]["launches"][part],
            "max_abs_err": max(main["errs"][e] for e in err),
            "ms": main[f"{part}_ms"], "plain_ms": main[f"{part}_plain_ms"],
            "bound_ms": b[0], "bound_by": b[1], "bound_unit": b[2], "library_ms": None,
            "bound_fraction": b[0] / main[f"{part}_ms"], **main["resources"].get(part, {}),
            **({"y_products": main["resources"]["fwd_y"]} if part == "fwd" else {}),
            "y_storage": st, "kf": 1 + WIDE_P, "sc": WIDE_S * FULL["C"],
            "by_config": [{"y_storage": s, "kf": Kf, "sc": S * FULL["C"],
                           "ms": r[f"{part}_ms"], "plain_ms": r[f"{part}_plain_ms"],
                           "bound_ms": r["bounds"][part][0], "bound_by": r["bounds"][part][1],
                           "bound_fraction": r["bounds"][part][0] / r[f"{part}_ms"],
                           **r["resources"].get(part, {}),
                           **({"y_products": r["resources"]["fwd_y"]} if part == "fwd" else {}),
                           "max_abs_err": max(r["errs"][e] for e in err)}
                          for (s, Kf, S), r in wide["full"].items()],
            "stream_shape": {"shape": f"{wide['chunk_rows'][0]}x{FULL['G']} C={FULL['C']}",
                             "buffer_rows": wide["chunk_rows"][1],
                             "max_abs_err": max(wide["chunk"]["errs"][e] for e in err)},
            "paths": [{"path": p, "launches": n[part]} for p, n in paths],
        })
    past, Kf, SC = wide["past"]["full"], PAST_K + PAST_BATCHES, PAST_S * FULL["C"]
    small, (shape, S, Kf_small) = wide["past"]["small"], PAST_SMALL
    fit_path = (f"fit past the old bound K={PAST_K} P={PAST_BATCHES} mc_samples={PAST_S} "
                "y_storage=auto")
    # past the bound the fit's backward is kernel_backward's one call
    # (counted in split); kernel_dpsi's and kernel_gene's split forms,
    # which no path of the port calls, stand under "parts", each held
    # against the plain VJP and timed beside its terms
    for name, part, launches, err, parts in (
            ("dlog_rfe_kernel (rfe)+dpsi_product_kernel+dpsi_sum_kernel (Z)+fwd_wide_y_kernel",
             "fwd", "fwd", ("A1", "Z", "YW"), ()),
            ("dlog_rfe_kernel+gene_product_kernel+dpsi_product_kernel+dpsi_sum_kernel", "bwd",
             "split", ("dpsi", "dW", "dmuL"),
             (("kernel_dpsi: dlog_rfe_kernel without Y+dpsi_product_kernel+dpsi_sum_kernel",
               "dpsi", ("dpsi",)),
              ("kernel_gene: dlog_rfe_kernel+gene_product_kernel", "gene", ("dW", "dmuL"))))):
        b = past["bounds"][part]
        at = fwd_at if part == "fwd" else bwd_at
        out.append({
            "name": f"{name} past the old bound (Kf {Kf}, S {PAST_S}, S*C {SC})", "route": "cuda",
            "source": src, "replaces": at, "launches": wide["past_fit"]["launches"][launches],
            "max_abs_err": max(past["errs"][e] for e in err),
            "ms": past[f"{part}_ms"], "plain_ms": past[f"{part}_plain_ms"],
            "bound_ms": b[0], "bound_by": b[1], "bound_unit": b[2], "library_ms": None,
            "bound_fraction": b[0] / past[f"{part}_ms"],
            **(dict(past["resources"]["fwd"], z_product=past["resources"]["dpsi"],
                    y_products=past["resources"]["fwd_y"])
               if part == "fwd" else
               {"resources": [past["resources"][k] for k in ("gene", "gene_products", "dpsi")]}),
            "y_storage": auto_name, "kf": Kf, "s": PAST_S, "sc": SC,
            "bit_identical_launches": past["identical"],
            "checks": [{k: v for k, v in c.items() if k != "errs"}
                       | {"max_abs_err": max(c["errs"][e] for e in err)}
                       for c in wide["past"]["checks"]],
            "paths": [{"path": fit_path, "launches": wide["past_fit"]["launches"][launches]}],
            "small_shape": {"shape": f"{shape['N']}x{shape['G']}", "kf": Kf_small, "s": S,
                            "sc": S * shape["C"], "ms": small[f"{part}_ms"],
                            "plain_ms": small[f"{part}_plain_ms"],
                            "bound_ms": small["bounds"][part][0],
                            "max_abs_err": max(small["errs"][e] for e in err)},
            **({"parts": [{"name": p_name, "launches": 0, "ms": past[f"{p}_ms"],
                           "plain_ms": past[f"{p}_plain_ms"],
                           "bound_ms": past["bounds"][p][0], "bound_by": past["bounds"][p][1],
                           "max_abs_err": max(past["part_errs"][e] for e in p_err),
                           "small_shape": {"ms": small[f"{p}_ms"],
                                           "plain_ms": small[f"{p}_plain_ms"],
                                           "max_abs_err": max(small["part_errs"][e]
                                                              for e in p_err)}}
                          for p_name, p, p_err in parts]} if parts else {}),
        })
    return out


# ---------------------------------------------------------------------------
# The float64 family: dtype="float64" on the card
# ---------------------------------------------------------------------------

# Kernels vs plain float64 at every Y storage the float64 family loads
# (float64 being what y_storage "float32" gives a float64 fit), at the
# first check's shapes, the wide phase's, each contract bound alone (Kf
# 64; S 64; S*C 2048) and every bound at once: each element within
# F64_RTOL of its absolute-term sum (about 4,500 float64 ulps of it; both
# sides sum in float64 in other orders)
F64_RTOL = 1e-12
F64_STORAGES = ("float64", "bfloat16", "int16", "int8")
F64_CHECKS = ([(SMALL, 1, Kf) for Kf in (1, 3, 4)] + [(VEC, 1, Kf) for Kf in (2, 3, 4)]
              + [(RICH, 3, 4)] + [(dict(WIDE_CHECK, C=C), S, Kf) for Kf, S, C in WIDE_CHECKS]
              + [(dict(N=300, G=100, C=C), S, Kf)
                 for Kf, S, C in ((64, 1, 10), (1, 64, 1), (1, 1, 2048), (64, 64, 32))])
# full width, timed beside the float64 bounds: (Kf, S) at C = 10 (S*C 10
# and 80), Y as "auto" stores it (int8) and as float64
F64_FULL = ((1, 1), (5, 1), (1, 8), (5, 8))
F64_FULL_STORAGES = ("int8", "float64")
# PR 17's kernels at those widths (forward, dpsi, gene part ms; chip_smoke.py
# on an H100 80GB HBM3 at 700 W, PERF.md; None where not timed), printed
# beside this run's; and dpsi_f64_kernel's earlier form on the CUDA cores
# (a lane a cell, FP64 FMAs), its last times at those widths
# (time_likelihood.py --f64 on the same card and limit, PERF.md)
F64_PR17_MS = {("int8", 1, 1): (2.857, 1.884, 3.541), ("int8", 5, 1): (3.594, 2.576, 4.288),
               ("int8", 1, 8): (10.53, 8.744, 15.41), ("int8", 5, 8): (11.74, 10.28, 18.76),
               ("float64", 1, 1): (3.287, 1.890, 3.025), ("float64", 5, 1): None,
               ("float64", 1, 8): None, ("float64", 5, 8): (12.33, 10.30, 18.43)}
F64_CUDA_CORE_DPSI_MS = {("int8", 1, 1): 1.899, ("int8", 5, 1): 2.579, ("int8", 1, 8): 8.749,
                         ("int8", 5, 8): 10.35, ("float64", 1, 1): 1.894,
                         ("float64", 5, 1): 2.559, ("float64", 1, 8): 8.703,
                         ("float64", 5, 8): 10.28}
# the float64 sweep: three restarts, "vmap" and "map"
F64_LANES = dict(initial_shrinks=(5,), n_repeats=3, max_iter=100, elbo_eval="reuse")
# the golden fits in float64 (rel_tol 0: every fit runs GOLDEN_MAX_ITER
# iterations, so that the card's and the CPU's make the same draws), and
# the v1 family's (model3 counts, numpy seed 17), on the card against the
# CPU; the CPU's run in a child process with F64_CPU_THREADS threads beside
# the script's first kernel checks (CUDA events only), which the first
# host-timed fit waits for
F64_GOLDEN = (("example", 7), ("synth", 11))
F64_GOLDEN_KW = dict(max_iter=GOLDEN_MAX_ITER, rel_tol=0.0, dtype="float64", verbose=False)
F64_V1 = dict(N=1_000, G=200, C=4)
F64_V1_KW = dict(max_iter=20, rel_tol=0.0, verbose=False, dtype="float64")
F64_CPU_THREADS = 6
# Published FP64 peaks of one H100 SXM at 700 W: FLOP/s on the CUDA cores
# (an FMA is two) and on the tensor cores. An exp in float64 is a sequence
# of FP64 instructions on the CUDA cores (counted by exp_fp64_instructions).
FP64_OPS_PER_S = 33.5e12
FP64_TC_OPS_PER_S = 67e12


def exp_fp64_instructions():
    """The FP64 instructions (D*, and conversions to or from F64) of one
    double exp() as nvcc builds it for the card, counted from cuobjdump
    -sass of a kernel that computes one; returns (count, opcodes)."""
    import os

    from clonealign_torch.ops import _build

    nvcc = _build._nvcc()
    src = ('extern "C" __global__ void one_exp(const double* x, double* y) '
           '{ y[threadIdx.x] = exp(x[threadIdx.x]); }\n')
    with tempfile.TemporaryDirectory() as d:
        cu, cubin = Path(d) / "one_exp.cu", Path(d) / "one_exp.cubin"
        cu.write_text(src)
        subprocess.run([nvcc, *_build.ARCH, "-O3", "-cubin", "-o", str(cubin), str(cu)],
                       check=True, capture_output=True)
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                               str(cubin)], check=True, capture_output=True, text=True).stdout
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", sass)
    fp64 = [o for o in ops if re.match(r"D(FMA|ADD|MUL|SETP|MNMX)", o)
            or (re.match(r"(F2F|F2I|I2F)", o) and "F64" in o)]
    return len(fp64), fp64


F64_DMMA_KERNELS = ("fwd_f64_kernel", "dpsi_f64_kernel", "gene_f64_kernel", "dlog_rfe_f64_kernel",
                    "gene_product_f64_kernel", "dpsi_product_f64_kernel")


def dmma_instantiations(kernels=F64_DMMA_KERNELS):
    """The FP64 MMA instructions (DMMA) in the SASS of each instantiation of
    the built library's ``kernels``, by kernel and template arguments (as
    :func:`kernel_resources` keys them), counted by cuobjdump -sass."""
    import os

    from clonealign_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path())], check=True,
                          capture_output=True, text=True).stdout
    found, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            key = None
            for kernel in kernels:
                f = re.search(r"\d" + kernel + r"(?:I((?:L[ib]\d+E)+)E|E)", m.group(1))
                if f:
                    key = (kernel, "<" + ",".join(re.findall(r"L[ib](\d+)E", f.group(1) or ""))
                           + ">")
                    found[key] = 0
            continue
        if key and re.search(r"\bDMMA\b", line):
            found[key] += 1
    return found


def check_f64_sass(build_log, fl):
    """Every fwd_f64_kernel, dpsi_f64_kernel and gene_f64_kernel
    instantiation, and the split kernels' dlog_rfe_f64_kernel,
    gene_product_f64_kernel and dpsi_product_f64_kernel, holds FP64 MMA
    (DMMA) instructions in its SASS and spills no register (ptxas's report);
    raises otherwise. Returns the DMMA counts."""
    want = tc_kernels(fl)
    dmma = dmma_instantiations()
    for kernel in F64_DMMA_KERNELS:
        counts = {k: n for (name, k), n in dmma.items() if name == kernel}
        res = kernel_resources(build_log, kernel)
        log(f"{kernel}: DMMA instructions by instantiation "
            + ", ".join(f"{k} {n}" for k, n in sorted(counts.items())))
        if set(counts) != want[kernel] or min(counts.values()) < 1:
            raise AssertionError(f"{kernel}: instantiations without DMMA or missing from the "
                                 f"SASS: {sorted(k for k in want[kernel] if not counts.get(k))}")
        spilled = [k for k, (_, st, ld) in res.items() if st or ld]
        if set(res) != want[kernel] or spilled:
            raise AssertionError(f"{kernel}: spills in {spilled} or missing from ptxas's report")
    return dmma


def bound_f64(y_bytes, vec_doubles, mma_flops, fp64_flops, exps, exp_ops):
    """(ms, "bytes" or "operations", unit): the slowest of the bytes over the
    HBM rate (Y's y_bytes and vec_doubles float64 values, each input read
    once and each output written once), the products on the FP64 tensor
    cores, and the other FP64 operations with the exps (exp_ops FP64
    instructions each, two operations an instruction at the FMA rate) on
    the CUDA cores."""
    units = {"bytes": 1e3 * (y_bytes + 8 * vec_doubles) / HBM_BYTES_PER_S,
             "FP64 MMA": 1e3 * mma_flops / FP64_TC_OPS_PER_S,
             "FP64 CUDA cores (exps and FMAs)":
                 1e3 * (fp64_flops + 2 * exp_ops * exps) / FP64_OPS_PER_S}
    unit = max(units, key=units.get)
    return units[unit], "bytes" if unit == "bytes" else "operations", unit


def kernel_bounds_f64(N, G, Kf, SC, y_itemsize, exp_ops):
    """kernel_bounds' functions in float64 (A2 off): the products with muL
    on the FP64 tensor cores, log_rfe's, Y W's, dpsi's and dW's Kf FMAs an
    element and the exps on the CUDA cores; ``bwd`` the whole backward
    (dpsi and the gene part from one dlog_rfe, as kernel_backward's one
    call past the old bound computes them)."""
    NG = N * G
    fwd = bound_f64(y_itemsize * NG, N * Kf + G * Kf + G * SC + N + N * SC + N * Kf,
                    2 * NG * SC, NG * (4 * Kf + 2), NG, exp_ops)
    dpsi = bound_f64(0, 3 * N * Kf + G * Kf + G * SC + N + N * SC,
                     2 * NG * SC, NG * (4 * Kf + 1), NG, exp_ops)
    gene = bound_f64(y_itemsize * NG, N * Kf + 2 * G * Kf + 2 * G * SC + N + N * SC,
                     4 * NG * SC, NG * (4 * Kf + 3), NG, exp_ops)
    bwd = bound_f64(y_itemsize * NG, 2 * N * Kf + 2 * G * Kf + 2 * G * SC + N + N * SC,
                    4 * NG * SC, NG * (6 * Kf + 3), NG, exp_ops)
    return {"fwd": fwd, "dpsi": dpsi, "gene": gene, "bwd": bwd}


def check_kernels_f64(shape, S, Kf, seed, storage, reps=0, exp_ops=None, vjp_parts=False,
                      batch=10):
    """The float64 family against the plain float64 versions on the card at
    one shape, Y stored as ``storage``, A2 on and off: the forward, dpsi
    and the gene part called alone, and kernel_backward (past the old bound
    its one call for both parts), every element within F64_RTOL of its
    absolute-term sum, and each bit-identical across two launches. With
    ``reps``, the A2-off calls (the training step's form) timed beside
    their plain versions (reference_likelihood_terms, reference_dpsi,
    reference_gene, reference_likelihood_vjp for the backward) and their
    bounds (exp_ops FP64 instructions an exp); with ``vjp_parts``, dpsi's
    and the gene part's beside the plain VJP's terms (as
    :func:`check_kernels`'); ``batch`` kernel calls between a timing's two
    CUDA events. Returns the errors (each output's under ``errs``; the
    backward's under ``bwd_errs``), the times, and under ``identical``
    whether every kernel gave the same bits twice (raises where one did
    not)."""
    import torch

    from clonealign_torch.ops import fused_likelihood as fl

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = {k: v.double() for k, v in kernel_inputs(gen, shape["N"], shape["G"], shape["C"], S, Kf,
                                                 "cuda").items()}
    Yf = x["Y"]
    Y = Yf.to(getattr(torch, storage))
    if not torch.equal(Y.double(), Yf):
        raise AssertionError(f"the test counts do not fit {storage} exactly")
    psi, W, muL, dA1, dZ = (x[k] for k in ("psi", "W", "muL", "dA1", "dZ"))
    label = f"float64 {shape['N']}x{shape['G']} S*C={S * shape['C']} Kf={Kf} Y {storage}"
    names_f, names_b = ("A1", "A2", "Z", "YW"), ("dpsi", "dW", "dlog_mu", "dmuL")

    def as_dict(names, out):
        return {n: t for n, t in zip(names, out) if t is not None}

    result = {"errs": {}}
    for with_a2 in (True, False):
        log_mu = x["log_mu"] if with_a2 else None
        args_f = (Y, psi, W, log_mu, muL)
        args_b = (Y, psi, W, muL, dA1, x["dA2"] if with_a2 else None, dZ)
        fwd = [fl.kernel_forward(*args_f) for _ in range(2)]
        YW = fwd[0][3]
        bwd = [(fl.kernel_dpsi(psi, W, muL, dA1, dZ, YW), *fl.kernel_gene(*args_b))
               for _ in range(2)]
        joint = [fl.kernel_backward(*args_b, YW) for _ in range(2)]
        torch.cuda.synchronize()
        same = [all(u is None or torch.equal(u, v) for u, v in zip(a, b))
                for a, b in (fwd, bwd, joint)]
        result["identical"] = all(same) and result.get("identical", True)
        if not result["identical"]:
            raise AssertionError(f"{label}: a float64 kernel differs between two launches")
        fwd_scale, bwd_scale = abs_scales(dict(x, Y=Yf), with_a2)
        fwd_scale["YW"] = Yf @ W.abs()
        want = as_dict(names_f, fl.reference_likelihood_terms(*args_f))
        want["YW"] = Yf @ W
        tag = f"{label} A2={'on' if with_a2 else 'off'}"
        errs = result["errs"] if not with_a2 else {}
        result["fwd_err"] = compare(as_dict(names_f, fwd[0]), want, fwd_scale, f"fwd {tag}",
                                    errs, F64_RTOL)
        want = as_dict(names_b, fl.reference_likelihood_vjp(*args_b))
        result["bwd_err"] = compare(as_dict(names_b, bwd[0]), want, bwd_scale, f"bwd {tag}",
                                    errs, F64_RTOL)
        bwd_errs = result.setdefault("bwd_errs", {}) if not with_a2 else {}
        result["joint_err"] = compare(as_dict(names_b, joint[0]), want, bwd_scale,
                                      f"kernel_backward {tag}", bwd_errs, F64_RTOL)
        del fwd, bwd, joint, want, fwd_scale, bwd_scale
        if reps and not with_a2:
            result.update({
                "fwd_ms": cuda_ms(lambda: fl.kernel_forward(*args_f), reps, batch),
                "dpsi_ms": cuda_ms(lambda: fl.kernel_dpsi(psi, W, muL, dA1, dZ, YW), reps,
                                   batch),
                "gene_ms": cuda_ms(lambda: fl.kernel_gene(*args_b), reps, batch),
                "bwd_ms": cuda_ms(lambda: fl.kernel_backward(*args_b, YW), reps, batch),
                "bwd_plain_ms": cuda_ms(lambda: fl.reference_likelihood_vjp(*args_b), reps, 2),
                "fwd_plain_ms": cuda_ms(lambda: fl.reference_likelihood_terms(*args_f), reps, 2),
                "dpsi_plain_ms": cuda_ms(
                    (lambda: (Y.double() * dA1[:, None] + torch.exp(psi @ W.T) * (dZ @ muL.T)) @ W)
                    if vjp_parts else (lambda: fl.reference_dpsi(YW, psi, W, muL, dA1, dZ)),
                    reps, 2),
                "gene_plain_ms": cuda_ms(lambda: (fl.reference_likelihood_vjp if vjp_parts
                                                  else fl.reference_gene)(*args_b), reps, 2),
                "bounds": kernel_bounds_f64(shape["N"], shape["G"], Kf, S * shape["C"],
                                            Y.element_size(), exp_ops)})
    del x, Y, Yf, YW
    torch.cuda.empty_cache()
    return result


def f64_resources(fl, storage, Kf, n_a2, SC, N, G):
    """The float64 kernels' shared memory and blocks an SM under
    ``fl.f64_plan``'s plan (``fl64_resources``): ``fwd``, ``dpsi`` and
    ``gene``; past the old bound ``fwd`` is the forward's Y products'
    fwd_f64_kernel beside ``rfe`` (dlog_rfe_f64_kernel<YT, 2>) and
    ``product`` (dpsi_product_f64_kernel, Z's and dpsi's products),
    ``dpsi`` dlog_rfe_f64_kernel<0, 0> (t), ``gene`` dlog_rfe_f64_kernel<YT,
    1> beside ``gene_products`` (gene_product_f64_kernel<0, 0>), each split
    kernel with its registers and spills from ptxas's report; raises where
    one does not run or spills."""
    import ctypes

    import torch

    from clonealign_torch.ops import _build

    plan = fl.f64_plan(N, G, Kf, n_a2, SC)
    out = (ctypes.c_int * 12)()
    code = fl.Y_DTYPES_F64[getattr(torch, storage)]
    err = _build.load().fl64_resources(fl._plan_arg(plan, fl.F64_PLAN_KEYS), N, G, Kf, n_a2, SC,
                                       code, out)
    if err:
        raise AssertionError(f"the library refuses f64_plan's plan {plan} (CUDA error {err})")
    if plan["split"]:
        slots = {"fwd": (0, None), "product": (2, ("dpsi_product_f64_kernel", "<>")),
                 "gene": (4, ("dlog_rfe_f64_kernel", f"<{code},1>")),
                 "gene_products": (6, ("gene_product_f64_kernel", "<0,0>")),
                 "rfe": (8, ("dlog_rfe_f64_kernel", f"<{code},2>")),
                 "dpsi": (10, ("dlog_rfe_f64_kernel", "<0,0>"))}
    else:
        slots = {"fwd": (0, None), "dpsi": (2, None), "gene": (4, None)}
    res = {}
    for part, (i, named) in slots.items():
        res[part] = {"smem_bytes": out[i], "blocks_per_sm": out[i + 1]}
        if named:
            kernel, args = named
            regs, spill_st, spill_ld = kernel_resources(_build.build_log, kernel)[args]
            res[part].update(instantiation=kernel + args, registers=regs,
                             spill_bytes=spill_st + spill_ld)
            if spill_st or spill_ld:
                raise AssertionError(f"{kernel}{args} spills: {res[part]}")
    if min(r["blocks_per_sm"] for r in res.values()) < 1:
        raise AssertionError(f"a float64 kernel cannot run at Kf={Kf}, S={n_a2}, S*C={SC}: {res}")
    return res


@contextlib.contextmanager
def signed_pca():
    """Fits in this block take each PCA score column with its largest entry
    positive. The scores' sign is arbitrary, and the card's SVD and the
    CPU's may return opposite ones, which start a fit from another psi."""
    import torch

    from clonealign_torch.models import multinomial as mm

    port = mm.pca_init_scores

    def signed(*args, **kwargs):
        pcs = port(*args, **kwargs)
        cols = torch.arange(pcs.shape[1], device=pcs.device)
        return pcs * torch.sign(pcs[pcs.abs().argmax(0), cols])

    mm.pca_init_scores = signed
    try:
        yield
    finally:
        mm.pca_init_scores = port


def f64_stream(clonealign_torch, fl, Y, L, z, core):
    """The full-width float64 fit ("auto" storage, "fresh") streamed through
    ``fit_streaming`` in the feeder's "auto" chunks, held to ``core``, the
    in-core float64 fit on the same data and seed: the same iterations and
    labels, the final ELBO within 1e-9 of it relative, every launch a
    float64 one, forwards chunks x (2 + 2 n + 20) and dpsi = gene = chunks
    x n; prints the card's peak over the call (its float64 cell state and
    chunk buffers; Y stays on the host)."""
    import torch

    from clonealign_torch import stream

    n_chunks = len(stream._chunk_bounds(FULL["N"], stream._resolve_chunk_cells(
        "auto", FULL["N"], FULL["G"])))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fl.reset_launch_counts()
    t0 = time.perf_counter()
    fit = clonealign_torch.fit_streaming(
        Y, L, chunk_cells="auto", device="cuda", max_iter=FIT_MAX_ITER, seed=0, verbose=False,
        elbo_eval="fresh", likelihood_impl="xla", y_storage="auto", dtype="float64")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - before) / 1e9
    launches = launches_of(fl, "float64")
    ci, n = fit.convergence_info, fit.convergence_info.n_iters
    rel = abs(ci.final_elbo - core["final_elbo"]) / abs(core["final_elbo"])
    same = fit.clone == core["labels"]
    want = {"fwd": n_chunks * (2 + 2 * n + 20), "dpsi": n_chunks * n, "gene": n_chunks * n,
            "split": 0}
    out = {"iter_ms": 1000 * fit.timings["loop"] / max(n, 1), "n_iters": n, "launches": launches,
           "peak_gb": peak, "n_chunks": n_chunks, "elbo_rel": rel}
    log(f"float64 streaming fit {FULL['N']}x{FULL['G']}x{FULL['C']} auto ({n_chunks} chunks, "
        f"fresh): {wall:.2f} s wall, {n} iterations, {out['iter_ms']:.2f} ms per iteration "
        f"against in-core {core['iter_ms']:.2f}; final ELBO {ci.final_elbo:.12g} against "
        f"{core['final_elbo']:.12g} ({rel:.3e} relative, bar 1e-9), labels "
        f"{'identical' if same else 'DIFFER'}; accuracy {accuracy(fit, z):.4f}; launches "
        f"(float64) {launches}; peak allocated over the call {peak:.3f} GB (Y takes "
        f"{FULL['N'] * FULL['G'] / 1e9:.3f} GB at int8)")
    check_trace(ci.elbo)
    if not (same and rel <= 1e-9 and n == core["n_iters"]) or launches != want:
        raise AssertionError(f"the streamed float64 fit differs from the in-core one or launched "
                             f"{launches} (expected {want})")
    return out


def golden_f64_data():
    """The golden oracle's example and synth counts, L and the seed of each
    fit's NumpyNoise, by name (F64_GOLDEN)."""
    from clonealign_torch.synth import simulate_multinomial

    ex = np.load(REPO / "data" / "example_sce.npz")
    sim = simulate_multinomial(N=5000, G=1000, C=4, seed=3, mean_total=2000)
    data = {"example": (ex["counts"], ex["copy_number"]), "synth": (sim.Y, sim.L)}
    return {name: (*data[name], seed) for name, seed in F64_GOLDEN}


def cpu_references_f64(out):
    """The CPU port's float64 fits that float64_phase holds the card's to,
    written to the .npz ``out``: the golden example and synth fits
    (F64_GOLDEN_KW, NumpyNoise draws, the PCA's sign fixed by
    :func:`signed_pca`), the fit past the old bound (PAST_F64) and the v1
    family's exact and Chebyshev fits at F64_V1's width. The script runs it in a child process
    (:func:`start_cpu_references_f64`) beside its first kernel checks."""
    import torch

    import clonealign_torch
    from clonealign_torch.synth import simulate_model3

    torch.set_num_threads(F64_CPU_THREADS)
    res = {}
    for name, (Y, L, seed) in golden_f64_data().items():
        t0 = time.perf_counter()
        with signed_pca():
            fit = clonealign_torch.clonealign(Y, L, device="cpu", noise=NumpyNoise(seed),
                                              **F64_GOLDEN_KW)
        res.update({f"{name}_clone": np.asarray(fit.clone),
                    f"{name}_elbo": fit.convergence_info.final_elbo,
                    f"{name}_n": fit.convergence_info.n_iters,
                    f"{name}_s": time.perf_counter() - t0})
    Y, L, X = past_f64_data()
    t0 = time.perf_counter()
    with signed_pca():
        fit = clonealign_torch.clonealign(Y, L, x=X, device="cpu",
                                          noise=NumpyNoise(PAST_F64_SEEDS[2]), **PAST_F64_KW)
    res.update({"past_clone": np.asarray(fit.clone), "past_elbo": fit.convergence_info.final_elbo,
                "past_n": fit.convergence_info.n_iters, "past_s": time.perf_counter() - t0})
    sim = simulate_model3(**F64_V1, seed=17)
    for impl in ("exact", "cheb"):
        t0 = time.perf_counter()
        fit = clonealign_torch.inference_em(sim.Y, sim.L, device="cpu", likelihood_impl=impl,
                                            **F64_V1_KW)
        res.update({f"v1_{impl}_labels": np.argmax(fit.clone_probs, 1),
                    f"v1_{impl}_elbo0": fit.elbo_trace[0], f"v1_{impl}_elbo": fit.final_elbo,
                    f"v1_{impl}_n": fit.n_iter, f"v1_{impl}_s": time.perf_counter() - t0})
    np.savez(out, **res)


@contextlib.contextmanager
def start_cpu_references_f64():
    """Run :func:`cpu_references_f64` in a child process (this script's
    interpreter, from the repository's root) while the block runs; yields a
    function that waits for it and returns its results. The child is
    stopped when the block ends."""
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "cpu_references_f64.npz")
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; chip_smoke.cpu_references_f64(sys.argv[1])", out],
            cwd=REPO)

        def results():
            if proc.wait(timeout=900) != 0:
                raise AssertionError(f"the CPU's float64 reference fits failed ({proc.returncode})")
            with np.load(out) as f:
                return {k: f[k] for k in f.files}

        try:
            yield results
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def golden_f64(clonealign_torch, fl, cpu):
    """The golden oracle's example and synth fits in float64 on the card
    (F64_GOLDEN_KW, NumpyNoise draws, the PCA's sign fixed by
    :func:`signed_pca`) against the CPU port's (``cpu``, the results of
    :func:`cpu_references_f64`, or a function that returns them): labels
    identical, the final ELBO within 1e-8 of the CPU's relative, and the
    float64 oracle's bar (:func:`golden`'s). Returns the card fits'
    launches and numbers, by name."""
    oracle = np.load(REPO / "tests" / "golden" / "tpu_parity_oracle.npz")
    found = {}
    for name, (Y, L, seed) in golden_f64_data().items():
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        with signed_pca():
            card = clonealign_torch.clonealign(Y, L, device="cuda", noise=NumpyNoise(seed),
                                               **F64_GOLDEN_KW)
        launches = launches_of(fl, "float64")
        card_s = time.perf_counter() - t0
        ref = cpu() if callable(cpu) else cpu
        ci, n = card.convergence_info, card.convergence_info.n_iters
        e_cpu = float(ref[f"{name}_elbo"])
        rel = abs(ci.final_elbo - e_cpu) / abs(e_cpu)
        same = list(card.clone) == ref[f"{name}_clone"].tolist()
        e64 = float(oracle[f"{name}_elbo64"])
        tol = max(1e-4 * abs(e64), 3.0 * ci.sd_final_elbo)
        probs = card.ml_params["clone_probs"]
        flips = np.flatnonzero(np.asarray(card.clone) != oracle[f"{name}_clone64"])
        off = [int(i) for i in flips if abs(probs[i].max() - 0.95) >= 0.01]
        log(f"golden {name} float64: card {card_s:.1f} s, CPU {float(ref[f'{name}_s']):.1f} s, "
            f"{n} iterations; final ELBO {ci.final_elbo:.12g} against the CPU's {e_cpu:.12g} "
            f"({rel:.3e} relative, bar 1e-8), labels {'identical' if same else 'DIFFER'}; "
            f"against the float64 oracle {e64:.8g}: |diff| {abs(ci.final_elbo - e64):.4g}, bar "
            f"{tol:.4g}; {len(flips)} labels differ from it, {len(off)} away from the 0.95 "
            f"threshold; launches (float64) {launches}")
        want = {"fwd": 2 + 2 * n + 20, "dpsi": n, "gene": n, "split": 0}
        if not (same and rel <= 1e-8 and n == int(ref[f"{name}_n"]) == GOLDEN_MAX_ITER):
            raise AssertionError(f"golden {name}: the float64 card fit differs from the CPU's")
        if not abs(ci.final_elbo - e64) < tol or off or launches != want:
            raise AssertionError(f"golden {name} float64 misses the oracle's bar or launched "
                                 f"{launches} (expected {want})")
        found[name] = {"launches": launches, "elbo_rel": rel, "card_s": card_s}
    return found


def negbin_f64(clonealign_torch, fl, cpu):
    """The v1 family's exact EM and Chebyshev fit in float64 on the card
    (F64_V1_KW) against the CPU port's (``cpu``, as :func:`golden_f64`'s)
    at F64_V1's width (model3 counts made with numpy): the same iterations
    and labels, the first E-step's ELBO within 1e-10 relative, the final
    one within 1e-3 (the bar tests/test_torch_negbin.py holds the port to
    the JAX package to after 30 iterations: the M-step's Adam divides each
    gradient by its running scale, so a gradient at rounding level moves
    its parameter by up to the learning rate, whichever way the card's or
    the CPU's rounding sends it), the accuracy bar, and no fused-likelihood
    launch."""
    from clonealign_torch.synth import simulate_model3

    sim = simulate_model3(**F64_V1, seed=17)
    fl.reset_launch_counts()
    found = {}
    for impl in ("exact", "cheb"):
        t0 = time.perf_counter()
        card = clonealign_torch.inference_em(sim.Y, sim.L, device="cuda", likelihood_impl=impl,
                                             **F64_V1_KW)
        card_s = time.perf_counter() - t0
        ref = cpu() if callable(cpu) else cpu
        e0, e_cpu = float(ref[f"v1_{impl}_elbo0"]), float(ref[f"v1_{impl}_elbo"])
        rel0 = abs(card.elbo_trace[0] - e0) / abs(e0)
        rel = abs(card.final_elbo - e_cpu) / abs(e_cpu)
        labels = np.argmax(card.clone_probs, 1)
        same = bool(np.array_equal(labels, ref[f"v1_{impl}_labels"]))
        acc = float(np.mean(labels == np.asarray(sim.clone_idx)))
        log(f"negbin float64 inference_em {impl} {F64_V1['N']}x{F64_V1['G']}x{F64_V1['C']}: card "
            f"{card_s:.2f} s, CPU {float(ref[f'v1_{impl}_s']):.2f} s, {card.n_iter} iterations; "
            f"first ELBO {card.elbo_trace[0]:.12g} against {e0:.12g} ({rel0:.3e} relative, bar "
            f"1e-10), final {card.final_elbo:.12g} against {e_cpu:.12g} ({rel:.3e} relative, bar "
            f"1e-3), labels {'identical' if same else 'DIFFER'}, accuracy {acc:.4f}")
        if not (same and rel0 <= 1e-10 and rel <= 1e-3
                and card.n_iter == int(ref[f"v1_{impl}_n"])):
            raise AssertionError(f"negbin float64 {impl}: the card differs from the CPU")
        if acc < MIN_ACCURACY:
            raise AssertionError(f"negbin float64 {impl}: accuracy {acc:.4f}")
        found[impl] = {"iterations": card.n_iter, "elbo0_rel": rel0, "elbo_rel": rel,
                       "card_s": card_s}
    launches = launches_of(fl)
    if any(launches.values()):
        raise AssertionError(f"negbin float64: the fused-likelihood kernels launched {launches}")
    return found


def float64_phase(clonealign_torch, fl, y_itemsize, cpu, kernels):
    """dtype="float64" on the card through the float64 kernel family: the
    full-width float64 fit under "auto" and with float64 Y, the z_cheb
    fit, the three-lane sweep as "vmap" and "map" (equal), the streamed
    fit (equal to the in-core one) and the full-width fit past the old
    bound (:func:`past_bound_f64_fit`), timed by host clocks, and the golden
    example and synth fits, the v1 family and the fit past the old bound
    (:func:`past_bound_f64`) against the CPU's ``cpu``
    (:func:`cpu_references_f64`'s results); ``kernels`` are
    :func:`float64_kernels`' checks, which ran beside the CPU's fits. Every
    launch of these paths is a float64 one. ``y_itemsize`` is the storage's
    "auto" resolves to. Returns the numbers for the kernels line."""
    t_phase = time.perf_counter()
    out = float64_fits(clonealign_torch, fl, y_itemsize)
    out.update(kernels)
    out["golden"] = golden_f64(clonealign_torch, fl, cpu)
    out["v1"] = negbin_f64(clonealign_torch, fl, cpu)
    out["past_fit"] = past_bound_f64(clonealign_torch, fl, cpu)
    log(f"float64 phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def float64_fits(clonealign_torch, fl, y_itemsize):
    """The float64 phase's full-width fits, z_cheb fit, sweeps, streamed
    fit and fit past the old bound on the synthetic counts
    (:func:`float64_phase`)."""
    from clonealign_torch.restarts import _sweep_bytes

    Y, L, z = synth_counts(3, FULL["N"], FULL["G"], FULL["C"])
    fits = {}
    for name, storage, itemsize in (("auto", "auto", y_itemsize), ("float64 Y", "float32", 8)):
        fits[name] = full_fit(clonealign_torch, fl, Y, L, z, storage, label=f"float64 {name}",
                              dtype="float64")
        plan = _sweep_bytes(FULL["N"], FULL["G"], FULL["C"], 1, 1, 1, 8, "cuda", itemsize) / 1e9
        log(f"  float64 {name}: {fits[name]['iter_ms']:.2f} ms an iteration, setup "
            f"{fits[name]['setup_s']:.2f} s, peak allocated in the inference "
            f"{fits[name]['peak_gb']:.3f} GB against restarts._sweep_bytes' {plan:.3f} GB")
        fits[name]["plan_gb"] = plan
    fl.reset_launch_counts()
    zc = clonealign_torch.clonealign(Y, L, device="cuda", max_iter=FIT_MAX_ITER, seed=0,
                                     verbose=False, likelihood_impl="z_cheb", dtype="float64")
    zc_launches = launches_of(fl, "float64")
    zc_acc = accuracy(zc, z)
    zn = zc.convergence_info.n_iters
    log(f"float64 z_cheb fit: {zn} iterations, "
        f"{1000 * zc.timings['loop'] / max(zn, 1):.2f} ms per iteration, final ELBO "
        f"{zc.convergence_info.final_elbo:.9g}, accuracy {zc_acc:.4f}, launches (float64) "
        f"{zc_launches}")
    if zc_acc < MIN_ACCURACY or zc_launches != {"fwd": 20, "dpsi": 0, "gene": 0, "split": 0}:
        raise AssertionError("the float64 z_cheb fit misses its accuracy or launches")
    sweeps = {b: run_sweep(clonealign_torch, fl, Y, L, z, f"float64 {b}", "xla", b, "auto",
                           y_itemsize, lanes=F64_LANES, dtype="float64") for b in ("vmap", "map")}
    if sweeps["vmap"]["ran"] != "vmap" or any(sweeps["vmap"][k] != sweeps["map"][k]
                                              for k in ("iterations", "labels", "launches")):
        raise AssertionError("the float64 sweep's lanes differ from its sequential restarts")
    streamed = f64_stream(clonealign_torch, fl, Y, L, z, fits["auto"])
    past = past_bound_f64_fit(clonealign_torch, fl, Y, L, z, y_itemsize)
    return {"fits": fits, "z_cheb": zc_launches, "sweeps": sweeps, "stream": streamed,
            "past_full_fit": past}


def float64_kernels(fl):
    """The float64 phase's kernel checks and full-width timings, by CUDA
    events only: the kernels' ptxas report, the DMMA and spill check of the
    forward's, dpsi's and the gene part's instantiations
    (:func:`check_f64_sass`) and an exp's FP64 instructions, each kernel
    against its plain float64 version at every Y storage at F64_CHECKS's
    and PAST_CHECKS's shapes and bit-identical across launches, timed at
    full width (F64_FULL x F64_FULL_STORAGES) beside its float64 bound and
    PR 17's time (``F64_PR17_MS``; dpsi's beside its earlier CUDA-core
    form's, ``F64_CUDA_CORE_DPSI_MS``), and past the old bound the split
    forward, dpsi alone, the split gene part alone and kernel_backward's
    one call beside their plain versions, bounds and the grouped forms'
    times (``PAST_F64_GROUPED_*``). For :func:`float64_phase`."""
    from clonealign_torch.ops import _build

    exp_ops, opcodes = exp_fp64_instructions()
    log(f"float64 phase: one double exp() is {exp_ops} FP64 instructions in the built SASS "
        f"({', '.join(opcodes)})")
    for kernel in ("fwd_f64_pack_kernel", "fwd_f64_kernel", "dpsi_f64_pack_kernel",
                   "dpsi_f64_kernel", "gene_f64_pack_kernel", "gene_f64_kernel",
                   "reduce_chunks_f64_kernel", "dlog_rfe_f64_kernel", "gene_product_f64_kernel",
                   "dpsi_product_f64_kernel", "dpsi_sum_f64_kernel"):
        res = kernel_resources(_build.build_log, kernel)
        log(f"{kernel} ptxas: " + "; ".join(f"{k} {r} registers, {st}/{ld} B spill stores/loads"
                                             for k, (r, st, ld) in sorted(res.items())))
    check_f64_sass(_build.build_log, fl)
    log(f"float64 kernels vs plain (tolerance: F64_RTOL={F64_RTOL:g} of the per-element "
        "absolute-term sum; each kernel launched twice, bit-identical)")
    for storage in F64_STORAGES:
        for shape, S, Kf in F64_CHECKS:
            check_kernels_f64(shape, S, Kf, seed=51, storage=storage)
    full = {(st, Kf, S): check_kernels_f64(FULL, S, Kf, seed=53, storage=st, reps=3,
                                           exp_ops=exp_ops)
            for st in F64_FULL_STORAGES for Kf, S in F64_FULL}
    for (st, Kf, S), r in full.items():
        r["resources"] = f64_resources(fl, st, Kf, 0, S * FULL["C"], FULL["N"], FULL["G"])
        pr17 = F64_PR17_MS[(st, Kf, S)] or (None,) * 3
        line = ", ".join(
            f"{part} {r[f'{part}_ms']:.3f} ms (PR 17 {'not timed' if old is None else old}, "
            f"plain {r[f'{part}_plain_ms']:.3f}, bound "
            f"{r['bounds'][part][0]:.3f} by {r['bounds'][part][2]}, "
            f"{r['bounds'][part][0] / r[f'{part}_ms']:.3f} of it; "
            f"{r['resources'][part]['smem_bytes']} B shared memory, "
            f"{r['resources'][part]['blocks_per_sm']} blocks an SM)"
            for part, old in zip(("fwd", "dpsi", "gene"), pr17))
        log(f"float64, full width, Y {st}, Kf={Kf} S*C={S * FULL['C']}: {line}; dpsi's "
            f"CUDA-core form took {F64_CUDA_CORE_DPSI_MS[(st, Kf, S)]} ms")
    bound_res = f64_resources(fl, "float64", 64, 64, 2048, FULL["N"], FULL["G"])
    log(f"float64, full width, every bound (Kf 64, S 64, S*C 2048): {bound_res}")
    log("float64 kernels past the old bound (Kf 64, S 64, S*C 2,048) vs plain")
    past = []
    for st in F64_STORAGES:
        for shape, S, Kf in PAST_CHECKS:
            r = check_kernels_f64(shape, S, Kf, seed=57, storage=st)
            past.append({"shape": f"{shape['N']}x{shape['G']}", "y_storage": st, "kf": Kf,
                         "s": S, "sc": S * shape["C"], "errs": r["errs"],
                         "bwd_errs": r["bwd_errs"]})
    Kf, SC = PAST_K + PAST_BATCHES, PAST_S * FULL["C"]
    past_full = check_kernels_f64(FULL, PAST_S, Kf, seed=58, storage="int8", reps=2,
                                  exp_ops=exp_ops, vjp_parts=True, batch=2)
    past_full["resources"] = f64_resources(fl, "int8", Kf, 0, SC, FULL["N"], FULL["G"])
    grouped = {"fwd": PAST_F64_GROUPED_FWD_MS, "dpsi": PAST_F64_GROUPED_DPSI_MS,
               "gene": PAST_F64_GROUPED_GENE_MS,
               "bwd": "the grouped dpsi and the split gene part, two calls"}
    log(f"float64, full width, past the old bound, Y int8, Kf={Kf} S={PAST_S} S*C={SC} (the "
        "split forward, dpsi alone, the split gene part alone and kernel_backward's one call; "
        "before: the grouped forms, PR 22): "
        + ", ".join(f"{part} {past_full[f'{part}_ms']:.3f} ms (before {grouped[part]}; plain "
                    f"{past_full[f'{part}_plain_ms']:.3f}, bound {past_full['bounds'][part][0]:.3f} "
                    f"by {past_full['bounds'][part][2]})"
                    for part in ("fwd", "dpsi", "gene", "bwd")))
    for n_a2 in (0, PAST_S):
        for part, q in f64_resources(fl, "int8", Kf, n_a2, SC, FULL["N"], FULL["G"]).items():
            log(f"  A2 columns {n_a2}: {part}: {q}")
    return {"exp_ops": exp_ops, "full": full, "bound_resources": bound_res, "past": past,
            "past_full": past_full}


def f64_kernels(f64, auto_name):
    """The float64 family's entries of the kernels line: the numbers at the
    main path's widths (Kf 1, S*C 10) and the storage "auto" resolves to,
    each full-width configuration's under ``by_config``, and each float64
    path's launches. No single PyTorch call computes any of the three
    functions: library_ms is null."""
    st = auto_name if auto_name in F64_FULL_STORAGES else F64_FULL_STORAGES[0]
    main = f64["full"][(st, 1, 1)]
    src = "clonealign_torch/ops/csrc/fused_likelihood_f64.cu"
    fwd_at = "clonealign_tpu/ops/fused_likelihood.py:125 (jnp.dot branches :91, :102, :105)"
    bwd_at = ("clonealign_tpu/ops/fused_likelihood.py:234 (jnp.dot branches :182, :187, "
              ":201-202, :211, :213)")
    fits, sweeps = f64["fits"], f64["sweeps"]
    paths = (("float64 fit y_storage=auto", fits["auto"]["launches"]),
             ("float64 fit y_storage=float32 (float64 Y)", fits["float64 Y"]["launches"]),
             ("float64 z_cheb fit", f64["z_cheb"]),
             *((f"float64 sweep, {F64_LANES['n_repeats']} restarts, {b}", sweeps[b]["launches"])
               for b in ("vmap", "map")),
             (f"float64 streaming fit, {f64['stream']['n_chunks']} chunks, fresh",
              f64["stream"]["launches"]),
             ("golden example float64", f64["golden"]["example"]["launches"]),
             ("golden synth float64", f64["golden"]["synth"]["launches"]),
             (f"float64 fit past the old bound {PAST_F64['N']}x{PAST_F64['G']}x{PAST_F64['C']} "
              f"K={PAST_K} P={PAST_BATCHES} mc_samples={PAST_S}", f64["past_fit"]["launches"]))
    out = []
    for name, part, at, err in (
            ("fwd_f64_kernel", "fwd", fwd_at, ("A1", "Z", "YW")),
            ("dpsi_f64_kernel", "dpsi", bwd_at, ("dpsi",)),
            ("gene_f64_kernel+reduce_chunks_f64_kernel", "gene", bwd_at, ("dW", "dmuL"))):
        b = main["bounds"][part]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": at,
            "launches": fits["auto"]["launches"][part],
            "max_abs_err": max(main["errs"][e] for e in err),
            "ms": main[f"{part}_ms"], "plain_ms": main[f"{part}_plain_ms"],
            "bound_ms": b[0], "bound_by": b[1], "bound_unit": b[2], "library_ms": None,
            "bound_fraction": b[0] / main[f"{part}_ms"], "exp_fp64_instructions": f64["exp_ops"],
            **main["resources"][part], "y_storage": st, "kf": 1, "sc": FULL["C"],
            "by_config": [{"y_storage": s, "kf": Kf, "sc": S * FULL["C"],
                           "ms": r[f"{part}_ms"], "plain_ms": r[f"{part}_plain_ms"],
                           "bound_ms": r["bounds"][part][0], "bound_by": r["bounds"][part][1],
                           "bound_unit": r["bounds"][part][2],
                           "bound_fraction": r["bounds"][part][0] / r[f"{part}_ms"],
                           **r["resources"][part],
                           "max_abs_err": max(r["errs"][e] for e in err)}
                          for (s, Kf, S), r in f64["full"].items()],
            "past_bound_checks": [{k: v for k, v in c.items() if k not in ("errs", "bwd_errs")}
                                  | {"max_abs_err": max(c["errs"][e] for e in err)}
                                  for c in f64["past"]],
            "paths": [{"path": p, "launches": n[part]} for p, n in paths],
        })
    past, Kf, SC = f64["past_full"], PAST_K + PAST_BATCHES, PAST_S * FULL["C"]
    full_fit_ = f64["past_full_fit"]
    paths = ((f"float64 fit past the old bound {FULL['N']}x{FULL['G']}x{FULL['C']} K={PAST_K} "
              f"P={PAST_BATCHES} mc_samples={PAST_S} y_storage=auto, {full_fit_['n_iters']} "
              "iterations", full_fit_["launches"]),
             (f"float64 fit past the old bound {PAST_F64['N']}x{PAST_F64['G']}x{PAST_F64['C']} "
              f"K={PAST_K} P={PAST_BATCHES} mc_samples={PAST_S}", f64["past_fit"]["launches"]))
    # past the bound the fit's backward is kernel_backward's one call
    # (counted in split); kernel_dpsi's and kernel_gene's split forms,
    # which no path of the port calls, stand under "parts", each held
    # against the plain VJP and timed beside its terms
    res = past["resources"]
    for name, part, launches, err, resources, parts in (
            ("dlog_rfe_f64_kernel (rfe, A1)+dpsi_product_f64_kernel+dpsi_sum_f64_kernel (Z)"
             "+fwd_f64_kernel (Y products)", "fwd", "fwd", ("A1", "Z", "YW"),
             dict(res["fwd"], rfe=res["rfe"], product=res["product"]), ()),
            ("dlog_rfe_f64_kernel+gene_product_f64_kernel+dpsi_product_f64_kernel"
             "+dpsi_sum_f64_kernel", "bwd", "split", ("dpsi", "dW", "dmuL"),
             {"resources": [res[k] for k in ("gene", "gene_products", "product")]},
             (("kernel_dpsi: dlog_rfe_f64_kernel without Y (t)+dpsi_product_f64_kernel"
               "+dpsi_sum_f64_kernel", "dpsi", ("dpsi",)),
              ("kernel_gene: dlog_rfe_f64_kernel+gene_product_f64_kernel", "gene",
               ("dW", "dmuL"))))):
        b = past["bounds"][part]
        errs = past["bwd_errs"] if part == "bwd" else past["errs"]
        out.append({
            "name": f"{name} past the old bound (Kf {Kf}, S {PAST_S}, S*C {SC})", "route": "cuda",
            "source": src, "replaces": fwd_at if part == "fwd" else bwd_at,
            "launches": full_fit_["launches"][launches],
            "max_abs_err": max(errs[e] for e in err),
            "ms": past[f"{part}_ms"], "plain_ms": past[f"{part}_plain_ms"],
            "bound_ms": b[0], "bound_by": b[1], "bound_unit": b[2], "library_ms": None,
            "bound_fraction": b[0] / past[f"{part}_ms"], **resources,
            "bit_identical_launches": past["identical"],
            "y_storage": "int8", "kf": Kf, "s": PAST_S, "sc": SC,
            "past_bound_checks": [
                {k: v for k, v in c.items() if k not in ("errs", "bwd_errs")}
                | {"max_abs_err": max(c["bwd_errs" if part == "bwd" else "errs"][e] for e in err)}
                for c in f64["past"]],
            "paths": [{"path": p, "launches": n[launches]} for p, n in paths],
            **({"parts": [{"name": p_name, "launches": 0, "ms": past[f"{p}_ms"],
                           "plain_ms": past[f"{p}_plain_ms"],
                           "bound_ms": past["bounds"][p][0], "bound_by": past["bounds"][p][1],
                           "max_abs_err": max(past["errs"][e] for e in p_err),
                           "resources": res[p]}
                          for p_name, p, p_err in parts]} if parts else {}),
        })
    return out


# ---------------------------------------------------------------------------
# The distributed fit (clonealign_torch.parallel)
# ---------------------------------------------------------------------------

DIST_WORLD = 2  # ranks sharing the one card over gloo in (b)-(e)
# the genes axis's meshes: (f) 1 x 2, (g) 2 x 2, ranks sharing the card over gloo
DIST_GENE_MESHES = {"f": (1, 2), "g": (2, 2)}
DIST_F64 = dict(N=20_000, G=2_000, C=10)  # the two-rank float64 sweep's counts
DIST_F64_LANES = dict(initial_shrinks=(5,), n_repeats=3, max_iter=100, elbo_eval="reuse")
DIST_STREAM_CHUNK = 12_500  # cells a chunk: four of each rank's 50,000
DIST_TIMEOUT = 900  # seconds the ranks, and each collective of their group, may take


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class CollectiveClock:
    """Counts the ``torch.distributed.all_reduce`` calls made inside the
    block and, with ``timed``, the host seconds they take, each timed
    between two synchronizes of the card, so that the work queued before it
    is not charged to it (without ``timed`` nothing is synchronized).
    ``groups`` names process groups (a mesh's cells and genes groups):
    ``by_group[name]`` holds the calls and seconds of the all_reduces made
    over each, "other" those over any other group."""

    def __init__(self, timed=True, groups=None):
        self.timed = timed
        self.groups = dict(groups or {})

    def _name(self, kwargs):
        group = kwargs.get("group")
        return next((n for n, g in self.groups.items() if g is not None and g is group), "other")

    def __enter__(self):
        import torch
        import torch.distributed as tdist

        self.calls, self.seconds, self.original = 0, 0.0, tdist.all_reduce
        self.by_group = {name: [0, 0.0] for name in list(self.groups) + ["other"]}

        def timed(*args, **kwargs):
            tally = self.by_group[self._name(kwargs)]
            if not self.timed:
                self.calls += 1
                tally[0] += 1
                return self.original(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return self.original(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                self.seconds += seconds
                self.calls += 1
                tally[0] += 1
                tally[1] += seconds

        tdist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist

        tdist.all_reduce = self.original


def label_accuracy(labels, C, z_true) -> float:
    """:func:`accuracy` of clone labels named as the fit names C clones."""
    from clonealign_torch.api import _default_clone_names

    index = {name: i for i, name in enumerate(_default_clone_names(C))}
    return float(np.mean(np.asarray([index.get(c, -1) for c in labels]) == z_true))


def distributed_rank(rank, world, genes, port, paths, queue):
    """One rank of the distributed phase's runs (b)-(e) (a 2 x 1 mesh), (f)
    (1 x 2) or (g) (2 x 2), in a process of its own on the card: puts
    ``(rank, results)`` on ``queue``, or ``(rank, traceback)`` when it
    fails, and then exits nonzero."""
    import traceback

    try:
        queue.put((rank, distributed_runs(rank, world, genes, port, paths)))
    except Exception:  # the parent fails the phase with this rank's traceback
        queue.put((rank, traceback.format_exc()))
        raise


def distributed_runs(rank, world, genes, port, paths):
    """Each run through its public entry point with ``mesh=make_mesh(
    gene_parallelism=genes)`` in a gloo group of ``world`` ranks on the
    card, the counts memory-mapped, so that the rank reads its cell block's
    rows and uploads only its tile: on the 2 x 1 mesh (b) the ten-restart
    full-width sweep, (c) the float64 sweep, (d) the streamed fit and (e)
    the v1 fit; on the 1 x 2 mesh (f) the sweep; on the 2 x 2 mesh (g1)
    the sweep, (g2) the float64 sweep, (g3) the streamed fit and (g4) the
    v1 fit. Each run's launches are counted from zero and its collectives
    counted and timed by group (:class:`CollectiveClock`)."""
    import torch
    import torch.distributed as tdist

    import clonealign_torch
    from clonealign_torch.ops import fused_likelihood as fl
    from clonealign_torch.parallel import distributed as dist
    from clonealign_torch.parallel import sharding

    torch.cuda.set_device(0)
    # the ranks share the host's cores: each takes its part of them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                    timeout_seconds=DIST_TIMEOUT)
    out = {}
    try:
        mesh = sharding.make_mesh(gene_parallelism=genes)
        out["device"] = str(mesh.device)
        out["coords"] = (mesh.cell_coord, mesh.gene_coord)
        # copy-on-write maps: the rows are read from the map in place (a
        # read-only map's rows would be copied out once more, a chunk a step)
        Y, L = np.load(paths["Y"], mmap_mode="c"), np.load(paths["L"])
        Y64, L64 = np.load(paths["Y64"], mmap_mode="r"), np.load(paths["L64"])
        Ynb, Lnb = np.load(paths["Ynb"], mmap_mode="r"), np.load(paths["Lnb"])
        sweep = ("narrow", lambda: clonealign_torch.run_clonealign(
            Y, L, mesh=mesh, seed=0, verbose=False, **LANES))
        sweep64 = ("float64", lambda: clonealign_torch.run_clonealign(
            Y64, L64, mesh=mesh, seed=0, verbose=False, dtype="float64", **DIST_F64_LANES))
        streamed = ("narrow", lambda: clonealign_torch.fit_streaming(
            Y, L, mesh=mesh, chunk_cells=DIST_STREAM_CHUNK, max_iter=FIT_MAX_ITER, seed=0,
            verbose=False, elbo_eval="reuse"))
        v1 = ("narrow", lambda: sharding.sharded_negbin_fit(
            Ynb, Lnb, mesh, max_iter=NEGBIN_MAX_ITER, rel_tol=1e-6))
        runs = {(DIST_WORLD, 1): dict(b=sweep, c=sweep64, d=streamed, e=v1),
                (2, 2): dict(f=sweep),
                (4, 2): dict(g1=sweep, g2=sweep64, g3=streamed, g4=v1)}[(world, genes)]
        for name, (family, run) in runs.items():
            fl.reset_launch_counts()
            tdist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with CollectiveClock(groups={"cells": mesh.cell_group,
                                         "genes": mesh.gene_group}) as clock:
                fit = run()
            torch.cuda.synchronize()
            row = dict(wall=time.perf_counter() - t0, launches=launches_of(fl, family),
                       collective_calls=clock.calls, collective_s=clock.seconds,
                       by_group=clock.by_group)
            if name in ("e", "g4"):
                rows = dist.process_cell_slice(Ynb.shape[0], mesh=mesh)
                row.update(gamma=fit.post.gamma.cpu().numpy(), final_elbo=fit.final_elbo,
                           rho=fit.post.r.cpu().numpy() > 0.5, iterations=[fit.n_iter],
                           loop_s=fit.loop_seconds, rows=(rows.start, rows.stop))
            else:
                row.update(labels=fit.clone, loop_s=fit.timings["loop"],
                           final_elbo=fit.convergence_info.final_elbo,
                           sd_final=fit.convergence_info.sd_final_elbo,
                           iterations=fit.timings.get("iterations",
                                                      [fit.convergence_info.n_iters]))
                if fit.multirun_info is not None:
                    row["elbos"] = np.asarray(fit.multirun_info["elbos"])
            out[name] = row
    finally:
        tdist.destroy_process_group()
    return out


def spawn_ranks(paths, world=DIST_WORLD, genes=1):
    """Run :func:`distributed_rank` as ``world`` spawned processes on a
    ``(world // genes) x genes`` mesh and return each rank's results. A
    rank's exception, a rank that exits nonzero or a run past DIST_TIMEOUT
    fails the phase; every process is stopped before this returns."""
    import queue as queue_module

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=distributed_rank, args=(r, world, genes, port, paths, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = {}
    deadline = time.perf_counter() + DIST_TIMEOUT
    try:
        while len(got) < world:
            try:
                rank, value = results.get(timeout=max(1.0, deadline - time.perf_counter()))
            except queue_module.Empty:
                raise AssertionError(f"distributed phase: no result from ranks "
                                     f"{sorted(set(range(world)) - set(got))} within "
                                     f"{DIST_TIMEOUT} s") from None
            if isinstance(value, str):
                raise AssertionError(f"distributed phase: rank {rank} failed:\n{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.perf_counter()))
            if p.exitcode != 0:
                raise AssertionError(f"distributed phase: a rank exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _collectives(r, row):
    steps = max(row["iterations"])
    text = (f"rank {r}: {row['wall']:.2f} s wall, loop {1000 * row['loop_s'] / steps:.2f} ms a "
            f"step, collectives {1000 * row['collective_s'] / steps:.3f} ms a step "
            f"({row['collective_calls']} all_reduce calls in the run")
    calls, seconds = row["by_group"]["genes"]
    if calls:
        text += (f"; the genes group's {calls} calls, {1000 * seconds / steps:.3f} ms a step, "
                 f"{calls / steps:.1f} calls a step")
    return text + ")"


def _check_sweep(label, where, r, row, ref, z):
    """(b), (f), (g1): a rank's ten-restart sweep against the one-process
    sweep ``ref``: launches equal, final ELBOs within rel 1e-4, calls on
    99.9% of the cells, accuracy 0.99. True when it passes."""
    rel = float(np.max(np.abs(row["elbos"] - ref["elbos"]) / np.abs(ref["elbos"])))
    agree = float(np.mean(np.asarray(row["labels"]) == np.asarray(ref["labels"])))
    acc = label_accuracy(row["labels"], FULL["C"], z)
    row.update(rel=rel, agree=agree, accuracy=acc,
               lane_iter_ms=1000 * row["loop_s"] / sum(row["iterations"]))
    log(f"distributed {label} {where}, the ten-restart sweep on {row['device']}, "
        f"{_collectives(r, row)}; {row['lane_iter_ms']:.3f} ms per lane iteration (one process "
        f"{ref['lane_iter_ms']:.3f}); launches {row['launches']}; final ELBOs max rel diff "
        f"{rel:.3e} (bar 1e-4); calls agree on {agree:.5f} of the cells (bar 0.999); accuracy "
        f"{acc:.4f}")
    return (row["launches"] == ref["launches"] and rel <= 1e-4 and agree >= 0.999
            and acc >= MIN_ACCURACY)


def _check_sweep64(label, where, r, row, ref64, ref64_launches):
    """(c), (g2): the float64 sweep against the one-process float64 sweep:
    iterations, calls and launches equal, final ELBOs within rel 1e-9."""
    rel = float(np.max(np.abs(row["elbos"] - ref64.multirun_info["elbos"])
                       / np.abs(ref64.multirun_info["elbos"])))
    row.update(rel=rel, lane_iter_ms=1000 * row["loop_s"] / sum(row["iterations"]))
    same = row["labels"] == ref64.clone and row["iterations"] == ref64.timings["iterations"]
    ref64_ms = 1000 * ref64.timings["loop"] / sum(ref64.timings["iterations"])
    log(f"distributed {label} {where}, float64 sweep {DIST_F64['N']}x{DIST_F64['G']}x"
        f"{DIST_F64['C']}, 3 restarts, {_collectives(r, row)}; {row['lane_iter_ms']:.3f} ms per "
        f"lane iteration (one process {ref64_ms:.3f}); launches {row['launches']} (one process "
        f"{ref64_launches}); final ELBOs max rel diff {rel:.3e} (bar 1e-9); iterations and calls "
        f"{'equal' if same else 'DIFFER'}")
    return rel <= 1e-9 and same and row["launches"] == ref64_launches


def _check_stream(label, where, r, row, stream_ref, cells_per_rank):
    """(d), (g3): fit_streaming(mesh=) against the one-process streamed fit:
    iterations and calls equal, the final ELBO within the streaming bar,
    each rank's launches its chunks'."""
    n = row["iterations"][0]
    chunks = -(-cells_per_rank // DIST_STREAM_CHUNK)
    want = {"fwd": chunks * (2 + n + 20), "dpsi": chunks * n, "gene": chunks * n}
    diff = abs(row["final_elbo"] - stream_ref["final_elbo"])
    bar = max(1e-4 * abs(stream_ref["final_elbo"]), 3.0 * stream_ref["sd_final"])
    same = row["labels"] == stream_ref["labels"] and n == stream_ref["n_iters"]
    row.update(diff=diff, bar=bar, iter_ms=1000 * row["loop_s"] / max(n, 1))
    log(f"distributed {label} {where}, fit_streaming(mesh=) in {chunks} chunks of "
        f"{DIST_STREAM_CHUNK} a rank, {_collectives(r, row)}; {row['iter_ms']:.2f} ms an "
        f"iteration (one process {stream_ref['iter_ms']:.2f}); launches {row['launches']} "
        f"(expected {want}); final ELBO |diff| {diff:.6g} (bar {bar:.6g}); iterations and calls "
        f"{'equal' if same else 'DIFFER'}")
    return row["launches"] == want and diff <= bar and same


def _check_v1(label, where, ranks, name, negbin_ref, znb):
    """(e), (g4): sharded_negbin_fit against the one-process exact fit:
    accuracy 1.0, calls and the dosage mask equal, final ELBO within rel
    1e-4 (the JAX package's own mesh bars), every rank's final ELBO the
    same and no fused-likelihood launch."""
    rows = {tuple(rank[name]["rows"]): rank[name]["gamma"] for rank in ranks}
    labels = np.argmax(np.concatenate([rows[k] for k in sorted(rows)]), 1)
    first = ranks[0][name]
    acc = float(np.mean(labels == znb))
    agree = float(np.mean(labels == negbin_ref["labels"]))
    rel = abs(first["final_elbo"] - negbin_ref["final_elbo"]) / abs(negbin_ref["final_elbo"])
    rho_same = all(bool(np.array_equal(rank[name]["rho"], negbin_ref["rho"])) for rank in ranks)
    same = all(rank[name]["final_elbo"] == first["final_elbo"] for rank in ranks)
    for r, rank in enumerate(ranks):
        row = rank[name]
        log(f"distributed {label} {where}, sharded_negbin_fit {NEGBIN['N']}x{NEGBIN['G']}x"
            f"{NEGBIN['C']}, {_collectives(r, row)}; {row['iterations'][0]} iterations "
            f"(one process {negbin_ref['iterations']}), "
            f"{row['loop_s'] / max(row['iterations'][0], 1):.4f} s an iteration, "
            f"fused-likelihood launches {sum(row['launches'].values())} (expected 0)")
    log(f"distributed {label}: accuracy {acc:.4f} (bar 1.0), calls agree with the one-process "
        f"exact fit on {agree:.5f} of the cells, dosage mask {'equal' if rho_same else 'DIFFERS'}, "
        f"final ELBO rel diff {rel:.3e} (bar 1e-4); every rank's final ELBO "
        f"{'equal' if same else 'DIFFERS'}")
    return dict(accuracy=acc, agree=agree, rel=rel, iterations=first["iterations"][0],
                s_per_iter=first["loop_s"] / max(first["iterations"][0], 1),
                ok=(acc >= 1.0 and agree >= 1.0 and rho_same and rel <= 1e-4 and same
                    and not any(any(rank[name]["launches"].values()) for rank in ranks)))


def distributed_phase(clonealign_torch, fl, Y, L, z, sweep_ref, stream_ref, negbin_ref, card):
    """The distributed fit (``clonealign_torch.parallel``) on the card.

    (a) ``run_clonealign(mesh=make_mesh())`` in an NCCL group of one rank,
    whose mesh builds its cells and genes subgroups: the full-width
    ten-restart sweep against the one-process sweep ``sweep_ref`` (sweep
    (b)): launches equal, final ELBOs equal to the bit, clone calls
    identical, and the step's all_reduce made over the cells subgroup's
    NCCL (at least one a step). Then ranks share the card over gloo (CUDA
    tensors; NCCL refuses two ranks on one GPU), each holding and
    uploading only its tile. On a 2 x 1 mesh: (b) the same sweep, each
    rank's launches equal to the one-process sweep's, final ELBOs within
    rel 1e-4, calls agreeing on 99.9% of the cells, accuracy 0.99; (c) a
    float64 sweep at DIST_F64 against the one-process float64 sweep
    (iterations and calls equal, final ELBOs within rel 1e-9); (d)
    ``fit_streaming(mesh=)`` in chunks of DIST_STREAM_CHUNK cells (four a
    rank) against the one-process streamed fit ``stream_ref`` (iterations,
    calls, final ELBO within the streaming bar, each rank's launches its
    chunks'); (e) ``sharded_negbin_fit`` on the v1 phase's model3 counts
    and iteration cut against its exact fit ``negbin_ref`` (accuracy 1.0,
    calls and dosage mask equal, final ELBO within rel 1e-4, the bar of
    the JAX package's own mesh fit). On the genes axis's meshes
    (``make_mesh(gene_parallelism=2)``): (f) 1 x 2, (b)'s sweep with (b)'s
    bars, each rank 100,000 x 2,500; (g) 2 x 2, (g1) the same sweep (50,000
    x 2,500 a rank), (g2)-(g4) the runs and bars of (c)-(e). Each line
    prints the genes group's all_reduce calls and ms a step beside the
    card's name and power limit ``card``. Returns the numbers it prints."""
    import torch.distributed as tdist

    from clonealign_torch.parallel import distributed as dist
    from clonealign_torch.parallel import sharding

    t_phase = time.perf_counter()
    dist.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                    timeout_seconds=DIST_TIMEOUT)
    try:
        mesh = sharding.make_mesh()
        subgroups = mesh.cell_group is not None and mesh.gene_group is not None
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        with CollectiveClock(timed=False, groups={"cells": mesh.cell_group}) as clock:
            fit = clonealign_torch.run_clonealign(Y, L, mesh=mesh, seed=0, verbose=False,
                                                  **LANES)
        wall_a = time.perf_counter() - t0
        launches_a = launches_of(fl)
    finally:
        tdist.destroy_process_group()
    iters = fit.timings["iterations"]
    cell_calls = clock.by_group["cells"][0]
    out = {"a": dict(wall=wall_a, launches=launches_a, collective_calls=clock.calls,
                     lane_iter_ms=1000 * fit.timings["loop"] / sum(iters),
                     rel=float(np.max(np.abs(fit.multirun_info["elbos"] - sweep_ref["elbos"])
                                      / np.abs(sweep_ref["elbos"]))),
                     same=fit.clone == sweep_ref["labels"])}
    a = out["a"]
    log(f"distributed (a) NCCL, one rank on {mesh.device} [{card}]: run_clonealign(mesh="
        f"make_mesh()) {FULL['N']}x{FULL['G']}x{FULL['C']}, 10 restarts: {wall_a:.2f} s wall, "
        f"{a['lane_iter_ms']:.3f} ms per lane iteration; launches {launches_a} (one-process "
        f"sweep {sweep_ref['launches']}); final ELBOs max rel diff {a['rel']:.3e} (bar: equal); "
        f"clone calls {'identical' if a['same'] else 'DIFFER'}; cells and genes subgroups "
        f"{'built' if subgroups else 'MISSING'}; {clock.calls} NCCL all_reduces, {cell_calls} "
        f"over the cells subgroup, for {max(iters)} steps (at least one a step)")
    if launches_a != sweep_ref["launches"] or a["rel"] != 0.0 or not a["same"] or \
            not subgroups or cell_calls < max(iters):
        raise AssertionError("distributed (a): the NCCL world of one differs from the sweep")
    del fit

    # the counts the ranks read: the full-width ones, the float64 sweep's
    # (beside its one-process sweep) and the v1 phase's model3 counts
    Y64, L64, z64 = synth_counts(6, DIST_F64["N"], DIST_F64["G"], DIST_F64["C"])
    fl.reset_launch_counts()
    ref64 = clonealign_torch.run_clonealign(Y64, L64, device="cuda", seed=0, verbose=False,
                                            dtype="float64", **DIST_F64_LANES)
    ref64_launches = launches_of(fl, "float64")
    genes = model3_genes(41, NEGBIN["G"], NEGBIN["C"])
    Ynb, znb = model3_cells(genes, 42, NEGBIN["N"])
    meshes = {"b": (DIST_WORLD, 1)}
    meshes.update(DIST_GENE_MESHES)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {name: str(Path(tmp) / f"{name}.npy")
                 for name in ("Y", "L", "Y64", "L64", "Ynb", "Lnb")}
        for name, arr in (("Y", Y), ("L", L), ("Y64", Y64), ("L64", L64),
                          ("Ynb", Ynb.cpu().numpy()),
                          ("Lnb", genes["L"].cpu().numpy().astype(np.float64))):
            np.save(paths[name], arr)
        del Ynb
        runs = {}
        for key, (cells, gene_blocks) in meshes.items():
            t0 = time.perf_counter()
            runs[key] = spawn_ranks(paths, cells * gene_blocks, gene_blocks)
            out[f"spawn_wall_{key}"] = time.perf_counter() - t0
    out["spawn_wall"] = out["spawn_wall_b"]

    def where(key):
        cells, gene_blocks = meshes[key]
        return (f"[gloo, {cells * gene_blocks} ranks as a {cells}x{gene_blocks} (cells, genes) "
                f"mesh sharing one card, {card}: correctness and the collectives' cost, not "
                f"scale-out]")

    bad = []
    for key, sweep, sweep64, streamed, v1 in (("b", "b", "c", "d", "e"),
                                              ("f", "f", None, None, None),
                                              ("g", "g1", "g2", "g3", "g4")):
        ranks = runs[key]
        cells_per_rank = FULL["N"] // meshes[key][0]
        for r, rank in enumerate(ranks):
            rank[sweep]["device"] = rank["device"]
            if not _check_sweep(f"({sweep})", where(key), r, rank[sweep], sweep_ref, z):
                bad.append(f"({sweep}) rank {r}")
            if sweep64 and not _check_sweep64(f"({sweep64})", where(key), r, rank[sweep64],
                                              ref64, ref64_launches):
                bad.append(f"({sweep64}) rank {r}")
            if streamed and not _check_stream(f"({streamed})", where(key), r, rank[streamed],
                                              stream_ref, cells_per_rank):
                bad.append(f"({streamed}) rank {r}")
        if v1:
            out[v1] = _check_v1(f"({v1})", where(key), ranks, v1, negbin_ref, znb)
            if not out[v1]["ok"]:
                bad.append(f"({v1})")
        out[key] = ranks
    out["ranks"] = runs["b"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"distributed phase: {out['seconds']:.1f} s (the ranks' processes: " + ", ".join(
        f"{k} {out[f'spawn_wall_{k}']:.1f} s" for k in meshes) + ")")
    if bad:
        raise AssertionError("distributed phase misses its bars: " + ", ".join(bad))
    return out


class Steps:
    """The seconds of each step of the script, logged as each ends."""

    def __init__(self):
        self.t, self.seconds = time.perf_counter(), {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now
        log(f"step {name}: {self.seconds[name]:.1f} s")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1

    import clonealign_torch
    from clonealign_torch import api, stream
    from clonealign_torch.ops import _build
    from clonealign_torch.ops import fused_likelihood as fl

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")

    # 2. build, always from the sources, so that ptxas reports on this run's
    # kernels. Until the first host-timed fit (step 4) only CUDA events time
    # anything, so the CPU's float64 reference fits (float64_phase's) run in
    # a child process beside the build and the kernel checks, and step 4
    # waits for their end
    steps = Steps()
    with start_cpu_references_f64() as cpu_references:
        _build.library_path().unlink(missing_ok=True)
        t0 = time.perf_counter()
        _build.build()
        log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.library_path().name}")
        if _build.build_log:
            log(_build.build_log.strip())
        log_tc_resources(_build.build_log, fl)
        steps.done("2 build")

        # 3. kernels vs plain: for every Y storage a ragged shape (scalar Y
        # loads) and one with G % 4 == 0 (vectorized loads), a wide shape,
        # then full width for the storages a fit uses
        log("kernels vs plain (tolerance: KERNEL_RTOL="
            f"{KERNEL_RTOL:g} of the per-element absolute-term sum)")
        for storage in STORAGES:
            for Kf in (1, 3, 4):
                check_kernels(SMALL, S=1, Kf=Kf, seed=1, reps=5, storage=storage)
            for Kf in (2, 3, 4):
                check_kernels(VEC, S=1, Kf=Kf, seed=3, reps=5, storage=storage)
            check_kernels(RICH, S=3, Kf=4, seed=7, reps=5, storage=storage)
        check_kernels(WIDE, S=2, Kf=3, seed=5, reps=5)
        full = {st: check_kernels(FULL, S=1, Kf=1, seed=2, reps=10, storage=st)
                for st in FULL_STORAGES}
        full_kf = {(st, Kf): check_kernels(FULL, S=1, Kf=Kf, seed=6, reps=10, storage=st)
                   for st in FULL_KF_STORAGES for Kf in FULL_KF}
        steps.done("3 kernels vs plain")

        # 3b. the full-width counts, and the wide and float64 families'
        # kernel checks (steps 11 and 12 run their fits)
        t0 = time.perf_counter()
        Y, L, z = synth_counts(3, FULL["N"], FULL["G"], FULL["C"])
        log(f"synthetic counts {Y.shape} int16 on the card -> host: "
            f"{time.perf_counter() - t0:.1f} s")
        auto = api._auto_y_storage(Y)
        auto_name = "float32" if auto is None else str(auto).removeprefix("torch.")
        y_itemsize = 4 if auto is None else auto.itemsize
        log(f'y_storage="auto" resolves to {auto_name} on the card for these counts (largest '
            f"{int(Y.max())}): Y takes {Y.size * y_itemsize / 1e9:.2f} GB there "
            f"({Y.size * 4 / 1e9:.2f} GB as float32)")
        wide_checks = wide_kernel_checks(fl, auto_name)
        f64_checks = float64_kernels(fl)
        steps.done("3b the wide and float64 kernels vs plain")
        cpu_f64 = cpu_references()
    steps.done("3c waiting for the CPU's float64 references")
    for (st, Kf), r in [((st, 1), r) for st, r in full.items()] + list(full_kf.items()):
        b = r["bounds"]
        log(f"full width, Y {st}, Kf={Kf}: fwd {r['fwd_ms']:.3f} ms (plain {r['fwd_plain_ms']:.3f}, bound "
            f"{b['fwd'][0]:.3f} by {b['fwd'][2]}), bwd {r['bwd_ms']:.3f} ms (plain "
            f"{r['bwd_plain_ms']:.3f}, bound {b['bwd'][0]:.3f} by {b['bwd'][2]}): dpsi "
            f"{r['dpsi_ms']:.3f}, gene part {r['gene_ms']:.3f} (bound {b['gene'][0]:.3f} by "
            f"{b['gene'][2]})")

    # 4. the fit at full width, through the public entry point, with Y
    # stored as float32 and as "auto" resolves, in turns; the covariates: a
    # 0/1 batch over halves of the cells and a standard normal
    rng = np.random.default_rng(5)
    X = np.stack([(np.arange(FULL["N"]) >= FULL["N"] // 2).astype(np.float64),
                  rng.standard_normal(FULL["N"])], axis=1)
    # the allele data: SNV_V variants around the true clones; and the same
    # counts as a scipy CSR matrix
    t0 = time.perf_counter()
    allele = snv_data(z, FULL["C"], SNV_V, seed=5)
    t1 = time.perf_counter()
    Y_csr = scipy.sparse.csr_matrix(Y)
    log(f"allele data (V={SNV_V}, numpy seed 5) {t1 - t0:.1f} s; CSR of the counts "
        f"{time.perf_counter() - t1:.1f} s, nnz {Y_csr.nnz} ({Y_csr.nnz / Y.size:.3f} of the "
        "entries)")
    fits = {}
    for name, counts, x, snv in (("float32", Y, None, None), ("auto", Y, None, None),
                                 ("auto+x", Y, X, None), ("auto+allele", Y, None, allele),
                                 ("auto+sparse", Y_csr, None, None)) * 2:
        fits.setdefault(name, []).append(full_fit(
            clonealign_torch, fl, counts, L, z, name.split("+")[0], x, snv, label=name))
    launches = fits["auto"][0]["launches"]  # the main path's
    cov_launches = fits["auto+x"][0]["launches"]  # the covariate fit's path
    allele_launches = fits["auto+allele"][0]["launches"]
    sparse_launches = fits["auto+sparse"][0]["launches"]
    log(f"full-width exact fit, float32 / auto ({auto_name}) / auto with x (K=1, P={X.shape[1]}) / "
        f"auto with allele data (V={SNV_V}) / auto from the CSR, in turns: " + "; ".join(
            f"{key} " + " vs ".join(" / ".join(f"{f[key]:.4g}" for f in fits[k])
                                    for k in FIT_KINDS)
            for key in ("iter_ms", "setup_s", "setup_peak_gb", "peak_gb", "final_elbo")))
    log("allele fit: allele term " + " / ".join(f"{f['allele_s']:.3f}" for f in fits["auto+allele"])
        + " s of setup; SNV-alone accuracy "
        + " / ".join(f"{f['snv_accuracy']:.4f}" for f in fits["auto+allele"]))
    for dense, sparse in zip(fits["auto"], fits["auto+sparse"]):
        diff = abs(sparse["final_elbo"] - dense["final_elbo"])
        bar = max(1e-6 * abs(dense["final_elbo"]), 3.0 * sparse["sd_final"])
        same = sparse["labels"] == dense["labels"]
        log(f"sparse fit against the dense auto fit of the same turn: setup {sparse['setup_s']:.3f} "
            f"s against {dense['setup_s']:.3f} s; final ELBO |diff| {diff:.6g} (bar {bar:.6g}); "
            f"labels {'identical' if same else 'DIFFER'}")
        if not (diff <= bar and same):
            raise AssertionError("the sparse fit differs from the dense fit of the same counts")
    for f in fits.values():
        for one in f:
            del one["labels"]
    iter_ms = {"xla": [f["iter_ms"] for f in fits["auto"]]}
    steps.done("4 full-width fits")

    # 5. ms per iteration of the full-width single fit under each likelihood,
    # in turns (the numbers api._resolve_auto_impl rests on); the z_cheb fit
    # runs the forward kernel only for its 20 final evaluations
    for impl in ("z_cheb", "xla", "z_cheb"):
        fl.reset_launch_counts()
        f = clonealign_torch.clonealign(
            Y, L, device="cuda", max_iter=FIT_MAX_ITER, seed=0, verbose=False,
            likelihood_impl=impl,
        )
        got = launches_of(fl)
        n = f.convergence_info.n_iters
        iter_ms.setdefault(impl, []).append(1000 * f.timings["loop"] / max(n, 1))
        acc_i = accuracy(f, z)
        log(f"fit {impl}: {n} iterations, {iter_ms[impl][-1]:.2f} ms per iteration, "
            f"final ELBO {f.convergence_info.final_elbo:.6g}, accuracy {acc_i:.4f}, "
            f"launches {got}")
        want = ({"fwd": 20, "dpsi": 0, "gene": 0} if impl == "z_cheb" else
                {"fwd": 2 + 2 * n + 20, "dpsi": n, "gene": n})
        if acc_i < MIN_ACCURACY or got != want:
            raise AssertionError(f"fit {impl}: accuracy {acc_i:.4f}, launches {got} (expected {want})")
    log("ms per iteration, full-width single fit: " + ", ".join(
        f"{impl} {' / '.join(f'{t:.2f}' for t in ts)}" for impl, ts in iter_ms.items()))
    steps.done("5 likelihoods")

    # 6. the full-width sweep of ten restarts: exact in sequence, exact as
    # lanes, z_cheb as lanes, all with Y stored as "auto" resolves; and (b)
    # with Y stored as float32, in turns with (b) under "auto"
    sweeps = {}
    for name, impl, batching, storage in (
            ("a", "xla", "map", "auto"), ("b", "xla", "vmap", "auto"),
            ("b32", "xla", "vmap", "float32"), ("b2", "xla", "vmap", "auto"),
            ("b32_2", "xla", "vmap", "float32"), ("c", "z_cheb", "vmap", "auto")):
        sweeps[name] = run_sweep(clonealign_torch, fl, Y, L, z, name, impl, batching, storage,
                                 y_itemsize if storage == "auto" else 4)
    log("sweep (b), ms per lane iteration, float32 / auto (" + auto_name + ") in turns: "
        + " / ".join(f"{sweeps[n]['lane_iter_ms']:.3f}" for n in ("b32", "b32_2")) + " vs "
        + " / ".join(f"{sweeps[n]['lane_iter_ms']:.3f}" for n in ("b", "b2"))
        + "; peak allocated in the inference, GB: "
        + " / ".join(f"{sweeps[n]['peak_gb']:.3f}" for n in ("b32", "b32_2")) + " vs "
        + " / ".join(f"{sweeps[n]['peak_gb']:.3f}" for n in ("b", "b2")))
    seq = {k: sweeps["a"][k] for k in ("iterations", "launches")}
    for name in ("b", "b32", "b2", "b32_2"):
        lanes = {k: sweeps[name][k] for k in ("iterations", "launches")}
        if lanes != seq:
            raise AssertionError(f"lanes ({name}) differ from the sequential sweep: {lanes} vs {seq}")
    R = LANES["n_repeats"] * len(LANES["initial_shrinks"])
    if sweeps["c"]["launches"] != {"fwd": 20 * R, "dpsi": 0, "gene": 0}:
        raise AssertionError(f"z_cheb sweep launches {sweeps['c']['launches']}, expected "
                             f"{20 * R} forwards and no backward")
    # (d) the exact sweep with the covariates, batching as "auto" picks: lanes
    sweeps["d"] = run_sweep(clonealign_torch, fl, Y, L, z, "d", "xla", "auto", "auto",
                            y_itemsize, x=X)
    if sweeps["d"]["ran"] != "vmap":
        raise AssertionError("the covariate sweep did not run as lanes")
    log("sweep peak allocated in the inference against restarts._sweep_bytes, GB: " + ", ".join(
        f"({n}) {sw['peak_gb']:.3f} / {sw['plan_gb']:.3f}" for n, sw in sweeps.items()))
    del Y_csr, allele
    steps.done("6 sweeps")

    # 6b. the streaming fit in turns with the in-core fit, what its chunk
    # uploads cost, and serving against the in-core fit
    stream_bounds = stream._chunk_bounds(FULL["N"], stream._resolve_chunk_cells(
        "auto", FULL["N"], FULL["G"]))
    log(f"kernels vs plain at the streaming fit's chunk shapes (Y {auto_name})")
    stream_shapes = check_stream_shapes(stream_bounds, FULL["G"], FULL["C"], auto_name, seed=21)
    up = upload_rates(Y)
    turns, core_fit, n_chunks = stream_turns(clonealign_torch, fl, Y, L, z)
    stream_launches = turns[0]["launches"]
    ms = {k: [t["iter_ms"] for t in turns if t["kind"] == k] for k in ("stream", "core")}
    extra = float(np.mean(ms["stream"]) - np.mean(ms["core"]))
    log(f"chunk upload: {up['chunk_bytes'] / 1e6:.1f} MB a chunk from pinned memory at "
        f"{up['gbps']:.2f} GB/s, {up['copy_ms']:.2f} ms of copies a sweep of {up['n_chunks']}; "
        "a sweep's host conversion alone " + " / ".join(f"{t:.2f}" for t in up["conv_ms"])
        + " ms; ms per iteration streamed "
        + " / ".join(f"{t:.2f}" for t in ms["stream"]) + " against in-core "
        + " / ".join(f"{t:.2f}" for t in ms["core"]) + f": {extra:.2f} ms a step more")
    serve_full(clonealign_torch, core_fit, Y, L, z)
    del core_fit  # Y stays for the distributed phase (9b)
    steps.done("6b streaming and serving")

    # 7. a small restart sweep through run_clonealign
    Ys, Ls, zs = synth_counts(4, SWEEP["N"], SWEEP["G"], SWEEP["C"])
    t0 = time.perf_counter()
    sweep = clonealign_torch.run_clonealign(
        Ys, Ls, initial_shrinks=(0, 5, 10), n_repeats=1, device="cuda",
        max_iter=FIT_MAX_ITER, seed=0, verbose=False,
    )
    info = sweep.multirun_info
    best = int(np.nanargmax(info["elbos"]))
    acc_s = accuracy(sweep, zs)
    log(f"run_clonealign {SWEEP['N']}x{SWEEP['G']}x{SWEEP['C']}, 3 restarts: "
        f"{time.perf_counter() - t0:.2f} s, ELBOs {info['elbos'].tolist()}, "
        f"best {info['best_run']}, accuracy {acc_s:.4f}")
    if info["best_run"] != best or acc_s < MIN_ACCURACY:
        raise AssertionError("run_clonealign picked a wrong lane or assigned badly")

    # 7b. a small sweep with the golden allele data, "map" and "vmap" in turns
    allele_sweeps = allele_sweep(clonealign_torch, fl)
    steps.done("7 small sweeps")

    # 8. golden parity: the oracle's four converged fits on the card, and
    # the synthetic one streamed
    golden_launches = golden(clonealign_torch, fl)
    golden_stream_launches, golden_stream_shapes = golden_stream(clonealign_torch, fl)
    steps.done("8 golden")

    # 9. the legacy v1 negative-binomial family: plain PyTorch on the card,
    # no fused-likelihood launch
    negbin = negbin_phase(clonealign_torch, fl)
    steps.done("9 v1")

    # 9b. the distributed fit: a world of one over NCCL, then ranks
    # sharing the card over gloo on a 2 x 1, a 1 x 2 and a 2 x 2 (cells,
    # genes) mesh, against the one-process sweep (6), the streamed fit (6b)
    # and the v1 fit (9)
    distributed_phase(clonealign_torch, fl, Y, L, z, sweeps["b"], turns[0], negbin["exact"],
                      smi)
    del Y
    steps.done("9b distributed")

    # 10. the command line and its file formats: the full-width sweep from
    # an .npz to an .rds, serving from the .rds, a CellRanger .mtx.gz
    cli_launches, cli_mtx_launches = cli_phase(clonealign_torch, fl)
    steps.done("10 command line")

    # 11. the wide kernel family (its kernels checked in step 3b): the wide
    # fit, streamed, its sweep as lanes and the parity fit
    wide = wide_phase(clonealign_torch, fl, y_itemsize, wide_checks)
    steps.done("11 wide")

    # 12. dtype="float64" (its kernels checked in step 3b): the float64
    # fits, sweep, streamed fit, golden fits and v1 family against the CPU
    f64 = float64_phase(clonealign_torch, fl, y_itemsize, cpu_f64, f64_checks)
    steps.done("12 float64")

    # 13. the torch examples on the card, both at once
    examples_on_card()
    steps.done("13 examples")

    # The backward's parts alone at full width, A2 off, Y stored as "auto"
    # resolves on the main path.
    main_full = full[auto_name]
    b = main_full["bounds"]
    log(f"backward parts {FULL['N']}x{FULL['G']} S*C={FULL['C']} Kf=1 A2=off Y {auto_name}: "
        f"dpsi_kernel {main_full['dpsi_ms']:.3f} ms (plain {main_full['dpsi_plain_ms']:.3f} ms, "
        f"bound {b['dpsi'][0]:.3f} ms by {b['dpsi'][2]}), gene_pack_kernel + gene_kernel + "
        f"reduce_chunks_kernel {main_full['gene_ms']:.3f} ms (plain "
        f"{main_full['gene_plain_ms']:.3f} ms, bound {b['gene'][0]:.3f} ms by {b['gene'][2]})")

    def by_storage(part):
        """Each full-width Y storage's numbers for one kernel or part."""
        return [dict({"y_storage": st, "ms": r[f"{part}_ms"], "plain_ms": r[f"{part}_plain_ms"],
                      "bound_ms": r["bounds"][part][0], "bound_by": r["bounds"][part][1],
                      "bound_unit": r["bounds"][part][2]},
                     **({"max_abs_err": r[f"{part}_err"]} if f"{part}_err" in r else {}))
                for st, r in full.items()]

    # No single PyTorch call computes either function: library_ms is null.
    # A backward launch is one dpsi and one gene-major launch.
    kernels = [
        {"name": "fused_likelihood_fwd", "route": "cuda",
         "source": "clonealign_torch/ops/csrc/fused_likelihood.cu",
         "replaces": "clonealign_tpu/ops/fused_likelihood.py:125",
         "launches": launches["fwd"], "max_abs_err": main_full["fwd_err"],
         "ms": main_full["fwd_ms"], "plain_ms": main_full["fwd_plain_ms"],
         "bound_ms": b["fwd"][0], "bound_by": b["fwd"][1],
         "library_ms": None, "y_storage": auto_name, "by_storage": by_storage("fwd")},
        {"name": "fused_likelihood_bwd", "route": "cuda",
         "source": "clonealign_torch/ops/csrc/fused_likelihood.cu",
         "replaces": "clonealign_tpu/ops/fused_likelihood.py:234",
         "launches": min(launches["dpsi"], launches["gene"]),
         "max_abs_err": main_full["bwd_err"],
         "ms": main_full["bwd_ms"], "plain_ms": main_full["bwd_plain_ms"],
         "bound_ms": b["bwd"][0], "bound_by": b["bwd"][1],
         "library_ms": None, "y_storage": auto_name, "by_storage": by_storage("bwd"),
         "parts": [
             {"name": "dpsi_kernel", "launches": launches["dpsi"],
              "ms": main_full["dpsi_ms"], "plain_ms": main_full["dpsi_plain_ms"],
              "bound_ms": b["dpsi"][0], "bound_by": b["dpsi"][1], "bound_unit": b["dpsi"][2]},
             {"name": "gene_pack_kernel+gene_kernel+reduce_chunks_kernel",
              "launches": launches["gene"],
              "ms": main_full["gene_ms"], "plain_ms": main_full["gene_plain_ms"],
              "bound_ms": b["gene"][0], "bound_by": b["gene"][1], "bound_unit": b["gene"][2],
              "by_storage": by_storage("gene")},
         ]},
    ]
    for k, part in zip(kernels, ("fwd", "bwd")):
        k["by_kf"] = [dict({"kf": Kf, "y_storage": st, "ms": r[f"{part}_ms"],
                            "plain_ms": r[f"{part}_plain_ms"], "max_abs_err": r[f"{part}_err"],
                            "bound_ms": r["bounds"][part][0], "bound_by": r["bounds"][part][1],
                            "bound_unit": r["bounds"][part][2]},
                           **({} if part == "fwd" else {
                               "dpsi_ms": r["dpsi_ms"], "gene_ms": r["gene_ms"],
                               "dpsi_bound_ms": r["bounds"]["dpsi"][0],
                               "gene_bound_ms": r["bounds"]["gene"][0]}))
                      for (st, Kf), r in full_kf.items()]
    paths = ((f"fit K=1 P={X.shape[1]} y_storage=auto (Kf={1 + X.shape[1]})", cov_launches),
             (f"fit K=1 y_storage=auto with allele data (V={SNV_V})", allele_launches),
             ("fit K=1 y_storage=auto from a CSR matrix", sparse_launches),
             ("golden rich K=2 P=2 S=3 (Kf=4)", golden_launches["rich"]),
             ("golden allele", golden_launches["allele"]),
             ("allele sweep, 3 restarts, map", allele_sweeps["map"]),
             ("allele sweep, 3 restarts, vmap", allele_sweeps["vmap"]),
             (f"streaming fit y_storage=auto, {n_chunks} chunks, reuse", stream_launches),
             (f"golden synth streamed, {-(-5000 // GOLDEN_STREAM_CHUNK)} chunks, fresh",
              golden_stream_launches),
             ("command line: fit --restarts 10, .npz to .rds (sweep, fresh)", cli_launches),
             ("command line: fit --transpose from .mtx.gz, 2,000 cells", cli_mtx_launches))
    # the kernels at each streaming path's chunk shapes (Y the leading rows
    # of the feeder's buffer): errors against the plain versions, times
    for k, part in zip(kernels, ("fwd", "bwd")):
        k["stream_shapes"] = [
            {"path": path, "shape": r["shape"], "buffer_rows": r["buffer_rows"],
             "y_storage": r["y_storage"], "max_abs_err": r[f"{part}_max_abs_err"],
             "ms": r[f"{part}_ms"], "plain_ms": r[f"{part}_plain_ms"]}
            for path, shapes in (("streaming fit", stream_shapes),
                                 ("golden synth streamed", golden_stream_shapes))
            for r in shapes]
    kernels[0]["paths"] = [{"path": p, "launches": n["fwd"]} for p, n in paths]
    kernels[1]["paths"] = [{"path": p, "launches": min(n["dpsi"], n["gene"])} for p, n in paths]
    kernels += wide_kernels(wide, auto_name)
    kernels += f64_kernels(f64, auto_name)
    log("steps, s: " + ", ".join(f"{k} {v:.1f}" for k, v in steps.seconds.items()))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all [{smi}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

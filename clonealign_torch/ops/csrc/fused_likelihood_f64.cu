// Fused multinomial-likelihood contractions in float64 on Hopper (sm_90a).
//
// The float64 counterparts of fused_likelihood.cu's kernels, for fits with
// dtype="float64" on the card (the JAX package's oracle configuration).
// They replace the same Pallas TPU kernels of
// clonealign_tpu/ops/fused_likelihood.py, with every branch:
// _fwd_kernel (launched by _fused_fwd; pallas_call :125, jnp.dot branches
// :91, :102, :105) and _bwd_kernel (launched by _fused_bwd; pallas_call
// :234, jnp.dot branches :182, :187, :201-202, :211, :213), whose contract
// in float64 is
//
//   log_rfe[n,g] = sum_k psi[n,k] W[g,k]            (Kf <= 64)
//   A1[n]        = sum_g Y[n,g] log_rfe[n,g]
//   A2[n,s]      = sum_g Y[n,g] log_mu[s,g]         (optional, nA2 <= 64)
//   Z[n,j]       = sum_g exp(log_rfe[n,g]) muL[g,j] (j = s*C + c, SC <= 2048)
//   YW[n,k]      = sum_g Y[n,g] W[g,k]              (kept for dpsi)
//
// and the vector-Jacobian product: with rfe = exp(log_rfe), drfe = dZ muL^T
// and dlog_rfe = Y dA1 + rfe drfe, dpsi = dlog_rfe W, dW = dlog_rfe^T psi,
// dlog_mu = dA2^T Y and d(muL) = rfe^T dZ. Every product and sum is float64
// on the CUDA cores (DFMA), every exp the double exp() (no fast-math, no
// tensor cores): the kernels serve the oracle configuration, and their
// results differ from the plain float64 versions only by the order of
// their sums. One family takes every width up to the contract's bound,
// with runtime widths; there is no narrow/wide split.
//
// Design. One lane owns one row (a cell in fwd_f64_kernel and
// dpsi_f64_kernel, a gene in gene_f64_kernel) and walks the other axis.
// Whatever belongs to its row and has a runtime width (psi or W's row, its
// accumulators, dZ's or muL's row) lives in shared memory in per-lane
// slots, [column][lane], so that a warp's access is 32 consecutive
// doubles (no bank conflict). What belongs to the walked axis (a stage of
// 32 genes, or 32 cells, of W, muL, log mu, psi, dZ, dA1, dA2) is staged
// in shared memory by the block, column-major, and read by every lane at
// one address (a broadcast). The walk goes 8 genes (cells) at a time,
// held in registers: log_rfe, rfe and Y of the 8, so that each per-lane
// slot is read (and written) once for 8 FMAs, and four slots' chains of 8
// dependent FMAs run interleaved (add_columns; d(muL)'s two at a time), so
// that a warp does not wait on each FMA of one chain. A thread's sums run in a
// fixed order, and each (chunk, gene block) of the gene part writes its
// own partial sums, which reduce_chunks_f64_kernel adds in chunk order: no
// atomics, every result deterministic.
//
//  * fwd_f64_kernel<YT>: the forward's output columns are [YW (Kf) | A2
//    (nA2) | Z (SC)], split evenly into column groups of at most
//    kFwdCols (grid.y). Y's products come first, so the first group also
//    forms YW, A2 and A1 from its read of Y wherever Kf + nA2 leaves room;
//    a group reads Y only where it holds a Y product (or A1, the first),
//    and forms the exps only where it holds a Z column. At Kf + nA2 + S*C
//    <= 32 (the main path: Kf 1, S*C 10, A2 off) one group does
//    everything: one read of Y and one exp an element.
//  * dpsi_f64_kernel reads no Y: dpsi = sum_g rfe (dZ muL^T) W, then
//    dA1 YW (the forward's) added last, the term order of the plain
//    version reference_dpsi. dZ's columns go in groups of at most
//    kDpsiCols, one after another in the block (dpsi is linear in drfe),
//    each recomputing log_rfe and the exps; S*C <= 64 is one group.
//  * gene_f64_kernel<YT> (dW, d(muL), dlog mu): a block owns 64 genes and
//    one chunk of the cells (grid.y, ops/fused_likelihood.py's
//    _chunk_rows). d(muL)'s columns go in passes of at most kGeneCols,
//    each recomputing rfe and its part of drfe; dW is linear in drfe, so
//    each pass adds rfe drfe_pass psi to dW's slots, which live through
//    every pass, and the first pass adds Y dA1 psi and forms dlog mu from
//    the one read of Y. The partial sums of each chunk go to the workspace
//    as [dW^T; d(muL)^T; dlog mu] rows, reduce_chunks_f64_kernel adds the
//    chunks.
//
// What bounds them on the card: a float64 exp is a software sequence on
// the FP64 units (an integer part, a polynomial of DFMAs, a scaling), about
// twenty FP64 instructions, where float32's __expf is one instruction on
// the special-function units; so at the main path's widths the exps, not
// Y's bytes, set the forward's and dpsi's least time (chip_smoke.py counts
// the built sequence's FP64 instructions from cuobjdump -sass and reckons
// each kernel's bound with it). The products with muL have S*C FMAs an
// element, which at S*C 80 outweigh the exps. The FP64 tensor cores
// (mma.sync m8n8k4 f64, twice the CUDA cores' rate) are not used here.
// Measured at full width (Kf 1, S*C 10, int8 Y) on an H100 80GB HBM3
// (700 W) by chip_smoke.py: the forward 2.86 ms, dpsi 1.88 and the gene
// part 3.54, against least times of 0.63, 0.61 and 0.64 ms (an exp is 18
// FP64 instructions there); at S*C 80, 10.5, 8.7 and 15.4 ms.
// Y storage: float64 (the compute dtype), bfloat16, int16 or int8, loaded
// in its type and converted in registers, exactly.
//
// Build: as fused_likelihood.cu, ops/_build.py compiles this file once for
// each FL_PART and links the objects: FL_PART = -1 holds dpsi_f64_kernel,
// reduce_chunks_f64_kernel and the C entry points (fl64_*), FL_PART = YT
// the two Y-reading kernels of one Y storage type.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifndef FL_PART
#define F64_COMMON 1
#define F64_TYPED(code) 1
#elif FL_PART < 0
#define F64_COMMON 1
#define F64_TYPED(code) 0
#else
#define F64_COMMON 0
#define F64_TYPED(code) ((code) == FL_PART)
#endif
#define F64_ANY_TYPED (F64_TYPED(0) || F64_TYPED(1) || F64_TYPED(2) || F64_TYPED(3))

namespace fl64 {

// Y storage types: the codes of ops/fused_likelihood.py's Y_DTYPES_F64 (0
// is the compute dtype, float64).
constexpr int kYF64 = 0, kYBF16 = 1, kYI16 = 2, kYI8 = 3;

// The launch plan (ops/fused_likelihood.py's f64_plan, checked by
// plan_of): the forward's column groups (f_groups of f_cols columns of
// [YW | A2 | Z]) and blocks of kCells cells; dpsi's dZ column groups;
// the gene part's passes over d(muL)'s columns, its blocks of kGeneLanes
// genes, its chunks of rows cells and its partial sums (part doubles); and
// each kernel's dynamic shared memory in bytes.
struct Plan {
  int f_cols, f_groups, f_blocks, f_smem;
  int d_cols, d_groups, d_blocks, d_smem;
  int g_cols, g_passes, g_blocks, rows, n_chunks, g_smem;
  size_t part;
};

struct FwdArgs {
  const void* Y;  // (N, G) in the storage type
  const double *psi, *W, *logmu, *muL;
  double *A1, *A2, *Z, *YW;
  int N, G, Kf, nA2, SC;
  Plan plan;
  cudaStream_t stream;
};

struct GeneArgs {
  const void* Y;  // (N, G) in the storage type
  const double *psi, *W, *muL, *dA1, *dA2, *dZ;
  double* part;  // (n_chunks, Kf + SC + nA2, G)
  int N, G, Kf, nA2, SC;
  Plan plan;
  cudaStream_t stream;
};

// The Y-reading kernels of one storage type, and their blocks an SM at the
// plan's shared memory (which: 0 the forward, 1 the gene part).
template <int YT> void forward_typed(const FwdArgs& a);
template <int YT> void gene_typed(const GeneArgs& a);
template <int YT> int blocks_per_sm(int which, int smem);

}  // namespace fl64

namespace {

using namespace fl64;

constexpr int kCells = 128;     // cells (lanes) a forward or dpsi block
constexpr int kGenes = 32;      // genes a forward or dpsi stage
constexpr int kGeneLanes = 64;  // genes (lanes) a gene-part block
constexpr int kCellStage = 32;  // cells a gene-part stage
constexpr int kSub = 8;         // genes (cells) a lane holds in registers at once
// Column caps (ops/fused_likelihood.py's F64_*_COLS) and the bounds.
constexpr int kFwdCols = 32, kDpsiCols = 64, kGeneCols = 32;
constexpr int kMaxKf = 64, kMaxA2 = 64, kMaxSC = 2048;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may take

template <int YT> struct Y64;
template <> struct Y64<kYF64> { using Elem = double; };
template <> struct Y64<kYBF16> { using Elem = uint16_t; };  // bfloat16 bits
template <> struct Y64<kYI16> { using Elem = int16_t; };
template <> struct Y64<kYI8> { using Elem = int8_t; };

// One count as a double, exactly (a bfloat16 is the top half of a float).
template <int YT>
__device__ __forceinline__ double y_to_double(typename Y64<YT>::Elem e) {
  if constexpr (YT == kYBF16) {
    return (double)__uint_as_float((uint32_t)e << 16);
  } else {
    return (double)e;
  }
}

// Per-lane sums s_acc[c * lanes + t], c in [c0, c1), each plus
// sum_u a[u] * s_b[c * stage + gl + u] (u in order, so each sum runs in the
// walk's order), four columns at a time: their four chains of dependent
// FMAs interleave, where one column's chain alone would wait on each FMA.
__device__ __forceinline__ void add_columns(double* __restrict__ s_acc, int lanes, int t,
                                            const double* __restrict__ s_b, int stage, int gl,
                                            int c0, int c1, const double (&a)[kSub]) {
  int c = c0;
  for (; c + 4 <= c1; c += 4) {
    double acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = s_acc[(c + q) * lanes + t];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fma(a[u], s_b[(c + q) * stage + gl + u], acc[q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) s_acc[(c + q) * lanes + t] = acc[q];
  }
  for (; c < c1; ++c) {
    double acc = s_acc[c * lanes + t];
#pragma unroll
    for (int u = 0; u < kSub; ++u) acc = fma(a[u], s_b[c * stage + gl + u], acc);
    s_acc[c * lanes + t] = acc;
  }
}

#if F64_ANY_TYPED
// Counts g .. g + kSub - 1 of one Y row, zero past G. vec: G % kSub == 0
// and Y 16-byte aligned, so a row's kSub counts from a multiple of kSub are
// one aligned piece (64, 16 or 8 bytes) and all within G.
template <int YT>
__device__ __forceinline__ void load_y8(const typename Y64<YT>::Elem* __restrict__ row, int g,
                                        int G, bool vec, double (&y)[kSub]) {
  if (vec) {
    if constexpr (YT == kYF64) {
      const double2* p = reinterpret_cast<const double2*>(row + g);
#pragma unroll
      for (int u = 0; u < kSub / 2; ++u) {
        const double2 v = p[u];
        y[2 * u] = v.x;
        y[2 * u + 1] = v.y;
      }
    } else if constexpr (YT == kYI8) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + g);
#pragma unroll
      for (int u = 0; u < kSub; ++u)
        y[u] = (double)(int8_t)(uint8_t)(((u < 4 ? v.x : v.y) >> (8 * (u % 4))) & 0xffu);
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(row + g);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const uint16_t h = (uint16_t)((w[u / 2] >> (16 * (u % 2))) & 0xffffu);
        if constexpr (YT == kYBF16)
          y[u] = y_to_double<YT>(h);
        else
          y[u] = (double)(int16_t)h;
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kSub; ++u) y[u] = g + u < G ? y_to_double<YT>(row[g + u]) : 0.0;
  }
}

// ---------------------------------------------------------------------------
// Forward: block (blockIdx.x) of kCells cells, column group blockIdx.y of
// plan.f_cols columns of [YW | A2 | Z]. Shared memory: psi's and the
// accumulators' per-lane slots, then the stage's W^T and the group's
// columns of [W | log mu^T | muL] for kGenes genes.
// ---------------------------------------------------------------------------
template <int YT>
__global__ void __launch_bounds__(kCells, 4)
fwd_f64_kernel(const typename Y64<YT>::Elem* __restrict__ Y, const double* __restrict__ psi,
               const double* __restrict__ W, const double* __restrict__ logmu,
               const double* __restrict__ muL, double* __restrict__ A1, double* __restrict__ A2,
               double* __restrict__ Z, double* __restrict__ YW, int N, int G, int Kf, int nA2,
               int SC, int cols, bool vec) {
  extern __shared__ double smem[];
  double* s_psi = smem;                           // [Kf][kCells]
  double* s_acc = s_psi + (size_t)Kf * kCells;    // [cols][kCells]
  double* s_w = s_acc + (size_t)cols * kCells;    // [Kf][kGenes]
  double* s_b = s_w + (size_t)Kf * kGenes;        // [cols][kGenes]
  const int t = threadIdx.x, m = blockIdx.x * kCells + t;
  const bool live = m < N;
  const int n_y = Kf + nA2, F = n_y + SC;
  const int c0 = blockIdx.y * cols, nc = min(cols, F - c0);
  const int ny = max(0, min(nc, n_y - c0));  // this group's Y-product columns (its first)
  const bool first = blockIdx.y == 0;
  const bool with_exp = nc > ny, with_lr = with_exp || first, with_y = ny > 0 || first;
  for (int k = 0; k < Kf; ++k) s_psi[k * kCells + t] = live ? psi[(size_t)m * Kf + k] : 0.0;
  for (int c = 0; c < nc; ++c) s_acc[c * kCells + t] = 0.0;
  const typename Y64<YT>::Elem* row = Y + (size_t)(live ? m : 0) * G;
  double a1 = 0.0;
  for (int g0 = 0; g0 < G; g0 += kGenes) {
    __syncthreads();  // the previous stage is read
    if (with_lr) {
      for (int i = t; i < Kf * kGenes; i += kCells) {  // W read row-major, coalesced
        const int gl = i / Kf, k = i % Kf, g = g0 + gl;
        s_w[k * kGenes + gl] = g < G ? W[(size_t)g * Kf + k] : 0.0;
      }
    }
    for (int i = t; i < nc * kGenes; i += kCells) {
      const int gl = i / nc, c = i % nc, g = g0 + gl, col = c0 + c;
      double v = 0.0;
      if (g < G) {
        if (col < Kf)
          v = W[(size_t)g * Kf + col];
        else if (col < n_y)
          v = logmu[(size_t)(col - Kf) * G + g];
        else
          v = muL[(size_t)g * SC + (col - n_y)];
      }
      s_b[c * kGenes + gl] = v;
    }
    __syncthreads();
    const int n_sub = (min(kGenes, G - g0) + kSub - 1) / kSub;
    for (int sub = 0; sub < n_sub; ++sub) {
      const int gl = sub * kSub;
      double lr[kSub], y[kSub];
#pragma unroll
      for (int u = 0; u < kSub; ++u) lr[u] = y[u] = 0.0;
      if (with_lr) {
        for (int k = 0; k < Kf; ++k) {
          const double p = s_psi[k * kCells + t];
          const double* w = s_w + k * kGenes + gl;
#pragma unroll
          for (int u = 0; u < kSub; ++u) lr[u] = fma(p, w[u], lr[u]);
        }
      }
      if (with_y && live) load_y8<YT>(row, g0 + gl, G, vec, y);
      if (first) {
#pragma unroll
        for (int u = 0; u < kSub; ++u) a1 = fma(y[u], lr[u], a1);
      }
      add_columns(s_acc, kCells, t, s_b, kGenes, gl, 0, ny, y);
      if (with_exp) {
#pragma unroll
        for (int u = 0; u < kSub; ++u) lr[u] = exp(lr[u]);  // rfe, in place
        add_columns(s_acc, kCells, t, s_b, kGenes, gl, ny, nc, lr);
      }
    }
  }
  if (!live) return;
  for (int c = 0; c < nc; ++c) {
    const int col = c0 + c;
    const double v = s_acc[c * kCells + t];
    if (col < Kf)
      YW[(size_t)m * Kf + col] = v;
    else if (col < n_y)
      A2[(size_t)m * nA2 + (col - Kf)] = v;
    else
      Z[(size_t)m * SC + (col - n_y)] = v;
  }
  if (first) A1[m] = a1;
}

// ---------------------------------------------------------------------------
// Gene part: block (blockIdx.x) of kGeneLanes genes, chunk blockIdx.y of
// `rows` cells, d(muL)'s columns in `passes` passes of at most `cols`.
// Shared memory: per-lane slots of W's row, dW, dlog mu, the pass's muL
// row and its d(muL); then the stage's psi, dZ (the pass's columns), dA1
// and dA2 for kCellStage cells.
// ---------------------------------------------------------------------------
// Six blocks an SM (170 registers): at eight (128) the narrow-Y
// instantiations spilled.
template <int YT>
__global__ void __launch_bounds__(kGeneLanes, 6)
gene_f64_kernel(const typename Y64<YT>::Elem* __restrict__ Y, const double* __restrict__ psi,
                const double* __restrict__ W, const double* __restrict__ muL,
                const double* __restrict__ dA1, const double* __restrict__ dA2,
                const double* __restrict__ dZ, double* __restrict__ part, int N, int G, int Kf,
                int nA2, int SC, int rows, int cols, int passes) {
  extern __shared__ double smem[];
  constexpr int L = kGeneLanes, CS = kCellStage;
  double* s_w = smem;                              // [Kf][L]
  double* s_dw = s_w + (size_t)Kf * L;             // [Kf][L]
  double* s_dlm = s_dw + (size_t)Kf * L;           // [nA2][L]
  double* s_mu = s_dlm + (size_t)nA2 * L;          // [cols][L]
  double* s_dmu = s_mu + (size_t)cols * L;         // [cols][L]
  double* s_ps = s_dmu + (size_t)cols * L;         // [Kf][CS]
  double* s_dz = s_ps + (size_t)Kf * CS;           // [cols][CS]
  double* s_a1 = s_dz + (size_t)cols * CS;         // [CS]
  double* s_a2 = s_a1 + CS;                        // [nA2][CS]
  const int t = threadIdx.x, g = blockIdx.x * L + t;
  const bool live = g < G;
  const int chunk = blockIdx.y, n_begin = chunk * rows, n_end = min(N, n_begin + rows);
  const int F = Kf + SC + nA2;
  double* out = part + (size_t)chunk * F * G;
  for (int k = 0; k < Kf; ++k) {
    s_w[k * L + t] = live ? W[(size_t)g * Kf + k] : 0.0;
    s_dw[k * L + t] = 0.0;
  }
  for (int s = 0; s < nA2; ++s) s_dlm[s * L + t] = 0.0;
  for (int q = 0; q < passes; ++q) {
    const int j0 = q * cols, nj = min(cols, SC - j0);
    const bool first = q == 0;
    for (int j = 0; j < nj; ++j) {
      s_mu[j * L + t] = live ? muL[(size_t)g * SC + j0 + j] : 0.0;
      s_dmu[j * L + t] = 0.0;
    }
    for (int n0 = n_begin; n0 < n_end; n0 += CS) {
      const int n_cells = min(CS, n_end - n0);
      __syncthreads();  // the previous stage is read
      for (int i = t; i < Kf * CS; i += L) {
        const int cl = i / Kf, k = i % Kf;
        s_ps[k * CS + cl] = cl < n_cells ? psi[(size_t)(n0 + cl) * Kf + k] : 0.0;
      }
      for (int i = t; i < nj * CS; i += L) {
        const int cl = i / nj, j = i % nj;
        s_dz[j * CS + cl] = cl < n_cells ? dZ[(size_t)(n0 + cl) * SC + j0 + j] : 0.0;
      }
      if (first) {
        for (int i = t; i < CS; i += L) s_a1[i] = i < n_cells ? dA1[n0 + i] : 0.0;
        for (int i = t; i < nA2 * CS; i += L) {
          const int cl = i / nA2, s = i % nA2;
          s_a2[s * CS + cl] = cl < n_cells ? dA2[(size_t)(n0 + cl) * nA2 + s] : 0.0;
        }
      }
      __syncthreads();
      const int n_sub = (n_cells + kSub - 1) / kSub;
      for (int sub = 0; sub < n_sub; ++sub) {
        const int cl = sub * kSub;
        double rf[kSub], d[kSub], y[kSub];  // rf: log_rfe, then rfe in place
#pragma unroll
        for (int u = 0; u < kSub; ++u) rf[u] = d[u] = y[u] = 0.0;
        for (int k = 0; k < Kf; ++k) {
          const double w = s_w[k * L + t];
          const double* p = s_ps + k * CS + cl;
#pragma unroll
          for (int u = 0; u < kSub; ++u) rf[u] = fma(w, p[u], rf[u]);
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u) rf[u] = exp(rf[u]);
        if (first && live) {
#pragma unroll
          for (int u = 0; u < kSub; ++u)
            if (cl + u < n_cells) y[u] = y_to_double<YT>(Y[(size_t)(n0 + cl + u) * G + g]);
        }
        // drfe of the pass's columns, and d(muL): two columns at a time, so
        // that their d(muL) chains interleave (drfe's sums keep j's order)
        int j = 0;
        for (; j + 2 <= nj; j += 2) {
          const double mu0 = s_mu[j * L + t], mu1 = s_mu[(j + 1) * L + t];
          const double* z0 = s_dz + j * CS + cl;
          const double* z1 = z0 + CS;
          double acc0 = s_dmu[j * L + t], acc1 = s_dmu[(j + 1) * L + t];
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            d[u] = fma(mu1, z1[u], fma(mu0, z0[u], d[u]));
            acc0 = fma(rf[u], z0[u], acc0);
            acc1 = fma(rf[u], z1[u], acc1);
          }
          s_dmu[j * L + t] = acc0;
          s_dmu[(j + 1) * L + t] = acc1;
        }
        if (j < nj) {
          const double mu = s_mu[j * L + t];
          const double* z = s_dz + j * CS + cl;
          double acc = s_dmu[j * L + t];
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            d[u] = fma(mu, z[u], d[u]);
            acc = fma(rf[u], z[u], acc);
          }
          s_dmu[j * L + t] = acc;
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u) d[u] *= rf[u];  // rfe drfe_pass
        if (first) {
#pragma unroll
          for (int u = 0; u < kSub; ++u) d[u] = fma(y[u], s_a1[cl + u], d[u]);  // + Y dA1
          add_columns(s_dlm, L, t, s_a2, CS, cl, 0, nA2, y);
        }
        add_columns(s_dw, L, t, s_ps, CS, cl, 0, Kf, d);
      }
    }
    if (live)
      for (int j = 0; j < nj; ++j) out[(size_t)(Kf + j0 + j) * G + g] = s_dmu[j * L + t];
  }
  if (!live) return;
  for (int k = 0; k < Kf; ++k) out[(size_t)k * G + g] = s_dw[k * L + t];
  for (int s = 0; s < nA2; ++s) out[(size_t)(Kf + SC + s) * G + g] = s_dlm[s * L + t];
}
#endif  // F64_ANY_TYPED

#if F64_COMMON
// ---------------------------------------------------------------------------
// dpsi (reads no Y): block of kCells cells, dZ's columns in `groups`
// groups of at most `cols`, one after another. Shared memory: per-lane
// slots of psi, the dpsi sums and the group's dZ; then the stage's W^T and
// the group's columns of muL^T for kGenes genes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kCells, 4)
dpsi_f64_kernel(const double* __restrict__ psi, const double* __restrict__ W,
                const double* __restrict__ muL, const double* __restrict__ dA1,
                const double* __restrict__ dZ, const double* __restrict__ YW,
                double* __restrict__ dpsi, int N, int G, int Kf, int SC, int cols, int groups) {
  extern __shared__ double smem[];
  double* s_psi = smem;                          // [Kf][kCells]
  double* s_acc = s_psi + (size_t)Kf * kCells;   // [Kf][kCells]
  double* s_dz = s_acc + (size_t)Kf * kCells;    // [cols][kCells]
  double* s_w = s_dz + (size_t)cols * kCells;    // [Kf][kGenes]
  double* s_mu = s_w + (size_t)Kf * kGenes;      // [cols][kGenes]
  const int t = threadIdx.x, m = blockIdx.x * kCells + t;
  const bool live = m < N;
  for (int k = 0; k < Kf; ++k) {
    s_psi[k * kCells + t] = live ? psi[(size_t)m * Kf + k] : 0.0;
    s_acc[k * kCells + t] = 0.0;
  }
  for (int q = 0; q < groups; ++q) {
    const int j0 = q * cols, nj = min(cols, SC - j0);
    for (int j = 0; j < nj; ++j) s_dz[j * kCells + t] = live ? dZ[(size_t)m * SC + j0 + j] : 0.0;
    for (int g0 = 0; g0 < G; g0 += kGenes) {
      __syncthreads();  // the previous stage is read
      for (int i = t; i < Kf * kGenes; i += kCells) {
        const int gl = i / Kf, k = i % Kf, g = g0 + gl;
        s_w[k * kGenes + gl] = g < G ? W[(size_t)g * Kf + k] : 0.0;
      }
      for (int i = t; i < nj * kGenes; i += kCells) {
        const int gl = i / nj, j = i % nj, g = g0 + gl;
        s_mu[j * kGenes + gl] = g < G ? muL[(size_t)g * SC + j0 + j] : 0.0;
      }
      __syncthreads();
      const int n_sub = (min(kGenes, G - g0) + kSub - 1) / kSub;
      for (int sub = 0; sub < n_sub; ++sub) {
        const int gl = sub * kSub;
        double lr[kSub], d[kSub];
#pragma unroll
        for (int u = 0; u < kSub; ++u) lr[u] = d[u] = 0.0;
        for (int k = 0; k < Kf; ++k) {
          const double p = s_psi[k * kCells + t];
          const double* w = s_w + k * kGenes + gl;
#pragma unroll
          for (int u = 0; u < kSub; ++u) lr[u] = fma(p, w[u], lr[u]);
        }
        for (int j = 0; j < nj; ++j) {  // drfe = dZ muL^T over the group's columns
          const double z = s_dz[j * kCells + t];
          const double* b = s_mu + j * kGenes + gl;
#pragma unroll
          for (int u = 0; u < kSub; ++u) d[u] = fma(z, b[u], d[u]);
        }
#pragma unroll
        for (int u = 0; u < kSub; ++u) d[u] *= exp(lr[u]);  // rfe drfe
        add_columns(s_acc, kCells, t, s_w, kGenes, gl, 0, Kf, d);
      }
    }
  }
  if (!live) return;
  const double a1 = dA1[m];
  for (int k = 0; k < Kf; ++k)
    dpsi[(size_t)m * Kf + k] = s_acc[k * kCells + t] + a1 * YW[(size_t)m * Kf + k];
}

// The chunks' partial sums added in chunk order: out[i] = sum_c part[c][i].
__global__ void reduce_chunks_f64_kernel(const double* __restrict__ part, double* __restrict__ out,
                                         int n_chunks, long long FG) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= FG) return;
  double acc = 0.0;
  for (int c = 0; c < n_chunks; ++c) acc += part[(size_t)c * FG + i];
  out[i] = acc;
}
#endif  // F64_COMMON

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Each kernel's dynamic shared memory, in bytes (the layouts above).
inline long long fwd_smem(int Kf, int cols) {
  return 8LL * (Kf + cols) * (kCells + kGenes);
}
inline long long dpsi_smem(int Kf, int cols) {
  return 8LL * ((2LL * Kf + cols) * kCells + (long long)(Kf + cols) * kGenes);
}
inline long long gene_smem(int Kf, int nA2, int cols) {
  return 8LL * ((2LL * Kf + nA2 + 2LL * cols) * kGeneLanes +
                (long long)(Kf + cols + 1 + nA2) * kCellStage);
}

// Columns split evenly into groups of at most cap: `groups` of `cols`,
// every group holding at least one column.
inline bool even_split(long long n, int cap, int groups, int cols) {
  return cols >= 1 && cols <= cap && groups == cdiv(n, cap) && cols == cdiv(n, groups);
}

bool bad_sizes(int N, int G, int Kf, int nA2, int SC, int y_type) {
  return N < 1 || G < 1 || Kf < 0 || Kf > kMaxKf || nA2 < 0 || nA2 > kMaxA2 || SC < 1 ||
         SC > kMaxSC || y_type < kYF64 || y_type > kYI8;
}

// The plan ops/fused_likelihood.py's f64_plan made (its F64_PLAN_KEYS, in
// order), or false where a number does not fit these sizes: each column
// split even and within its cap, the blocks covering the cells and genes,
// the chunks whole stages covering the cells with grid.y within 65535,
// each shared memory size the kernel's layout and within the card's, and
// the partial sums' room.
bool plan_of(const long long* v, int N, int G, int Kf, int nA2, int SC, Plan& p) {
  for (int i = 0; i < 15; ++i)
    if (v[i] < 0 || (i < 14 && v[i] > 0x7fffffff)) return false;
  p.f_cols = (int)v[0], p.f_groups = (int)v[1], p.f_blocks = (int)v[2], p.f_smem = (int)v[3];
  p.d_cols = (int)v[4], p.d_groups = (int)v[5], p.d_blocks = (int)v[6], p.d_smem = (int)v[7];
  p.g_cols = (int)v[8], p.g_passes = (int)v[9], p.g_blocks = (int)v[10], p.rows = (int)v[11];
  p.n_chunks = (int)v[12], p.g_smem = (int)v[13];
  p.part = (size_t)v[14];
  const long long F = (long long)Kf + SC + nA2;
  return even_split(F, kFwdCols, p.f_groups, p.f_cols) && p.f_groups <= 65535 &&
         p.f_blocks == cdiv(N, kCells) && p.f_smem == fwd_smem(Kf, p.f_cols) &&
         p.f_smem <= kMaxSmem && even_split(SC, kDpsiCols, p.d_groups, p.d_cols) &&
         p.d_blocks == cdiv(N, kCells) && p.d_smem == dpsi_smem(Kf, p.d_cols) &&
         p.d_smem <= kMaxSmem && even_split(SC, kGeneCols, p.g_passes, p.g_cols) &&
         p.g_blocks == cdiv(G, kGeneLanes) && p.rows >= kCellStage &&
         p.rows % kCellStage == 0 && p.n_chunks == cdiv(N, p.rows) && p.n_chunks <= 65535 &&
         p.g_smem == gene_smem(Kf, nA2, p.g_cols) && p.g_smem <= kMaxSmem &&
         p.part >= (size_t)p.n_chunks * F * G;
}

}  // namespace

namespace fl64 {

#if F64_ANY_TYPED
template <int YT>
void forward_typed(const FwdArgs& a) {
  using Elem = typename Y64<YT>::Elem;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const bool vec = a.G % kSub == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  cudaFuncSetAttribute(fwd_f64_kernel<YT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       a.plan.f_smem);
  fwd_f64_kernel<YT><<<dim3(a.plan.f_blocks, a.plan.f_groups), kCells, a.plan.f_smem,
                       a.stream>>>(Y, a.psi, a.W, a.logmu, a.muL, a.A1, a.A2, a.Z, a.YW, a.N,
                                   a.G, a.Kf, a.nA2, a.SC, a.plan.f_cols, vec);
}

template <int YT>
void gene_typed(const GeneArgs& a) {
  using Elem = typename Y64<YT>::Elem;
  cudaFuncSetAttribute(gene_f64_kernel<YT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       a.plan.g_smem);
  gene_f64_kernel<YT><<<dim3(a.plan.g_blocks, a.plan.n_chunks), kGeneLanes, a.plan.g_smem,
                        a.stream>>>(static_cast<const Elem*>(a.Y), a.psi, a.W, a.muL, a.dA1,
                                    a.dA2, a.dZ, a.part, a.N, a.G, a.Kf, a.nA2, a.SC,
                                    a.plan.rows, a.plan.g_cols, a.plan.g_passes);
}

template <int YT>
int blocks_per_sm(int which, int smem) {
  int blocks = 0;
  if (which == 0) {
    cudaFuncSetAttribute(fwd_f64_kernel<YT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fwd_f64_kernel<YT>, kCells, smem);
  } else {
    cudaFuncSetAttribute(gene_f64_kernel<YT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gene_f64_kernel<YT>, kGeneLanes,
                                                  smem);
  }
  return blocks;
}
#endif  // F64_ANY_TYPED

#if F64_TYPED(0)
template void forward_typed<kYF64>(const FwdArgs&);
template void gene_typed<kYF64>(const GeneArgs&);
template int blocks_per_sm<kYF64>(int, int);
#endif
#if F64_TYPED(1)
template void forward_typed<kYBF16>(const FwdArgs&);
template void gene_typed<kYBF16>(const GeneArgs&);
template int blocks_per_sm<kYBF16>(int, int);
#endif
#if F64_TYPED(2)
template void forward_typed<kYI16>(const FwdArgs&);
template void gene_typed<kYI16>(const GeneArgs&);
template int blocks_per_sm<kYI16>(int, int);
#endif
#if F64_TYPED(3)
template void forward_typed<kYI8>(const FwdArgs&);
template void gene_typed<kYI8>(const GeneArgs&);
template int blocks_per_sm<kYI8>(int, int);
#endif

}  // namespace fl64

#if F64_COMMON
extern "C" {

// Y (N,G) is a device pointer to a contiguous array of the storage type
// y_type (0 float64, 1 bfloat16, 2 int16, 3 int8); every other pointer is a
// device pointer to a contiguous float64 array: psi (N,Kf), W (G,Kf), logmu
// (nA2,G), muL (G,SC); outputs A1 (N), A2 (N,nA2), Z (N,SC) and YW (N,Kf) =
// Y W. nA2 == 0 skips A2 (logmu and A2 are then not read or written). plan
// is f64_plan's for these sizes (F64_PLAN_KEYS, in order). Returns
// cudaErrorInvalidValue where the sizes or the plan do not fit, else
// cudaGetLastError() after launch.
int fl64_forward(const void* Y, const double* psi, const double* W, const double* logmu,
                 const double* muL, double* A1, double* A2, double* Z, double* YW,
                 const long long* plan, int N, int G, int Kf, int nA2, int SC, int y_type,
                 cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, p, stream};
  switch (y_type) {
    case kYF64: forward_typed<kYF64>(a); break;
    case kYBF16: forward_typed<kYBF16>(a); break;
    case kYI16: forward_typed<kYI16>(a); break;
    default: forward_typed<kYI8>(a);
  }
  return (int)cudaGetLastError();
}

// Backward, dpsi part: psi, W, muL as fl64_forward, dA1 (N), dZ (N,SC) and
// YW (N,Kf) from fl64_forward; output dpsi (N,Kf). Reads no Y. plan is
// f64_plan's with nA2 = 0. Kf == 0 launches nothing.
int fl64_backward_dpsi(const double* psi, const double* W, const double* muL, const double* dA1,
                       const double* dZ, const double* YW, double* dpsi, const long long* plan,
                       int N, int G, int Kf, int SC, cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, 0, SC, kYF64) || !plan_of(plan, N, G, Kf, 0, SC, p))
    return (int)cudaErrorInvalidValue;
  if (Kf == 0) return (int)cudaSuccess;
  cudaFuncSetAttribute(dpsi_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.d_smem);
  dpsi_f64_kernel<<<p.d_blocks, kCells, p.d_smem, stream>>>(psi, W, muL, dA1, dZ, YW, dpsi, N, G,
                                                            Kf, SC, p.d_cols, p.d_groups);
  return (int)cudaGetLastError();
}

// Backward, gene part: Y (in y_type), psi, W and muL as fl64_forward, dA1
// (N), dA2 (N,nA2), dZ (N,SC). Output dgene (Kf+SC+nA2, G) = [dW^T;
// d(muL)^T; dlog_mu]; scratch holds the plan's part doubles, the partial
// sums of each chunk. Kf == 0 runs with rfe = 1.
int fl64_backward_gene(const void* Y, const double* psi, const double* W, const double* muL,
                       const double* dA1, const double* dA2, const double* dZ, double* scratch,
                       double* dgene, const long long* plan, int N, int G, int Kf, int nA2,
                       int SC, int y_type, cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  const GeneArgs a{Y, psi, W, muL, dA1, dA2, dZ, scratch, N, G, Kf, nA2, SC, p, stream};
  switch (y_type) {
    case kYF64: gene_typed<kYF64>(a); break;
    case kYBF16: gene_typed<kYBF16>(a); break;
    case kYI16: gene_typed<kYI16>(a); break;
    default: gene_typed<kYI8>(a);
  }
  const long long FG = ((long long)Kf + SC + nA2) * G;
  reduce_chunks_f64_kernel<<<(int)cdiv(FG, 256), 256, 0, stream>>>(scratch, dgene, p.n_chunks,
                                                                   FG);
  return (int)cudaGetLastError();
}

// What the plan's kernels take on the card: out[0..6) = fwd_f64_kernel's
// dynamic shared memory bytes and blocks an SM (the occupancy query) at Y
// storage y_type, the same for dpsi_f64_kernel and for gene_f64_kernel.
// Returns cudaErrorInvalidValue where the plan does not fit the sizes.
int fl64_resources(const long long* plan, int N, int G, int Kf, int nA2, int SC, int y_type,
                   int* out) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaFuncSetAttribute(dpsi_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.d_smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dpsi_f64_kernel, kCells, p.d_smem);
  out[2] = p.d_smem;
  out[3] = blocks;
  for (int which = 0; which < 2; ++which) {
    const int smem = which == 0 ? p.f_smem : p.g_smem;
    switch (y_type) {
      case kYF64: blocks = blocks_per_sm<kYF64>(which, smem); break;
      case kYBF16: blocks = blocks_per_sm<kYBF16>(which, smem); break;
      case kYI16: blocks = blocks_per_sm<kYI16>(which, smem); break;
      default: blocks = blocks_per_sm<kYI8>(which, smem);
    }
    out[4 * which] = smem;
    out[4 * which + 1] = blocks;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // F64_COMMON

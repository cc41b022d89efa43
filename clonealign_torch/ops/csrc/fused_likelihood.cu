// Fused multinomial-likelihood contractions for clonealign on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of clonealign_tpu/ops/fused_likelihood.py:
// _fwd_kernel (launched by _fused_fwd) and _bwd_kernel (launched by
// _fused_bwd). The contract is the same; the design is not carried over
// block by block.
//
//   log_rfe[n,g] = sum_k psi[n,k] W[g,k]            (Kf <= 4)
//   A1[n]        = sum_g Y[n,g] log_rfe[n,g]
//   A2[n,s]      = sum_g Y[n,g] log_mu[s,g]         (optional, nA2 <= 4)
//   Z[n,j]       = sum_g exp(log_rfe[n,g]) muL[g,j] (j = s*C + c, SC <= 32)
//
// and the vector-Jacobian product of those three outputs. The N x G matrix
// exp(log_rfe) is never stored: every kernel recomputes it from psi and W.
// The gene tables (W, mu*L, log mu: G x (Kf+SC+S) floats, 220 KB at full
// width) are small; Y is what costs.
//
// Forward (replaces _fwd_kernel). What bounds it on the card is one read of
// Y: at the 100,000 x 5,000 x 10 clones fit, N*G*4 B = 2 GB, 0.60 ms at
// 3.35 TB/s. Its arithmetic (one exp and 2*SC flops of Z per element) is
// under that. The first design on this card (one warp per cell row, Z's SC
// accumulators per lane on CUDA cores) paid ~16 shared-memory loads and
// FMAs per element for the tables and was bound by instruction issue at 4x
// the floor. Two facts of the math remove that work:
//
//  * Z does not read Y. It is the (N x G)(G x SC) product exp(psi W^T) muL,
//    so it runs on tensor cores: each warp owns 16 cell rows (the M of
//    mma.sync m16n8k8 TF32), its lanes form their A fragments exp(psi.W_g)
//    in registers, and the block stages muL once per gene tile in
//    B-fragment order (one conflict-free 16-byte load per lane and n-tile).
//    Three TF32 products (hi*hi + hi*lo + lo*hi, split with cvt.rna) keep Z
//    at float32 accuracy. Each 32-gene sub-tile is summed in fresh MMA
//    accumulators and added to the running sum on CUDA cores, so the tensor
//    cores' own accumulation never spans more than 12 products. The exp is
//    __expf (ex2.approx): its few-ulp error is far inside the tolerances.
//  * A1 needs only Y W: A1[n] = sum_k psi[n,k] (Y W)[n,k]. So Y is a plain
//    stream: each warp reads its 16 rows 32 genes at a time as 16-byte loads
//    (each load instruction covers four whole 128-byte lines), one sub-tile
//    ahead of use, and spends Kf (+ nA2) FMAs per element on it. The Z work
//    of a sub-tile covers the latency of the next sub-tile's loads.
//
// Measured at full width on an H100 80GB HBM3 (700 W) by chip_smoke.py:
// 0.90 ms. The Y stream, in this pattern of 128-byte pieces of 16 rows, sets
// that time, not the tensor cores: a build without the Z work was nearly as
// slow, and a cp.async ring holding two sub-tiles in flight did not read Y
// faster.
//
// Backward (replaces _bwd_kernel): a cell-major dpsi kernel, a gene-major
// kernel for dW, d(muL), dlog mu and a reduction of its partial sums.
//
//  * dpsi reads no Y. With rfe = exp(psi W^T), drfe = dZ muL^T and
//    dlog_rfe = Y dA1 + rfe drfe,
//      dpsi[n,k] = dA1[n] (Y W)[n,k] + sum_j dZ[n,j] T[n,k,j],
//      T[n,k,j]  = sum_g (rfe[n,g] W[g,k]) muL[g,j],
//    exactly. Y W is the forward's, stored by fwd_kernel (N x Kf floats)
//    and kept by the autograd function. T is the forward's Z with the A
//    fragments scaled by W[g,k]: the same warp layout, the same 3xTF32
//    mma.sync and the same muL staging, with one exp per element shared by
//    all k. dpsi is a signed sum that cancels,
//    so its accuracy needs more care than Z's sum of positive terms: each
//    k-step's three products go to fresh MMA accumulators and are added on
//    CUDA cores (the tensor cores' own sum does not round to nearest),
//    each 32-gene sub-tile's T is folded into the lane's dZ values at once
//    (2 Kf sums a lane stay live), and the sub-tiles are summed in float64.
//    The lanes of a row group are summed with shuffles; no atomics. What
//    bounds it is exp and MMA throughput (N*G exps, 6 Kf * ceil(SC/8)
//    MMAs per 8 x 16 elements) and the per-tile staging, not bytes: it
//    reads only the O(N (Kf + SC)) cell vectors. Measured at full width
//    (S*C = 10, Kf = 1) on an H100 80GB HBM3 (700 W) by chip_smoke.py:
//    0.58 ms, against 0.12 ms for its exps on the special-function units
//    (the slowest of its units at their peaks); the gene-major part below
//    takes 1.26 ms.
//  * gene-major kernel (dW, d(muL), dlog mu): a thread owns one gene and
//    walks a chunk of cells, reading Y rows coalesced across genes; the
//    per-cell vectors (psi, dA1, dZ, dA2) of a tile of cells are staged in
//    shared memory, and the cell loop is unrolled so several Y loads are in
//    flight. Each (chunk, gene) writes its own partial sum and a second
//    kernel adds the chunks in a fixed order: no atomics, so every result
//    is deterministic. It is float32 on CUDA cores, and is now the
//    backward's only read of Y (0.60 ms at full width).
//
// TMA, narrow Y storage and a lane axis for batched restarts are not used
// here.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxKf = 4;
constexpr int kMaxA2 = 4;
constexpr int kGeneThreads = 128;  // gene-major backward blocks
constexpr int kTileN = 64;         // cells staged in shared memory at once
constexpr int kTileG = 128;        // genes per shared-memory table tile
constexpr int kGeneUnroll = 8;     // cells in flight per gene-major thread
constexpr int kFwdWarps = 8;       // forward and dpsi blocks: 8 warps x 16 cell rows
constexpr int kFwdRows = 16;       // cell rows a warp owns (the MMA's M)
constexpr int kFwdSub = 32;        // genes a warp takes per sub-tile
constexpr int kSteps = kTileG / 8;  // MMA k-steps of 8 genes per table tile

// ---------------------------------------------------------------------------
// Tensor-core pieces shared by the forward and dpsi kernels. One warp per 16
// cell rows; the block's warps share each tile of the gene tables in shared
// memory. KF columns of psi and W, NT n-tiles of 8 Z columns.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32: hi carries x's top 11 significand bits, lo the next 11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b for a 16x8 (row) A, an 8x8 (col) B and a 16x8 float32 D.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the gene tile [gs, gs + kTileG): s_w[k][t] = W[gs + t, k], and muL
// in B-fragment order split into TF32 hi and lo, so that a lane's operands
// for n-tile t of k-step ks are one 16-byte load of s_b[ks][t][lane]. Zero
// past G, Kf and SC: padded genes then add exp(psi . 0) * 0 to Z and 0 * W
// to T. The caller synchronizes around it.
template <int KF, int NT>
__device__ __forceinline__ void stage_tables(float (*s_w)[kTileG],
                                             float4 (*s_b)[NT][kWarp],
                                             const float* __restrict__ W,
                                             const float* __restrict__ muL,
                                             int G, int Kf, int SC, int gs) {
  for (int i = threadIdx.x; i < KF * kTileG; i += blockDim.x) {
    const int t = i / KF, k = i % KF, g = gs + t;  // W read row-major, coalesced
    s_w[k][t] = (k < Kf && g < G) ? W[(size_t)g * Kf + k] : 0.f;
  }
  for (int i = threadIdx.x; i < kSteps * NT * kWarp; i += blockDim.x) {
    const int l = i % kWarp, t = (i / kWarp) % NT, ks = i / (kWarp * NT);
    const int j = t * 8 + (l >> 2), g = gs + ks * 8 + (l & 3);
    const float b0 = (j < SC && g < G) ? muL[(size_t)g * SC + j] : 0.f;
    const float b1 = (j < SC && g + 4 < G) ? muL[(size_t)(g + 4) * SC + j] : 0.f;
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    s_b[ks][t][l] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                __uint_as_float(l0), __uint_as_float(l1));
  }
}

// d += a b in float32 from TF32 parts: lo.hi + hi.lo + hi.hi, with b the
// 16-byte fragment (hi0, hi1, lo0, lo1) that stage_tables wrote.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], float4 b) {
  const uint32_t b_hi0 = __float_as_uint(b.x), b_hi1 = __float_as_uint(b.y);
  mma_tf32(d, a_lo, b_hi0, b_hi1);
  mma_tf32(d, a_hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, a_hi, b_hi0, b_hi1);
}

// Genes g .. g+3 of one Y row, zero past G. vec: rows are 16-byte aligned
// (G % 4 == 0 and Y aligned), so g .. g+3 are all in or all out.
__device__ __forceinline__ float4 load_y4(const float* __restrict__ row, int g,
                                          int G, bool vec) {
  if (vec) return g < G ? __ldcs(reinterpret_cast<const float4*>(row + g))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  return make_float4(g < G ? __ldcs(row + g) : 0.f, g + 1 < G ? __ldcs(row + g + 1) : 0.f,
                     g + 2 < G ? __ldcs(row + g + 2) : 0.f,
                     g + 3 < G ? __ldcs(row + g + 3) : 0.f);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

// ---------------------------------------------------------------------------
// Forward: A1, optional A2, Z and Y W. KF = max(Kf, 1).
// ---------------------------------------------------------------------------
template <int KF, int NT, bool WITH_A2>
__global__ void __launch_bounds__(kFwdWarps * kWarp)
fwd_kernel(const float* __restrict__ Y, const float* __restrict__ psi,
           const float* __restrict__ W, const float* __restrict__ logmu,
           const float* __restrict__ muL, float* __restrict__ A1,
           float* __restrict__ A2, float* __restrict__ Z,
           float* __restrict__ YW, int N, int G, int Kf, int nA2, int SC,
           bool vec) {
  constexpr int kA2 = WITH_A2 ? kMaxA2 : 1;
  __shared__ __align__(16) float s_w[KF][kTileG];         // W^T of the tile
  __shared__ __align__(16) float4 s_b[kSteps][NT][kWarp];  // muL, B fragments
  __shared__ __align__(16) float s_lm[kA2][kTileG];        // log mu of the tile

  const int lane = threadIdx.x % kWarp;
  const int row0 = (blockIdx.x * kFwdWarps + threadIdx.x / kWarp) * kFwdRows;
  // MMA fragments: this lane's A rows are r and r + 8, its A columns (genes)
  // c and c + 4, its B column (of an n-tile) r.
  const int fr = lane >> 2, fc = lane & 3;
  // Y stream: this lane reads genes 4q .. 4q+3 of a sub-tile for rows
  // yr, yr + 4, yr + 8, yr + 12 of the warp's 16.
  const int q = lane & 7, yr = lane >> 3;

  float p0[KF], p1[KF];  // psi of the lane's two A rows
#pragma unroll
  for (int k = 0; k < KF; ++k) {
    const int n0 = row0 + fr, n1 = n0 + 8;
    p0[k] = (k < Kf && n0 < N) ? psi[(size_t)n0 * Kf + k] : 0.f;
    p1[k] = (k < Kf && n1 < N) ? psi[(size_t)n1 * Kf + k] : 0.f;
  }
  const float* y_rows = Y + (size_t)(row0 + yr) * G;
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) live[i] = row0 + yr + 4 * i < N;
  auto load_sub = [&](float4 (&y)[4], int g) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[i] = live[i] ? load_y4(y_rows + (size_t)(4 * i) * G, g + 4 * q, G, vec)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  float yw[4][KF], ylm[4][kA2], z[NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < KF; ++k) yw[i][k] = 0.f;
#pragma unroll
    for (int s = 0; s < kA2; ++s) ylm[i][s] = 0.f;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[t][e] = 0.f;

  float4 y_next[4];
  load_sub(y_next, 0);
  const int n_sub = (G + kFwdSub - 1) / kFwdSub;
  // No early exit: every warp takes part in the block's barriers; rows past
  // N compute on zeros and write nothing.
#pragma unroll 1
  for (int sub = 0; sub < n_sub; ++sub) {
    const int gs = sub * kFwdSub;
    const int c0 = gs % kTileG;  // the sub-tile's first column in the table tile
    if (c0 == 0) {
      __syncthreads();  // the previous tile is fully consumed
      stage_tables<KF, NT>(s_w, s_b, W, muL, G, Kf, SC, gs);
      if constexpr (WITH_A2) {
        for (int i = threadIdx.x; i < kMaxA2 * kTileG; i += blockDim.x) {
          const int s = i / kTileG, t = i % kTileG, g = gs + t;
          s_lm[s][t] = (s < nA2 && g < G) ? logmu[(size_t)s * G + g] : 0.f;
        }
      }
      __syncthreads();
    }

    float4 y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = y_next[i];
    if (sub + 1 < n_sub) load_sub(y_next, gs + kFwdSub);

    // Z on tensor cores, this sub-tile summed in fresh accumulators.
    float zs[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) zs[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kFwdSub / 8; ++ks) {
      const int c = c0 + ks * 8;
      // A fragment order: (r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4).
      float lr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < KF; ++k) {
        const float w0 = s_w[k][c + fc], w1 = s_w[k][c + fc + 4];
        lr[0] = fmaf(p0[k], w0, lr[0]);
        lr[1] = fmaf(p1[k], w0, lr[1]);
        lr[2] = fmaf(p0[k], w1, lr[2]);
        lr[3] = fmaf(p1[k], w1, lr[3]);
      }
      uint32_t a_hi[4], a_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__expf(lr[e]), a_hi[e], a_lo[e]);
#pragma unroll
      for (int t = 0; t < NT; ++t) mma_3xtf32(zs[t], a_hi, a_lo, s_b[c / 8][t][lane]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[t][e] += zs[t][e];

    // Y W (and Y log mu) on CUDA cores.
#pragma unroll
    for (int k = 0; k < KF; ++k) {
      const float4 w = *reinterpret_cast<const float4*>(&s_w[k][c0 + 4 * q]);
#pragma unroll
      for (int i = 0; i < 4; ++i) yw[i][k] = dot4(y[i], w, yw[i][k]);
    }
    if constexpr (WITH_A2) {
#pragma unroll
      for (int s = 0; s < kMaxA2; ++s) {
        const float4 m = *reinterpret_cast<const float4*>(&s_lm[s][c0 + 4 * q]);
#pragma unroll
        for (int i = 0; i < 4; ++i) ylm[i][s] = dot4(y[i], m, ylm[i][s]);
      }
    }
  }

  // A1, Y W and A2: the 8 lanes of a row group hold sums over disjoint genes.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = row0 + yr + 4 * i;
    float a1 = 0.f;
#pragma unroll
    for (int k = 0; k < KF; ++k) {
      float v = yw[i][k];
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (k < Kf && n < N) {
        a1 = fmaf(psi[(size_t)n * Kf + k], v, a1);
        if (q == 0) YW[(size_t)n * Kf + k] = v;
      }
    }
    if (q == 0 && n < N) A1[n] = a1;
    if constexpr (WITH_A2) {
#pragma unroll
      for (int s = 0; s < kMaxA2; ++s) {
        float v = ylm[i][s];
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (q == 0 && n < N && s < nA2) A2[(size_t)n * nA2 + s] = v;
      }
    }
  }
  // Z: D fragment order (r, 2c), (r, 2c + 1), (r + 8, 2c), (r + 8, 2c + 1).
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int j = t * 8 + 2 * fc;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = row0 + fr + (e >> 1) * 8, jj = j + (e & 1);
      if (n < N && jj < SC) Z[(size_t)n * SC + jj] = z[t][e];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, cell-major, Y-free: dpsi[n,k] = dA1[n] YW[n,k]
//   + sum_j dZ[n,j] sum_g (exp(psi[n].W[g]) W[g,k]) muL[g,j].
// KF = Kf (1..4). The layout and the MMA are the forward's.
// ---------------------------------------------------------------------------
template <int KF, int NT>
__global__ void __launch_bounds__(kFwdWarps * kWarp)
dpsi_kernel(const float* __restrict__ psi, const float* __restrict__ W,
            const float* __restrict__ muL, const float* __restrict__ dA1,
            const float* __restrict__ dZ, const float* __restrict__ YW,
            float* __restrict__ dpsi, int N, int G, int SC) {
  __shared__ __align__(16) float s_w[KF][kTileG];         // W^T of the tile
  __shared__ __align__(16) float4 s_b[kSteps][NT][kWarp];  // muL, B fragments

  const int lane = threadIdx.x % kWarp;
  const int row0 = (blockIdx.x * kFwdWarps + threadIdx.x / kWarp) * kFwdRows;
  // MMA fragments as in the forward: A rows n0 = row0 + r and n1 = n0 + 8,
  // A columns (genes) c and c + 4; D columns 2c and 2c + 1 of each n-tile.
  const int fr = lane >> 2, fc = lane & 3;
  const int n0 = row0 + fr, n1 = n0 + 8;

  float p0[KF], p1[KF];  // psi of the lane's two A rows
#pragma unroll
  for (int k = 0; k < KF; ++k) {
    p0[k] = n0 < N ? psi[(size_t)n0 * KF + k] : 0.f;
    p1[k] = n1 < N ? psi[(size_t)n1 * KF + k] : 0.f;
  }
  // dZ at the lane's D fragment: (n0, j), (n0, j + 1), (n1, j), (n1, j + 1)
  // with j = 8t + 2c; zero past N and SC.
  float dz[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? n0 : n1, j = t * 8 + 2 * fc + (e & 1);
      dz[t][e] = (n < N && j < SC) ? dZ[(size_t)n * SC + j] : 0.f;
    }
  // sum_j dZ T for rows n0 and n1 over this lane's columns, in float64: the
  // sub-tiles' signed sums cancel, and a float32 running sum lost more to
  // rounding than the 3xTF32 products do.
  double acc[KF][2];
#pragma unroll
  for (int k = 0; k < KF; ++k) acc[k][0] = acc[k][1] = 0.0;

  const int n_sub = (G + kFwdSub - 1) / kFwdSub;
  // No early exit: every warp takes part in the block's barriers; rows past
  // N compute on zeros and write nothing.
#pragma unroll 1
  for (int sub = 0; sub < n_sub; ++sub) {
    const int gs = sub * kFwdSub;
    const int c0 = gs % kTileG;  // the sub-tile's first column in the table tile
    if (c0 == 0) {
      __syncthreads();  // the previous tile is fully consumed
      stage_tables<KF, NT>(s_w, s_b, W, muL, G, KF, SC, gs);
      __syncthreads();
    }

    // T of this sub-tile on tensor cores.
    float zs[KF][NT][4];
#pragma unroll
    for (int k = 0; k < KF; ++k)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) zs[k][t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kFwdSub / 8; ++ks) {
      const int c = c0 + ks * 8;
      // A fragment order: (r, c), (r + 8, c), (r, c + 4), (r + 8, c + 4).
      float w0[KF], w1[KF], lr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < KF; ++k) {
        w0[k] = s_w[k][c + fc];
        w1[k] = s_w[k][c + fc + 4];
        lr[0] = fmaf(p0[k], w0[k], lr[0]);
        lr[1] = fmaf(p1[k], w0[k], lr[1]);
        lr[2] = fmaf(p0[k], w1[k], lr[2]);
        lr[3] = fmaf(p1[k], w1[k], lr[3]);
      }
      float rfe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) rfe[e] = __expf(lr[e]);
      float4 b[NT];
#pragma unroll
      for (int t = 0; t < NT; ++t) b[t] = s_b[c / 8][t][lane];
#pragma unroll
      for (int k = 0; k < KF; ++k) {
        uint32_t a_hi[4], a_lo[4];
        split_tf32(rfe[0] * w0[k], a_hi[0], a_lo[0]);
        split_tf32(rfe[1] * w0[k], a_hi[1], a_lo[1]);
        split_tf32(rfe[2] * w1[k], a_hi[2], a_lo[2]);
        split_tf32(rfe[3] * w1[k], a_hi[3], a_lo[3]);
        // Each k-step's three products in fresh accumulators, added on CUDA
        // cores: the tensor cores' own sum does not round to nearest, and
        // over a 12-product chain its error showed at cancelling elements.
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, a_hi, a_lo, b[t]);
#pragma unroll
          for (int e = 0; e < 4; ++e) zs[k][t][e] += d[e];
        }
      }
    }
    // Fold the sub-tile's T into the lane's dZ values (float32 within the
    // sub-tile, float64 across sub-tiles).
#pragma unroll
    for (int k = 0; k < KF; ++k) {
      float f0 = 0.f, f1 = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        f0 = fmaf(zs[k][t][1], dz[t][1], fmaf(zs[k][t][0], dz[t][0], f0));
        f1 = fmaf(zs[k][t][3], dz[t][3], fmaf(zs[k][t][2], dz[t][2], f1));
      }
      acc[k][0] += f0;
      acc[k][1] += f1;
    }
  }

  // The 4 lanes of a row group hold disjoint columns j; lane c == 0 stores.
#pragma unroll
  for (int k = 0; k < KF; ++k) {
    double v0 = acc[k][0], v1 = acc[k][1];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, o);
      v1 += __shfl_xor_sync(0xffffffffu, v1, o);
    }
    if (fc == 0 && n0 < N)
      dpsi[(size_t)n0 * KF + k] = (float)fma((double)dA1[n0], (double)YW[(size_t)n0 * KF + k], v0);
    if (fc == 0 && n1 < N)
      dpsi[(size_t)n1 * KF + k] = (float)fma((double)dA1[n1], (double)YW[(size_t)n1 * KF + k], v1);
  }
}

// ---------------------------------------------------------------------------
// Backward, gene-major partial sums over one chunk of cells:
//   part[chunk, f, g] for f in [dW^T (Kf rows) | d(muL)^T (SC rows) | dlog_mu (nA2 rows)]
// ---------------------------------------------------------------------------
template <int MAX_SC, bool WITH_A2>
__global__ void __launch_bounds__(kGeneThreads)
gene_kernel(const float* __restrict__ Y, const float* __restrict__ psi,
            const float* __restrict__ Wt, const float* __restrict__ muLt,
            const float* __restrict__ dA1, const float* __restrict__ dA2,
            const float* __restrict__ dZ, float* __restrict__ part,
            int N, int G, int Kf, int nA2, int SC, int rows_per_chunk) {
  __shared__ float s_psi[kTileN][kMaxKf];
  __shared__ float s_da1[kTileN];
  __shared__ float s_dz[kTileN][MAX_SC];
  __shared__ float s_da2[kTileN][kMaxA2];

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool gene_live = g < G;
  const int chunk = blockIdx.y;
  const int n_begin = chunk * rows_per_chunk;
  const int n_end = min(N, n_begin + rows_per_chunk);

  float w[kMaxKf], m[MAX_SC];
#pragma unroll
  for (int k = 0; k < kMaxKf; ++k) w[k] = (gene_live && k < Kf) ? Wt[(size_t)k * G + g] : 0.f;
#pragma unroll
  for (int j = 0; j < MAX_SC; ++j) m[j] = (gene_live && j < SC) ? muLt[(size_t)j * G + g] : 0.f;

  float acc_w[kMaxKf], acc_m[MAX_SC], acc_a2[kMaxA2];
#pragma unroll
  for (int k = 0; k < kMaxKf; ++k) acc_w[k] = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_SC; ++j) acc_m[j] = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxA2; ++s) acc_a2[s] = 0.f;

  for (int t0 = n_begin; t0 < n_end; t0 += kTileN) {
    const int tn = min(kTileN, n_end - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < tn * kMaxKf; i += blockDim.x) {
      const int c = i / kMaxKf, k = i % kMaxKf;
      s_psi[c][k] = k < Kf ? psi[(size_t)(t0 + c) * Kf + k] : 0.f;
    }
    for (int i = threadIdx.x; i < tn; i += blockDim.x) s_da1[i] = dA1[t0 + i];
    for (int i = threadIdx.x; i < tn * MAX_SC; i += blockDim.x) {
      const int c = i / MAX_SC, j = i % MAX_SC;
      s_dz[c][j] = j < SC ? dZ[(size_t)(t0 + c) * SC + j] : 0.f;
    }
    if constexpr (WITH_A2) {
      for (int i = threadIdx.x; i < tn * kMaxA2; i += blockDim.x) {
        const int c = i / kMaxA2, s = i % kMaxA2;
        s_da2[c][s] = s < nA2 ? dA2[(size_t)(t0 + c) * nA2 + s] : 0.f;
      }
    }
    __syncthreads();
    if (gene_live) {
#pragma unroll kGeneUnroll
      for (int c = 0; c < tn; ++c) {
        const float y = Y[(size_t)(t0 + c) * G + g];
        float lr = 0.f;
#pragma unroll
        for (int k = 0; k < kMaxKf; ++k) lr = fmaf(s_psi[c][k], w[k], lr);
        const float e = expf(lr);
        float drfe = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_SC; ++j) drfe = fmaf(s_dz[c][j], m[j], drfe);
        const float d = fmaf(e, drfe, y * s_da1[c]);
#pragma unroll
        for (int k = 0; k < kMaxKf; ++k) acc_w[k] = fmaf(d, s_psi[c][k], acc_w[k]);
#pragma unroll
        for (int j = 0; j < MAX_SC; ++j) acc_m[j] = fmaf(e, s_dz[c][j], acc_m[j]);
        if constexpr (WITH_A2) {
#pragma unroll
          for (int s = 0; s < kMaxA2; ++s) acc_a2[s] = fmaf(y, s_da2[c][s], acc_a2[s]);
        }
      }
    }
  }

  if (!gene_live) return;
  const int F = Kf + SC + nA2;
  float* out = part + (size_t)chunk * F * G + g;
#pragma unroll
  for (int k = 0; k < kMaxKf; ++k)
    if (k < Kf) out[(size_t)k * G] = acc_w[k];
#pragma unroll
  for (int j = 0; j < MAX_SC; ++j)
    if (j < SC) out[(size_t)(Kf + j) * G] = acc_m[j];
  if (WITH_A2) {
#pragma unroll
    for (int s = 0; s < kMaxA2; ++s)
      if (s < nA2) out[(size_t)(Kf + SC + s) * G] = acc_a2[s];
  }
}

// out[i] = sum over chunks of part[chunk, i], chunks added in order.
__global__ void reduce_chunks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n_chunks,
                                     int FG) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= FG) return;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc += part[(size_t)c * FG + i];
  out[i] = acc;
}

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

template <int KF, int NT>
void launch_fwd(const float* Y, const float* psi, const float* W,
                const float* logmu, const float* muL, float* A1, float* A2,
                float* Z, float* YW, int N, int G, int Kf, int nA2, int SC,
                cudaStream_t stream) {
  const int grid = blocks_for(N, kFwdWarps * kFwdRows);
  const bool vec = G % 4 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  if (nA2 > 0)
    fwd_kernel<KF, NT, true><<<grid, kFwdWarps * kWarp, 0, stream>>>(
        Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, vec);
  else
    fwd_kernel<KF, NT, false><<<grid, kFwdWarps * kWarp, 0, stream>>>(
        Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, vec);
}

// One instantiation per n-tile count (8 Z columns each): every padding
// column costs the tensor cores a third of an n-tile's work.
template <int KF>
void launch_fwd_nt(const float* Y, const float* psi, const float* W,
                   const float* logmu, const float* muL, float* A1, float* A2,
                   float* Z, float* YW, int N, int G, int Kf, int nA2, int SC,
                   cudaStream_t stream) {
  if (SC <= 8)
    launch_fwd<KF, 1>(Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream);
  else if (SC <= 16)
    launch_fwd<KF, 2>(Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream);
  else
    launch_fwd<KF, 4>(Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream);
}

template <int KF>
void launch_dpsi(const float* psi, const float* W, const float* muL,
                 const float* dA1, const float* dZ, const float* YW, float* dpsi,
                 int N, int G, int SC, cudaStream_t stream) {
  const int grid = blocks_for(N, kFwdWarps * kFwdRows);
  if (SC <= 8)
    dpsi_kernel<KF, 1><<<grid, kFwdWarps * kWarp, 0, stream>>>(
        psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC);
  else if (SC <= 16)
    dpsi_kernel<KF, 2><<<grid, kFwdWarps * kWarp, 0, stream>>>(
        psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC);
  else
    dpsi_kernel<KF, 4><<<grid, kFwdWarps * kWarp, 0, stream>>>(
        psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC);
}

template <int MAX_SC>
void launch_gene(const float* Y, const float* psi, const float* Wt,
                 const float* muLt, const float* dA1, const float* dA2,
                 const float* dZ, float* part, float* dgene, int N, int G,
                 int Kf, int nA2, int SC, int rows_per_chunk,
                 cudaStream_t stream) {
  const int n_chunks = (N + rows_per_chunk - 1) / rows_per_chunk;
  const dim3 grid(blocks_for(G, kGeneThreads), n_chunks);
  if (nA2 > 0)
    gene_kernel<MAX_SC, true><<<grid, kGeneThreads, 0, stream>>>(
        Y, psi, Wt, muLt, dA1, dA2, dZ, part, N, G, Kf, nA2, SC, rows_per_chunk);
  else
    gene_kernel<MAX_SC, false><<<grid, kGeneThreads, 0, stream>>>(
        Y, psi, Wt, muLt, dA1, dA2, dZ, part, N, G, Kf, nA2, SC, rows_per_chunk);
  const int FG = (Kf + SC + nA2) * G;
  reduce_chunks_kernel<<<blocks_for(FG, 256), 256, 0, stream>>>(part, dgene, n_chunks, FG);
}

// One gene-major instantiation per bound on S*C: the accumulators are
// compile-time arrays, and every padding column costs a shared-memory load
// and an FMA per element (for C = 10 a CUDA-core forward of the same build
// ran 25% faster with the bound 12 than with 16 on an H100 80GB HBM3 at a
// 700 W power limit).
#define CA_DISPATCH_SC(SC, CALL)          \
  do {                                    \
    if ((SC) <= 8) { CALL(8); }           \
    else if ((SC) <= 12) { CALL(12); }    \
    else if ((SC) <= 16) { CALL(16); }    \
    else { CALL(32); }                    \
  } while (0)

bool bad_sizes(int N, int G, int Kf, int nA2, int SC, int rows_per_chunk) {
  return N < 1 || G < 1 || Kf < 0 || Kf > kMaxKf || nA2 < 0 || nA2 > kMaxA2 ||
         SC < 1 || SC > 32 || rows_per_chunk < 1;
}

}  // namespace

extern "C" {

// All pointers are device pointers to contiguous float32 arrays:
// Y (N,G), psi (N,Kf), W (G,Kf), logmu (nA2,G), muL (G,SC);
// outputs A1 (N), A2 (N,nA2), Z (N,SC) and YW (N,Kf) = Y W. nA2 == 0 skips
// A2 (logmu and A2 are then not read or written).
// Returns cudaGetLastError() after launch.
int fl_forward(const float* Y, const float* psi, const float* W,
               const float* logmu, const float* muL, float* A1, float* A2,
               float* Z, float* YW, int N, int G, int Kf, int nA2, int SC,
               cudaStream_t stream) {
  if (bad_sizes(N, G, Kf, nA2, SC, 1)) return (int)cudaErrorInvalidValue;
  switch (Kf) {
    case 0:  // rfe = exp(0) = 1 and A1 = 0: one zero column
    case 1: launch_fwd_nt<1>(Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream); break;
    case 2: launch_fwd_nt<2>(Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream); break;
    case 3: launch_fwd_nt<3>(Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream); break;
    default: launch_fwd_nt<4>(Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream);
  }
  return (int)cudaGetLastError();
}

// Backward, dpsi part. psi, W, muL as fl_forward, dA1 (N), dZ (N,SC) and
// YW (N,Kf) from fl_forward; output dpsi (N,Kf). Reads no Y. Kf == 0
// launches nothing.
int fl_backward_dpsi(const float* psi, const float* W, const float* muL,
                     const float* dA1, const float* dZ, const float* YW,
                     float* dpsi, int N, int G, int Kf, int SC,
                     cudaStream_t stream) {
  if (bad_sizes(N, G, Kf, 0, SC, 1)) return (int)cudaErrorInvalidValue;
  switch (Kf) {
    case 0: return (int)cudaSuccess;
    case 1: launch_dpsi<1>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream); break;
    case 2: launch_dpsi<2>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream); break;
    case 3: launch_dpsi<3>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream); break;
    default: launch_dpsi<4>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream);
  }
  return (int)cudaGetLastError();
}

// Backward, gene part. Y and psi as fl_forward, Wt (Kf,G), muLt (SC,G),
// dA1 (N), dA2 (N,nA2), dZ (N,SC). Output dgene (Kf+SC+nA2, G) =
// [dW^T; d(muL)^T; dlog_mu]; part is scratch of
// ceil(N/rows_per_chunk) * (Kf+SC+nA2) * G floats.
int fl_backward_gene(const float* Y, const float* psi, const float* Wt,
                     const float* muLt, const float* dA1, const float* dA2,
                     const float* dZ, float* part, float* dgene, int N, int G,
                     int Kf, int nA2, int SC, int rows_per_chunk,
                     cudaStream_t stream) {
  if (bad_sizes(N, G, Kf, nA2, SC, rows_per_chunk)) return (int)cudaErrorInvalidValue;
#define CA_GENE(M)                                                           \
  launch_gene<M>(Y, psi, Wt, muLt, dA1, dA2, dZ, part, dgene, N, G, Kf, nA2, \
                 SC, rows_per_chunk, stream)
  CA_DISPATCH_SC(SC, CA_GENE);
#undef CA_GENE
  return (int)cudaGetLastError();
}

}  // extern "C"

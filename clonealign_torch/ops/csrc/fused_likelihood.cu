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
//
// What bounds it on the card. At the 100,000 x 5,000 x 10 clones fit the
// forward and the cell-major backward each read Y once (N*G*4 B = 2 GB,
// about 0.6 ms at 3.35 TB/s) and spend one exp plus SC FMAs per element
// (5e8 exps and 5e9 FMAs, well under the float32 and SFU peaks). The gene
// tables (W, mu*L, log mu: G x (Kf+SC+S) floats, 220 KB) are small. Measured
// on the card, the first design (one warp per 4 cells, table entries read
// from L2 into registers) was bound by latency at low occupancy, not by
// bytes: 128-165 registers a thread left 8-16 warps per SM to cover the
// loads. The design below keeps registers low and loads in flight:
//
//  * forward and cell-major backward: one warp owns one cell row; lanes
//    stride over genes, so each load of a Y row is 128 contiguous bytes.
//    The block's warps share each tile of the gene tables in shared memory,
//    and a tile's genes are an unrolled loop, so its Y loads overlap. Per-row
//    partial sums live in registers and are reduced with warp shuffles.
//  * gene-major backward (dW, d(muL), dlog mu): a thread owns one gene and
//    walks a chunk of cells, reading Y rows coalesced across genes; the
//    per-cell vectors (psi, dA1, dZ, dA2) of a tile of cells are staged in
//    shared memory, and the cell loop is unrolled so several Y loads are in
//    flight. Each (chunk, gene) writes its own partial sum and a second
//    kernel adds the chunks in a fixed order: no atomics, so every result
//    is deterministic.
//
// Everything is float32 with float32 accumulation on CUDA cores. Tensor
// cores, TMA, narrow Y storage and a lane axis for batched restarts are not
// used here.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxKf = 4;
constexpr int kMaxA2 = 4;
constexpr int kRowThreads = 256;   // forward and cell-major backward blocks
constexpr int kGeneThreads = 128;  // gene-major backward blocks
constexpr int kTileN = 64;         // cells staged in shared memory at once
constexpr int kTileG = 128;        // genes per shared-memory table tile
constexpr int kGeneUnroll = 8;     // cells in flight per gene-major thread

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy rows [0, used) of a gene-contiguous (rows, G) table, genes
// [g0, g0 + kTileG), into dst[row][t]; zero past the used rows and past G,
// so padded genes contribute exp(0) * 0 = 0 to Z and nothing elsewhere.
template <int ROWS>
__device__ __forceinline__ void load_tile(float (*dst)[kTileG],
                                          const float* __restrict__ src,
                                          int used, int G, int g0) {
  for (int i = threadIdx.x; i < ROWS * kTileG; i += blockDim.x) {
    const int row = i / kTileG, t = i % kTileG, g = g0 + t;
    dst[row][t] = (row < used && g < G) ? src[(size_t)row * G + g] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Forward: A1, optional A2, Z. One warp per cell row; the block's warps share
// each tile of the gene tables in shared memory.
// ---------------------------------------------------------------------------
template <int MAX_SC, bool WITH_A2>
__global__ void __launch_bounds__(kRowThreads)
fwd_kernel(const float* __restrict__ Y, const float* __restrict__ psi,
           const float* __restrict__ Wt, const float* __restrict__ logmu,
           const float* __restrict__ muLt, float* __restrict__ A1,
           float* __restrict__ A2, float* __restrict__ Z,
           int N, int G, int Kf, int nA2, int SC) {
  __shared__ float s_w[kMaxKf][kTileG];
  __shared__ float s_m[MAX_SC][kTileG];
  __shared__ float s_lm[WITH_A2 ? kMaxA2 : 1][kTileG];
  const int lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  // No early exit: every warp takes part in the block's barriers; a warp
  // past the last row computes on zeros and writes nothing.
  const bool live = n < N;
  const float* y_row = Y + (size_t)(live ? n : 0) * G;

  float p[kMaxKf], a1 = 0.f, a2[kMaxA2], z[MAX_SC];
#pragma unroll
  for (int k = 0; k < kMaxKf; ++k) p[k] = (live && k < Kf) ? psi[(size_t)n * Kf + k] : 0.f;
#pragma unroll
  for (int s = 0; s < kMaxA2; ++s) a2[s] = 0.f;
#pragma unroll
  for (int j = 0; j < MAX_SC; ++j) z[j] = 0.f;

  for (int g0 = 0; g0 < G; g0 += kTileG) {
    __syncthreads();  // the previous tile is fully consumed
    load_tile<kMaxKf>(s_w, Wt, Kf, G, g0);
    load_tile<MAX_SC>(s_m, muLt, SC, G, g0);
    if constexpr (WITH_A2) load_tile<kMaxA2>(s_lm, logmu, nA2, G, g0);
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kTileG / kWarp; ++it) {
      const int t = it * kWarp + lane;
      const int g = g0 + t;
      const float y = (live && g < G) ? y_row[g] : 0.f;
      float lr = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxKf; ++k) lr = fmaf(p[k], s_w[k][t], lr);
      a1 = fmaf(y, lr, a1);
      if constexpr (WITH_A2) {
#pragma unroll
        for (int s = 0; s < kMaxA2; ++s) a2[s] = fmaf(y, s_lm[s][t], a2[s]);
      }
      const float e = expf(lr);
#pragma unroll
      for (int j = 0; j < MAX_SC; ++j) z[j] = fmaf(e, s_m[j][t], z[j]);
    }
  }

  a1 = warp_sum(a1);
  if (lane == 0 && live) A1[n] = a1;
  if constexpr (WITH_A2) {
#pragma unroll
    for (int s = 0; s < kMaxA2; ++s) {
      const float t = warp_sum(a2[s]);
      if (lane == 0 && live && s < nA2) A2[(size_t)n * nA2 + s] = t;
    }
  }
#pragma unroll
  for (int j = 0; j < MAX_SC; ++j) {
    const float t = warp_sum(z[j]);
    if (lane == 0 && live && j < SC) Z[(size_t)n * SC + j] = t;
  }
}

// ---------------------------------------------------------------------------
// Backward, cell-major: dpsi[n,k] = sum_g dlog_rfe[n,g] W[g,k] with
// dlog_rfe = Y dA1[n] + rfe * (sum_j dZ[n,j] muL[g,j]). Same layout as the
// forward.
// ---------------------------------------------------------------------------
template <int MAX_SC>
__global__ void __launch_bounds__(kRowThreads)
dpsi_kernel(const float* __restrict__ Y, const float* __restrict__ psi,
            const float* __restrict__ Wt, const float* __restrict__ muLt,
            const float* __restrict__ dA1, const float* __restrict__ dZ,
            float* __restrict__ dpsi, int N, int G, int Kf, int SC) {
  __shared__ float s_w[kMaxKf][kTileG];
  __shared__ float s_m[MAX_SC][kTileG];
  const int lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * (kRowThreads / kWarp) + threadIdx.x / kWarp;
  const bool live = n < N;
  const float* y_row = Y + (size_t)(live ? n : 0) * G;

  float p[kMaxKf], dz[MAX_SC], acc[kMaxKf];
#pragma unroll
  for (int k = 0; k < kMaxKf; ++k) {
    p[k] = (live && k < Kf) ? psi[(size_t)n * Kf + k] : 0.f;
    acc[k] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < MAX_SC; ++j) dz[j] = (live && j < SC) ? dZ[(size_t)n * SC + j] : 0.f;
  const float da1 = live ? dA1[n] : 0.f;

  for (int g0 = 0; g0 < G; g0 += kTileG) {
    __syncthreads();
    load_tile<kMaxKf>(s_w, Wt, Kf, G, g0);
    load_tile<MAX_SC>(s_m, muLt, SC, G, g0);
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kTileG / kWarp; ++it) {
      const int t = it * kWarp + lane;
      const int g = g0 + t;
      const float y = (live && g < G) ? y_row[g] : 0.f;
      float lr = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxKf; ++k) lr = fmaf(p[k], s_w[k][t], lr);
      float drfe = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_SC; ++j) drfe = fmaf(dz[j], s_m[j][t], drfe);
      const float d = fmaf(expf(lr), drfe, y * da1);
#pragma unroll
      for (int k = 0; k < kMaxKf; ++k) acc[k] = fmaf(d, s_w[k][t], acc[k]);
    }
  }

#pragma unroll
  for (int k = 0; k < kMaxKf; ++k) {
    const float t = warp_sum(acc[k]);
    if (lane == 0 && live && k < Kf) dpsi[(size_t)n * Kf + k] = t;
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

template <int MAX_SC>
void launch_fwd(const float* Y, const float* psi, const float* Wt,
                const float* logmu, const float* muLt, float* A1, float* A2,
                float* Z, int N, int G, int Kf, int nA2, int SC,
                cudaStream_t stream) {
  const int grid = blocks_for((long long)N * kWarp, kRowThreads);
  if (nA2 > 0)
    fwd_kernel<MAX_SC, true><<<grid, kRowThreads, 0, stream>>>(
        Y, psi, Wt, logmu, muLt, A1, A2, Z, N, G, Kf, nA2, SC);
  else
    fwd_kernel<MAX_SC, false><<<grid, kRowThreads, 0, stream>>>(
        Y, psi, Wt, logmu, muLt, A1, A2, Z, N, G, Kf, nA2, SC);
}

template <int MAX_SC>
void launch_bwd(const float* Y, const float* psi, const float* Wt,
                const float* muLt, const float* dA1, const float* dA2,
                const float* dZ, float* dpsi, float* part, float* dgene,
                int N, int G, int Kf, int nA2, int SC, int rows_per_chunk,
                cudaStream_t stream) {
  dpsi_kernel<MAX_SC><<<blocks_for((long long)N * kWarp, kRowThreads), kRowThreads, 0, stream>>>(
      Y, psi, Wt, muLt, dA1, dZ, dpsi, N, G, Kf, SC);
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

// One instantiation per bound on S*C: the accumulators are compile-time
// arrays, and every padding column costs a shared-memory load and an FMA
// per element (for C = 10 the forward ran 25% faster with the bound 12 than
// with 16 on an H100 80GB HBM3 at a 700 W power limit).
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
// Y (N,G), psi (N,Kf), Wt (Kf,G), logmu (nA2,G), muLt (SC,G);
// outputs A1 (N), A2 (N,nA2), Z (N,SC). nA2 == 0 skips A2 (logmu and A2
// are then not read or written). Returns cudaGetLastError() after launch.
int fl_forward(const float* Y, const float* psi, const float* Wt,
               const float* logmu, const float* muLt, float* A1, float* A2,
               float* Z, int N, int G, int Kf, int nA2, int SC,
               cudaStream_t stream) {
  if (bad_sizes(N, G, Kf, nA2, SC, 1)) return (int)cudaErrorInvalidValue;
#define CA_FWD(M) launch_fwd<M>(Y, psi, Wt, logmu, muLt, A1, A2, Z, N, G, Kf, nA2, SC, stream)
  CA_DISPATCH_SC(SC, CA_FWD);
#undef CA_FWD
  return (int)cudaGetLastError();
}

// Backward. Inputs as fl_forward plus dA1 (N), dA2 (N,nA2), dZ (N,SC).
// Outputs dpsi (N,Kf) and dgene (Kf+SC+nA2, G) = [dW^T; d(muL)^T; dlog_mu].
// part is scratch of ceil(N/rows_per_chunk) * (Kf+SC+nA2) * G floats.
int fl_backward(const float* Y, const float* psi, const float* Wt,
                const float* muLt, const float* dA1, const float* dA2,
                const float* dZ, float* dpsi, float* part, float* dgene,
                int N, int G, int Kf, int nA2, int SC, int rows_per_chunk,
                cudaStream_t stream) {
  if (bad_sizes(N, G, Kf, nA2, SC, rows_per_chunk)) return (int)cudaErrorInvalidValue;
#define CA_BWD(M)                                                             \
  launch_bwd<M>(Y, psi, Wt, muLt, dA1, dA2, dZ, dpsi, part, dgene, N, G, Kf, \
                nA2, SC, rows_per_chunk, stream)
  CA_DISPATCH_SC(SC, CA_BWD);
#undef CA_BWD
  return (int)cudaGetLastError();
}

}  // extern "C"

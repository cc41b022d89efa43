// The split kernels' shared pieces: fused_likelihood.cu's float32 split
// forward and backward and fused_likelihood_f64.cu's float64 split gene part
// take their tiled products alike, and differ only in the element type,
// the tile of K a stage and the MMA a stage runs (each file's own). Here: a
// row-major matrix operand, the cp.async copies of its tiles into a stage,
// the ring of stages, and the walk over a warp's 32 x 32 outputs of a
// block's 64 x 64 tile (2 x 2 warps) in C fragment order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// cp.async of kBytes (16, 8 or 4) that reads the first `bytes` of them from
// gmem and zero-fills the rest (gmem a valid address even where bytes is 0).
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// A row-major matrix of T: (r, c) at p[r ld + c], zero past rows x cols;
// vec where 16-byte copies may read it (ld a whole number of 16 bytes, p
// 16-byte aligned).
template <class T>
struct TileMat {
  const T* p;
  long long ld;
  int rows, cols;
  bool vec;
};
template <class T>
inline TileMat<T> tile_mat(const T* p, long long ld, int rows, int cols) {
  return TileMat<T>{p, ld, rows, cols,
                    ld % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0};
}

// One product of a gene-product kernel: out[f, g] (+)= sum_n x[n, f] v[n, g]
// over a row block's cells n, out's rows G apart; m_tiles of 64 rows f.
template <class T>
struct TileJob {
  TileMat<T> x, v;
  T* out;
  int m_tiles;
};
template <class T>
struct TileJobs {
  TileJob<T> job[2];
};

// cp.async of rows [r0, r0 + R) x columns [c0, c0 + C) of m into s (rows P
// values apart) by the block's kThreads threads, zero past m's rows and
// columns: 16 bytes a copy where m.vec, else one value a copy.
template <int kThreads, int R, int C, int P, class T>
__device__ __forceinline__ void tile_load(T* s, const TileMat<T>& m, int r0, int c0) {
  constexpr int V = 16 / sizeof(T);
  if (m.vec) {
#pragma unroll
    for (int u = 0; u < R * C / V / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads, r = i / (C / V), c = V * (i % (C / V));
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < m.rows && gc < m.cols ? min(V, m.cols - gc) : 0;
      cp_async_zfill<16>(s + r * P + c, n ? m.p + gr * m.ld + gc : m.p, (int)sizeof(T) * n);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < R * C / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads, r = i / C, c = i % C;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < m.rows && gc < m.cols;
      cp_async_zfill<sizeof(T)>(s + r * P + c, in ? m.p + gr * m.ld + gc : m.p,
                                in ? (int)sizeof(T) : 0);
    }
  }
}

// The ring of kStages buffers over n_tiles stages: load(tile, buffer)
// starts a stage's copies, compute(buffer) runs on a landed one.
template <int kStages, class Load, class Compute>
__device__ __forceinline__ void tile_mainloop(int n_tiles, Load&& load, Compute&& compute) {
  __syncthreads();  // the block is done with the ring
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed, and the buffer of tile kt - 1 is free
    const int next = kt + kStages - 1;
    if (next < n_tiles) load(next, next % kStages);
    cp_async_commit();
    compute(kt % kStages);
  }
}

// f(row, col, i, j, h) for each pair acc[i][j][2h], acc[i][j][2h + 1] of a
// warp's accumulators (2 x 4 tiles of m16n8), at (row, col) and (row, col +
// 1) of the block's tile: the first kThreads threads, 2 x 2 warps of 32 x
// 32 outputs.
template <int kThreads, class F>
__device__ __forceinline__ void tile_each_pair(F&& f) {
  if (threadIdx.x >= kThreads) return;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = 32 * (warp / 2), wn = 32 * (warp % 2);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(wm + 16 * i + (lane >> 2) + 8 * h, wn + 8 * j + 2 * (lane & 3), i, j, h);
}

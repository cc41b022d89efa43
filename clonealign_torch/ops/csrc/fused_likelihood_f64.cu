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
// Design. The forward and the gene part run their products on the FP64
// tensor cores (mma.sync m16n8k8 f64: wgmma has no f64 type), and the exps
// and log_rfe = psi W^T on the CUDA cores, one exp an element, each in the
// register where the MMA takes it: the forward as unnormalised attention
// (cells the queries, genes the keys, muL the values), the gene part as
// FlashAttention-2's dK/dV pass. A warp owns 16 rows (cells, or genes) and
// its sums are MMA accumulators in registers, each column group or pass a
// built count of 8-column tiles (f64_plan's counts); the block's warps
// share a ring of two shared-memory stages of the walked axis, filled by
// 16-byte cp.async while the other is consumed, with the operands in
// fragment order (one 16-byte load a lane per fragment, no bank conflict):
// fwd_f64_pack_kernel and gene_f64_pack_kernel lay each side out so once a
// call, since copying operand by operand into that order cost more
// instructions than the arithmetic. Each (chunk,
// gene block) of the gene part writes its own partial sums, which
// reduce_chunks_f64_kernel adds in chunk order: no atomics, every result
// deterministic.
//
//  * fwd_f64_kernel<YT, NT>: output tiles [YW | A2 | Z] (the Y products'
//    tiles first), split evenly into column groups (grid.y) of at most 12
//    tiles; the group's NT accumulator tiles. A stage is 32 genes, four
//    k-steps of 8; lane (g, t) of a warp takes, in k-step ks, its cells g
//    and g + 8 at genes 8t + 2ks and 8t + 2ks + 1 (the A fragment's columns
//    t and t + 4; B's rows follow), so its 8 counts of a row in a stage are
//    consecutive. It forms log_rfe of its four elements from psi (its rows'
//    pairs) and W (the stage's pairs), A1 += Y log_rfe, the exps, and issues
//    Z += rfe muL with rfe as the A fragment, and YW, A2 with Y's exact
//    doubles as the A fragment of the same MMA: one read of Y and one exp
//    an element wherever the tiles fit one group (Kf + nA2 + S*C <= 96
//    columns in 12 tiles; the main path's 3). A group without Z tiles forms
//    no exp, one without Y tiles (and not the first) reads no Y.
//  * dpsi_f64_kernel reads no Y: dpsi = sum_g rfe (dZ muL^T) W, then
//    dA1 YW (the forward's) added last, the term order of the plain
//    version reference_dpsi. One lane owns one cell; its psi, sums and dZ
//    columns live in per-lane shared-memory slots, the stage's W and muL
//    are broadcast, 8 genes in registers so a slot serves 8 FMAs
//    (add_columns). dZ's columns go in groups of at most kDpsiCols, one
//    after another in the block (dpsi is linear in drfe), each recomputing
//    log_rfe and the exps; S*C <= 64 is one group.
//  * gene_f64_kernel<YT, NT, NK> (dW, d(muL), dlog mu): a block owns 64
//    genes (4 warps of 16) and one chunk of the cells (grid.y,
//    ops/fused_likelihood.py's _chunk_rows); a stage is 32 cells, four
//    n-tiles of 8. Per n-tile a warp forms drfe = muL dZ^T on the tensor
//    cores (muL's A fragments for the pass in registers, dZ^T the B), with
//    the C fragment (genes g, g + 8; cells 2t, 2t + 1) at the same places
//    log_rfe, rfe = exp and Y, d = rfe drfe + Y dA1; then the C fragments
//    become A fragments (C's columns 2t and 2t + 1 as A's k-columns t and
//    t + 4, the B rows permuted to match) of d(muL) += rfe^T dZ, dW +=
//    d^T psi and dlog mu += Y^T dA2. Tiles [dlog mu | d(muL)] go in passes
//    of at most 5, 4 or 2 tiles (NT) beside dW's NK = 1, 2 or 8 tiles, so
//    that the registers hold them; each pass recomputes rfe and adds its
//    part of drfe's term to dW (dW is linear in drfe), which goes to the
//    chunk's partial sums after each pass (the first pass stores, later
//    ones add), and the first pass adds Y dA1 psi.
//
// What bounds them on the card: a float64 exp is a software sequence on
// the FP64 units (an integer part, a polynomial of DFMAs, a scaling), about
// twenty FP64 instructions, where float32's __expf is one instruction on
// the special-function units; so at the main path's widths the exps, not
// Y's bytes, set the least time (chip_smoke.py counts the built sequence's
// FP64 instructions from cuobjdump -sass and reckons each kernel's bound
// with it), and at S*C 80 the products with muL on the FP64 tensor cores
// (67 TFLOP/s, twice the CUDA cores' FMA rate; m8n8k4 runs at half that
// on the H100, m16n8k4, k8 and k16 at the full rate). Counts of int8 and
// int16 Y become doubles by one FP64 add on their bits (a conversion issues
// at a quarter of the FMA rate). Times: PERF.md (chip_smoke.py,
// time_likelihood.py --f64).
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

// The launch plan (ops/fused_likelihood.py's f64_plan, checked by plan_of),
// in F64_PLAN_KEYS' order: the forward's tiles (f_yt of the Y products,
// f_tiles in all) in f_groups column groups of f_count (f_nt the built
// count) over f_blocks blocks; dpsi's dZ column groups; the gene part's
// tiles (g_st of dlog mu, g_tiles in all) in g_passes passes of g_count
// (g_nt built) beside dW's g_nk, its blocks of 64 genes, its chunks of rows
// cells and its partial sums (part doubles); each kernel's dynamic shared
// memory in bytes; and the packed tables' doubles (f_table the forward's,
// g_table the gene part's).
struct Plan {
  int f_yt, f_tiles, f_count, f_nt, f_groups, f_blocks, f_smem;
  int d_cols, d_groups, d_blocks, d_smem;
  int g_st, g_tiles, g_nk, g_count, g_nt, g_passes, g_blocks, rows, n_chunks, g_smem;
  size_t part, f_table, g_table;
};

struct FwdArgs {
  const void* Y;  // (N, G) in the storage type
  const double *psi, *W, *logmu, *muL;
  double *A1, *A2, *Z, *YW;
  const double2* table;  // fwd_f64_pack_kernel's
  int N, G, Kf, nA2, SC;
  Plan plan;
  cudaStream_t stream;
};

struct GeneArgs {
  const void* Y;  // (N, G) in the storage type
  const double *psi, *W, *muL, *dA1, *dA2, *dZ;
  double* part;          // (n_chunks, Kf + SC + nA2, G)
  const double2* table;  // gene_f64_pack_kernel's
  int N, G, Kf, nA2, SC;
  Plan plan;
  cudaStream_t stream;
};

// The Y-reading kernels of one storage type, and their blocks an SM under
// the plan (which: 0 the forward, 1 the gene part).
template <int YT> void forward_typed(const FwdArgs& a);
template <int YT> void gene_typed(const GeneArgs& a);
template <int YT> int blocks_per_sm(int which, const Plan& p);

}  // namespace fl64

namespace {

using namespace fl64;

constexpr int kWarp = 32;
// dpsi_f64_kernel: cells (lanes) a block, genes a stage, genes (cells) a
// lane holds in registers at once, the most dZ columns a group
// (ops/fused_likelihood.py's F64_CELLS, F64_GENES, F64_DPSI_COLS).
constexpr int kCells = 128;
constexpr int kGenes = 32;
constexpr int kSub = 8;
constexpr int kDpsiCols = 64;
// fwd_f64_kernel and gene_f64_kernel (F64_FWD_WARPS, F64_FWD_GENES,
// F64_GENE_WARPS, F64_GENE_CELLS): warps of 16 rows a block, genes (cells)
// a stage, and its k-steps (n-tiles) of 8; the tile counts they are built
// for (F64_FWD_TILE_COUNTS, F64_GENE_K_COUNTS, F64_GENE_TILE_COUNTS); the
// bytes of the Y rows a stage holds at the widest storage
// (F64_FWD_Y_STAGE_BYTES, F64_GENE_Y_STAGE_BYTES).
constexpr int kFwdWarps = 4, kFwdGenes = 32, kFwdSteps = kFwdGenes / 8;
constexpr int kGeneWarps = 4, kGeneCells = 32, kGeneTiles = kGeneCells / 8;
constexpr int kFwdTileCounts[] = {1, 2, 3, 4, 6, 8, 12};
constexpr int kGeneKCounts[] = {1, 2, 8};
constexpr int kGeneTileCounts1[] = {1, 2, 3, 4, 5};
constexpr int kGeneTileCounts2[] = {1, 2, 4};
constexpr int kGeneTileCounts8[] = {1, 2};
constexpr int kFwdYStageBytes = kFwdWarps * 16 * 320;  // float64's padded rows
constexpr int kGeneYStageBytes = kGeneCells * (64 * 8 + 16);
constexpr int kMaxKf = 64, kMaxA2 = 64, kMaxSC = 2048;
constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block may take

template <int YT> struct Y64;
template <> struct Y64<kYF64> { using Elem = double; };
template <> struct Y64<kYBF16> { using Elem = uint16_t; };  // bfloat16 bits
template <> struct Y64<kYI16> { using Elem = int16_t; };
template <> struct Y64<kYI8> { using Elem = int8_t; };

// A 32-bit integer as a double, exactly: the bits of 2^52 + 2^51 + 2^31 + v,
// less the constant. One FP64 add, where a conversion (I2F.F64) issues at a
// quarter of the FMA rate.
__device__ __forceinline__ double int_to_double(int v) {
  return __hiloint2double(0x43380000, (int)((unsigned)v ^ 0x80000000u)) - 6755401588539392.0;
}

// One count as a double, exactly (a bfloat16 is the top half of a float).
template <int YT>
__device__ __forceinline__ double y_to_double(typename Y64<YT>::Elem e) {
  if constexpr (YT == kYF64) {
    return e;
  } else if constexpr (YT == kYBF16) {
    return (double)__uint_as_float((uint32_t)e << 16);
  } else {
    return int_to_double((int)e);
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
// d += a b on the FP64 tensor cores (mma.sync m16n8k8): lane 4g + t holds
// A (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) in a[0..3], B (t, g) and
// (t + 4, g) in b, and C (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// in d[0..3].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[4], double2 b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b.x), "d"(b.y));
}

// cp.async of kBytes (8 or 16) from src into shared memory, or kBytes of
// zeros where src is null (then `dummy`, a valid address, is named and not
// read).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, const void* dummy) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = src ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src ? src : dummy), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
                 "l"(src ? src : dummy), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Counts gene .. gene + 7 of row n into dst, zero past G and for n >= N. vec:
// G % 8 == 0 and Y 16-byte aligned, so the 8 counts are one aligned piece
// (8, 16 or 64 bytes), all within G or all past it, copied by cp.async; else
// count by count (float64 by cp.async, narrow types by the thread's loads
// and stores, visible after the stage's barrier).
template <int YT>
__device__ __forceinline__ void stage_y8(unsigned char* dst,
                                         const typename Y64<YT>::Elem* __restrict__ Y, int n,
                                         int gene, int N, int G, bool vec) {
  using Elem = typename Y64<YT>::Elem;
  const bool live = n < N;
  const Elem* src = Y + (size_t)(live ? n : 0) * G + gene;
  if (vec) {
    const bool in = live && gene < G;
    if constexpr (YT == kYF64) {
#pragma unroll
      for (int p = 0; p < 4; ++p) cp_async<16>(dst + 16 * p, in ? src + 2 * p : nullptr, Y);
    } else if constexpr (YT == kYI8) {
      cp_async<8>(dst, in ? src : nullptr, Y);
    } else {
      cp_async<16>(dst, in ? src : nullptr, Y);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool in = live && gene + u < G;
      if constexpr (YT == kYF64)
        cp_async<8>(dst + 8 * u, in ? src + u : nullptr, Y);
      else
        reinterpret_cast<Elem*>(dst)[u] = in ? src[u] : Elem(0);
    }
  }
}

// A lane's 8 counts of one Y row in a forward stage (genes 8t .. 8t + 7 of
// the stage, at kChunk bytes a lane and kRow a row: bank-conflict free
// reads), and the two of k-step ks, genes 8t + 2ks and 8t + 2ks + 1.
template <int YT> struct FwdRow;
template <> struct FwdRow<kYI8> {
  static constexpr int kChunk = 8, kRow = 32;
  uint2 w;
  __device__ __forceinline__ void load(const unsigned char* p) {
    w = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void pair(int ks, double& a, double& b) const {
    const uint32_t v = ks < 2 ? w.x : w.y;
    const int sh = 16 * (ks & 1);
    a = int_to_double((int)(v << (24 - sh)) >> 24);
    b = int_to_double((int)(v << (16 - sh)) >> 24);
  }
};
template <> struct FwdRow<kYI16> {
  static constexpr int kChunk = 16, kRow = 64;
  uint4 w;
  __device__ __forceinline__ void load(const unsigned char* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void pair(int ks, double& a, double& b) const {
    const uint32_t v = ks == 0 ? w.x : ks == 1 ? w.y : ks == 2 ? w.z : w.w;
    a = int_to_double((int)(v << 16) >> 16);
    b = int_to_double((int)v >> 16);
  }
};
template <> struct FwdRow<kYBF16> {
  static constexpr int kChunk = 16, kRow = 64;
  uint4 w;
  __device__ __forceinline__ void load(const unsigned char* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void pair(int ks, double& a, double& b) const {
    const uint32_t v = ks == 0 ? w.x : ks == 1 ? w.y : ks == 2 ? w.z : w.w;
    a = (double)__uint_as_float(v << 16);
    b = (double)__uint_as_float(v & 0xffff0000u);
  }
};
template <> struct FwdRow<kYF64> {
  static constexpr int kChunk = 80, kRow = 320;  // 16 bytes of padding a lane
  const double2* p;
  __device__ __forceinline__ void load(const unsigned char* q) {
    p = reinterpret_cast<const double2*>(q);
  }
  __device__ __forceinline__ void pair(int ks, double& a, double& b) const {
    const double2 v = p[ks];
    a = v.x;
    b = v.y;
  }
};

// ---------------------------------------------------------------------------
// Forward: block (blockIdx.x) of kFwdWarps x 16 cells, column group
// blockIdx.y of `count` tiles (NT accumulator tiles, the last nt - count
// idle) of [Y W | Y log mu^T] (yt tiles) then Z. Dynamic shared memory: the
// warps' psi ([warp][k][g] pairs of rows g, g + 8), then two stages, each
// the group's B fragments ([k-step][tile][lane] pairs), W ([k-step][k][t]
// pairs of genes 8t + 2ks, + 1) and the warps' Y rows.
// ---------------------------------------------------------------------------
template <int YT, int NT>
__global__ void __launch_bounds__(kFwdWarps * kWarp, NT >= 8 ? 2 : NT >= 4 ? 3 : 4)
fwd_f64_kernel(const typename Y64<YT>::Elem* __restrict__ Y, const double* __restrict__ psi,
               const double* __restrict__ W, const double* __restrict__ logmu,
               const double* __restrict__ muL, double* __restrict__ A1, double* __restrict__ A2,
               double* __restrict__ Z, double* __restrict__ YW,
               const double2* __restrict__ table, int N, int G, int Kf, int nA2, int SC, int yt,
               int count, bool vec) {
  using Row = FwdRow<YT>;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kFwdWarps + warp) * 16;
  const int n0 = row0 + g, n1 = n0 + 8;
  const int tiles = yt + (SC + 7) / 8;
  const int tile0 = blockIdx.y * count, nt = min(count, tiles - tile0);
  const int ny = max(0, min(nt, yt - tile0));  // the group's Y-product tiles (its first)
  const bool first = blockIdx.y == 0;
  const bool with_exp = nt > ny, with_lr = with_exp || first, with_y = ny > 0 || first;
  double2* s_psi = reinterpret_cast<double2*>(s_dyn);
  unsigned char* s_stage = s_dyn + (size_t)kFwdWarps * 16 * Kf * 8;
  const int tab_bytes = kFwdSteps * NT * kWarp * 16, w_bytes = kFwdSteps * Kf * 4 * 16;
  const int stage_bytes = tab_bytes + w_bytes + kFwdYStageBytes;

  // psi of the warp's rows, in pairs (row g, row g + 8); read after the
  // first stage's barrier
  for (int i = lane; i < 16 * Kf; i += kWarp) {
    const int k = i / 16, r = i % 16, n = row0 + (r >> 1) + 8 * (r & 1);
    reinterpret_cast<double*>(s_psi)[warp * Kf * 16 + i] = n < N ? psi[(size_t)n * Kf + k] : 0.0;
  }

  // cp.async of stage s (genes [32 s, 32 s + 32)) into buffer buf: for each
  // k-step the group's tiles and W's pairs, contiguous in the packed table
  const int per_ks = tiles * kWarp + Kf * 4;
  auto stage = [&](int s, int buf) {
    unsigned char* base = s_stage + (size_t)buf * stage_bytes;
    double2* tab = reinterpret_cast<double2*>(base);
    double2* sw = reinterpret_cast<double2*>(base + tab_bytes);
    const double2* src = table + (size_t)s * kFwdSteps * per_ks;
#pragma unroll
    for (int ks = 0; ks < kFwdSteps; ++ks) {
      for (int i = threadIdx.x; i < nt * kWarp; i += blockDim.x)
        cp_async<16>(tab + ks * NT * kWarp + i, src + ks * per_ks + tile0 * kWarp + i, src);
      if (with_lr)
        for (int i = threadIdx.x; i < Kf * 4; i += blockDim.x)
          cp_async<16>(sw + ks * Kf * 4 + i, src + ks * per_ks + tiles * kWarp + i, src);
    }
    if (with_y) {
      unsigned char* sy = base + tab_bytes + w_bytes + warp * 16 * Row::kRow;
      for (int i = lane; i < 64; i += kWarp) {  // the warp's 16 rows, 4 pieces each
        const int r = i >> 2, tt = i & 3;
        stage_y8<YT>(sy + r * Row::kRow + tt * Row::kChunk, Y, row0 + r,
                     s * kFwdGenes + 8 * tt, N, G, vec);
      }
    }
    cp_async_commit();
  };

  double acc[NT][4];
#pragma unroll
  for (int c = 0; c < NT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.0;
  double a1_0 = 0.0, a1_1 = 0.0;
  const int n_stages = (G + kFwdGenes - 1) / kFwdGenes;
  stage(0, 0);
  // No early exit: every warp takes part in the block's barriers; rows past
  // N compute on zeros and write nothing.
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // the stage has landed, and the other buffer is free
    if (s + 1 < n_stages) stage(s + 1, buf ^ 1);
    const unsigned char* base = s_stage + (size_t)buf * stage_bytes;
    const double2* tab = reinterpret_cast<const double2*>(base);
    const double2* sw = reinterpret_cast<const double2*>(base + tab_bytes);
    const unsigned char* sy = base + tab_bytes + w_bytes + warp * 16 * Row::kRow + t * Row::kChunk;
    Row r0, r1;
    if (with_y) {
      r0.load(sy + g * Row::kRow);
      r1.load(sy + (g + 8) * Row::kRow);
    }
#pragma unroll
    for (int ks = 0; ks < kFwdSteps; ++ks) {
      // the lane's A elements: (n0, gene), (n1, gene), (n0, gene + 1),
      // (n1, gene + 1), gene = 8t + 2ks of the stage
      double y[4] = {0.0, 0.0, 0.0, 0.0}, lr[4] = {0.0, 0.0, 0.0, 0.0};
      if (with_y) {
        r0.pair(ks, y[0], y[2]);
        r1.pair(ks, y[1], y[3]);
      }
      if (with_lr) {
        const double2* pp = s_psi + warp * Kf * 8 + g;
        const double2* pw = sw + ks * Kf * 4 + t;
        for (int k = 0; k < Kf; ++k) {
          const double2 p = pp[k * 8], w = pw[k * 4];
          lr[0] = fma(p.x, w.x, lr[0]);
          lr[1] = fma(p.y, w.x, lr[1]);
          lr[2] = fma(p.x, w.y, lr[2]);
          lr[3] = fma(p.y, w.y, lr[3]);
        }
      }
      if (first) {
        a1_0 = fma(y[2], lr[2], fma(y[0], lr[0], a1_0));
        a1_1 = fma(y[3], lr[3], fma(y[1], lr[1], a1_1));
      }
      double rf[4] = {0.0, 0.0, 0.0, 0.0};
      if (with_exp) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rf[e] = exp(lr[e]);
      }
#pragma unroll
      for (int c = 0; c < NT; ++c) {
        const double2 b = tab[(ks * NT + c) * kWarp + lane];
        if (c < ny)
          dmma(acc[c], y, b);
        else if (c < nt)
          dmma(acc[c], rf, b);
      }
    }
  }

  if (first) {  // A1: the quad's four partial sums, in a fixed order
    a1_0 += __shfl_xor_sync(0xffffffffu, a1_0, 1);
    a1_0 += __shfl_xor_sync(0xffffffffu, a1_0, 2);
    a1_1 += __shfl_xor_sync(0xffffffffu, a1_1, 1);
    a1_1 += __shfl_xor_sync(0xffffffffu, a1_1, 2);
    if (t == 0 && n0 < N) A1[n0] = a1_0;
    if (t == 0 && n1 < N) A1[n1] = a1_1;
  }
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    if (c >= nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? n0 : n1, col = 8 * (tile0 + c) + 2 * t + (e & 1);
      if (n >= N) continue;
      if (tile0 + c < yt) {
        if (col < Kf)
          YW[(size_t)n * Kf + col] = acc[c][e];
        else if (col < Kf + nA2)
          A2[(size_t)n * nA2 + (col - Kf)] = acc[c][e];
      } else if (col - 8 * yt < SC) {
        Z[(size_t)n * SC + (col - 8 * yt)] = acc[c][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Gene part: block (blockIdx.x) of kGeneWarps x 16 genes, chunk blockIdx.y of
// `rows` cells; tiles [dlog mu (st) | d(muL)] in `passes` passes of `count`
// (NT accumulator tiles), dW's NK tiles beside them. Dynamic shared memory:
// the warps' W ([warp][k][g] pairs of genes g, g + 8), then two stages, each
// for 32 cells (4 n-tiles) drfe's B fragments ([n-tile][tile][lane] pairs
// of dZ^T), the pass's ([n-tile][tile][lane] pairs of dA2 or dZ at cells 2t,
// 2t + 1), dW's ([n-tile][kt][lane] pairs of psi), psi for log_rfe
// ([n-tile][k][t] pairs of cells 2t, 2t + 1), dA1, and the block's Y rows.
// ---------------------------------------------------------------------------
template <int YT, int NT, int NK>
__global__ void __launch_bounds__(kGeneWarps * kWarp, 2 * NT + NK >= 6 ? 2 : 3)
gene_f64_kernel(const typename Y64<YT>::Elem* __restrict__ Y, const double* __restrict__ psi,
                const double* __restrict__ W, const double* __restrict__ muL,
                const double* __restrict__ dA1, const double* __restrict__ dA2,
                const double* __restrict__ dZ, const double2* __restrict__ table,
                double* __restrict__ part, int N, int G, int Kf, int nA2, int SC, int rows, int st,
                int count, int passes, bool vec) {
  using Elem = typename Y64<YT>::Elem;
  constexpr int kYRow = 64 * (int)sizeof(Elem) + 16;  // bytes a cell's Y row takes
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int gb = blockIdx.x * kGeneWarps * 16, gw = warp * 16;
  const int gene0 = gb + gw + g, gene1 = gene0 + 8;
  const int chunk = blockIdx.y, n_begin = chunk * rows, n_end = min(N, n_begin + rows);
  const int F = Kf + SC + nA2, tiles = st + (SC + 7) / 8;
  double* out = part + (size_t)chunk * F * G;
  const int per_ct = (2 * tiles + NK) * kWarp + Kf * 4, per_stage = kGeneTiles * per_ct + kGeneCells / 2;
  double2* s_w = reinterpret_cast<double2*>(s_dyn);
  unsigned char* s_stage = s_dyn + (size_t)kGeneWarps * 16 * Kf * 8;
  const int bt_bytes = kGeneTiles * NT * kWarp * 16, bk_bytes = kGeneTiles * NK * kWarp * 16;
  const int pl_bytes = kGeneTiles * Kf * 4 * 16, a1_bytes = kGeneCells * 8;
  const int stage_bytes = 2 * bt_bytes + bk_bytes + pl_bytes + a1_bytes + kGeneYStageBytes;

  for (int i = lane; i < 16 * Kf; i += kWarp) {  // W of the warp's genes, pairs (g, g + 8)
    const int k = i / 16, r = i % 16, gene = gb + gw + (r >> 1) + 8 * (r & 1);
    reinterpret_cast<double*>(s_w)[warp * Kf * 16 + i] =
        gene < G ? W[(size_t)gene * Kf + k] : 0.0;
  }

#pragma unroll 1
  for (int q = 0; q < passes; ++q) {
    const int tile0 = q * count, nt = min(count, tiles - tile0);
    const int ns = max(0, min(nt, st - tile0));  // the pass's dlog mu tiles (its first)
    const bool with_exp = nt > ns, with_y = ns > 0 || q == 0, with_dw = with_exp || q == 0;

    // muL's A fragments for drfe over the pass's d(muL) tiles: (gene0, j),
    // (gene1, j), (gene0, j + 4), (gene1, j + 4), j = 8 tile + t
    double amu[NT][4];
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      const int j = 8 * (tile0 + c - st) + t;
      const bool in = c >= ns && c < nt;
      amu[c][0] = in && gene0 < G && j < SC ? muL[(size_t)gene0 * SC + j] : 0.0;
      amu[c][1] = in && gene1 < G && j < SC ? muL[(size_t)gene1 * SC + j] : 0.0;
      amu[c][2] = in && gene0 < G && j + 4 < SC ? muL[(size_t)gene0 * SC + j + 4] : 0.0;
      amu[c][3] = in && gene1 < G && j + 4 < SC ? muL[(size_t)gene1 * SC + j + 4] : 0.0;
    }

    // cp.async of stage s (cells [n_begin + 32 s, + 32)) into buffer buf: for
    // each n-tile the pass's tiles, dW's and psi's pairs, contiguous in the
    // packed table, then dA1
    auto stage = [&](int s, int buf) {
      unsigned char* base = s_stage + (size_t)buf * stage_bytes;
      double2* bt = reinterpret_cast<double2*>(base);
      double2* bn = reinterpret_cast<double2*>(base + bt_bytes);
      double2* bk = reinterpret_cast<double2*>(base + 2 * bt_bytes);
      double2* pl = reinterpret_cast<double2*>(base + 2 * bt_bytes + bk_bytes);
      double2* a1 = reinterpret_cast<double2*>(base + 2 * bt_bytes + bk_bytes + pl_bytes);
      unsigned char* sy = base + 2 * bt_bytes + bk_bytes + pl_bytes + a1_bytes;
      const int c0 = n_begin + s * kGeneCells;
      const double2* src = table + (size_t)(c0 / kGeneCells) * per_stage;
#pragma unroll
      for (int ct = 0; ct < kGeneTiles; ++ct) {
        const double2* sc = src + ct * per_ct;
        if (with_exp)  // drfe's B for the pass's d(muL) tiles
          for (int i = threadIdx.x; i < (nt - ns) * kWarp; i += blockDim.x)
            cp_async<16>(bt + (ct * NT + ns) * kWarp + i, sc + (tile0 + ns) * kWarp + i, src);
        for (int i = threadIdx.x; i < nt * kWarp; i += blockDim.x)
          cp_async<16>(bn + ct * NT * kWarp + i, sc + (tiles + tile0) * kWarp + i, src);
        if (with_dw)
          for (int i = threadIdx.x; i < NK * kWarp; i += blockDim.x)
            cp_async<16>(bk + ct * NK * kWarp + i, sc + 2 * tiles * kWarp + i, src);
        if (with_exp)
          for (int i = threadIdx.x; i < Kf * 4; i += blockDim.x)
            cp_async<16>(pl + ct * Kf * 4 + i, sc + (2 * tiles + NK) * kWarp + i, src);
      }
      if (q == 0)
        for (int i = threadIdx.x; i < kGeneCells / 2; i += blockDim.x)
          cp_async<16>(a1 + i, src + kGeneTiles * per_ct + i, src);
      if (with_y) {
        for (int i = threadIdx.x; i < kGeneCells * 8; i += blockDim.x) {  // 8 pieces a cell
          const int cl = i >> 3, p = i & 7, n = c0 + cl;
          stage_y8<YT>(sy + cl * kYRow + 8 * p * (int)sizeof(Elem), Y, n < n_end ? n : N,
                       gb + 8 * p, N, G, vec);
        }
      }
      cp_async_commit();
    };

    double acc[NT][4], dw[NK][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < NT; ++c) acc[c][e] = 0.0;
#pragma unroll
      for (int c = 0; c < NK; ++c) dw[c][e] = 0.0;
    }
    const int n_stages = (n_end - n_begin + kGeneCells - 1) / kGeneCells;
    __syncthreads();  // the previous pass has read its last stage
    stage(0, 0);
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s) {
      const int buf = s & 1;
      cp_async_wait_all();
      __syncthreads();  // the stage has landed, and the other buffer is free
      if (s + 1 < n_stages) stage(s + 1, buf ^ 1);
      const unsigned char* base = s_stage + (size_t)buf * stage_bytes;
      const double2* bt = reinterpret_cast<const double2*>(base);
      const double2* bn = reinterpret_cast<const double2*>(base + bt_bytes);
      const double2* bk = reinterpret_cast<const double2*>(base + 2 * bt_bytes);
      const double2* pl = reinterpret_cast<const double2*>(base + 2 * bt_bytes + bk_bytes);
      const double2* a1 =
          reinterpret_cast<const double2*>(base + 2 * bt_bytes + bk_bytes + pl_bytes);
      const unsigned char* sy = base + 2 * bt_bytes + bk_bytes + pl_bytes + a1_bytes;
#pragma unroll 2
      for (int ct = 0; ct < kGeneTiles; ++ct) {
        // C positions: (gene0, cell 2t), (gene0, 2t + 1), (gene1, 2t),
        // (gene1, 2t + 1) of n-tile ct. drfe = muL dZ^T over the pass.
        double dr[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int c = 0; c < NT; ++c)
          if (c >= ns && c < nt) dmma(dr, amu[c], bt[(ct * NT + c) * kWarp + lane]);
        double rf[4] = {0.0, 0.0, 0.0, 0.0}, y[4] = {0.0, 0.0, 0.0, 0.0};
        if (with_exp) {
          double lr[4] = {0.0, 0.0, 0.0, 0.0};
          const double2* pw = s_w + warp * Kf * 8 + g;
          const double2* pp = pl + ct * Kf * 4 + t;
          for (int k = 0; k < Kf; ++k) {
            const double2 w = pw[k * 8], p = pp[k * 4];
            lr[0] = fma(w.x, p.x, lr[0]);
            lr[1] = fma(w.x, p.y, lr[1]);
            lr[2] = fma(w.y, p.x, lr[2]);
            lr[3] = fma(w.y, p.y, lr[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) rf[e] = exp(lr[e]);
        }
        if (with_y) {
          const Elem* y0 = reinterpret_cast<const Elem*>(sy + (8 * ct + 2 * t) * kYRow) + gw + g;
          const Elem* y1 = reinterpret_cast<const Elem*>(reinterpret_cast<const unsigned char*>(y0) + kYRow);
          y[0] = y_to_double<YT>(y0[0]);
          y[1] = y_to_double<YT>(y1[0]);
          y[2] = y_to_double<YT>(y0[8]);
          y[3] = y_to_double<YT>(y1[8]);
        }
        double d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) d[e] = rf[e] * dr[e];  // rfe drfe_pass
        if (q == 0) {  // + Y dA1
          const double2 a = a1[4 * ct + t];
          d[0] = fma(y[0], a.x, d[0]);
          d[1] = fma(y[1], a.y, d[1]);
          d[2] = fma(y[2], a.x, d[2]);
          d[3] = fma(y[3], a.y, d[3]);
        }
        // C fragments as A fragments: C's columns 2t, 2t + 1 as A's k-columns
        // t, t + 4 (the B fragments' rows hold cells 2t, 2t + 1)
        const double ra[4] = {rf[0], rf[2], rf[1], rf[3]};
        const double ya[4] = {y[0], y[2], y[1], y[3]};
        const double da[4] = {d[0], d[2], d[1], d[3]};
#pragma unroll
        for (int c = 0; c < NT; ++c) {
          const double2 b = bn[(ct * NT + c) * kWarp + lane];
          if (c < ns)
            dmma(acc[c], ya, b);
          else if (c < nt)
            dmma(acc[c], ra, b);
        }
        if (with_dw) {
#pragma unroll
          for (int kt = 0; kt < NK; ++kt) dmma(dw[kt], da, bk[(ct * NK + kt) * kWarp + lane]);
        }
      }
    }

    // the pass's tiles: C (gene0 / gene1, columns 2t, 2t + 1)
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gene = e < 2 ? gene0 : gene1, col = 8 * (tile0 + c) + 2 * t + (e & 1);
        if (gene >= G) continue;
        if (c < ns) {
          if (col < nA2) out[(size_t)(Kf + SC + col) * G + gene] = acc[c][e];
        } else if (col - 8 * st < SC) {
          out[(size_t)(Kf + col - 8 * st) * G + gene] = acc[c][e];
        }
      }
    }
    if (with_dw) {  // dW: the first pass stores, later ones add
#pragma unroll
      for (int kt = 0; kt < NK; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gene = e < 2 ? gene0 : gene1, k = 8 * kt + 2 * t + (e & 1);
          if (gene >= G || k >= Kf) continue;
          double* o = out + (size_t)k * G + gene;
          *o = q == 0 ? dw[kt][e] : *o + dw[kt][e];
        }
    }
  }
}
#endif  // F64_ANY_TYPED

#if F64_COMMON
// The forward's gene side, once a call, in the order its stages take it:
// for each stage of 32 genes and each of its 4 k-steps, the B fragment
// pairs of every tile ([tile][lane]: genes 8t + 2ks and 8t + 2ks + 1 at
// column 8 tile + g of [W | log mu^T] (yt tiles), then of muL), then W's
// pairs for log_rfe ([k][t], the same genes). Zero past G and every width.
__global__ void fwd_f64_pack_kernel(const double* __restrict__ W, const double* __restrict__ logmu,
                                    const double* __restrict__ muL, double2* __restrict__ table,
                                    int G, int Kf, int nA2, int SC, int yt, int tiles,
                                    long long n) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int per_ks = tiles * kWarp + Kf * 4, r = (int)(e % per_ks);
  const int ks = (int)(e / per_ks % kFwdSteps), g0 = (int)(e / per_ks / kFwdSteps) * kFwdGenes;
  double v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    v[h] = 0.0;
    if (r < tiles * kWarp) {
      const int l = r % kWarp, col = 8 * (r / kWarp) + (l >> 2);
      const int gene = g0 + 8 * (l & 3) + 2 * ks + h;
      if (gene >= G) continue;
      if (col < 8 * yt) {
        if (col < Kf)
          v[h] = W[(size_t)gene * Kf + col];
        else if (col < Kf + nA2)
          v[h] = logmu[(size_t)(col - Kf) * G + gene];
      } else if (col - 8 * yt < SC) {
        v[h] = muL[(size_t)gene * SC + (col - 8 * yt)];
      }
    } else {
      const int k = (r - tiles * kWarp) / 4, gene = g0 + 8 * ((r - tiles * kWarp) % 4) + 2 * ks + h;
      if (gene < G) v[h] = W[(size_t)gene * Kf + k];
    }
  }
  table[e] = make_double2(v[0], v[1]);
}

// The gene part's cell side, once a call, in the order its stages take it:
// for each stage of 32 cells and each of its 4 n-tiles of 8, drfe's B pairs
// of every tile ([tile][lane]: dZ^T at j = 8 jt + t, + 4 and cell 8ct + g,
// jt the d(muL) tile, zero for dlog mu's), the tiles' own ([tile][lane]:
// cells 8ct + 2t, + 1 at column 8 tile + g of [dA2 (st tiles) | dZ]), dW's
// ([kt][lane]: psi at those cells, column 8 kt + g) and psi's for log_rfe
// ([k][t]); then dA1 of the 32 cells. Zero past N and every width.
__global__ void gene_f64_pack_kernel(const double* __restrict__ psi, const double* __restrict__ dA1,
                                     const double* __restrict__ dA2, const double* __restrict__ dZ,
                                     double2* __restrict__ table, int N, int Kf, int nA2, int SC,
                                     int st, int tiles, int nk, long long n) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int per_ct = (2 * tiles + nk) * kWarp + Kf * 4;
  const int per_stage = kGeneTiles * per_ct + kGeneCells / 2;
  const int r = (int)(e % per_stage), c0 = (int)(e / per_stage) * kGeneCells;
  double v[2];
  if (r >= kGeneTiles * per_ct) {  // dA1
    const int n0 = c0 + 2 * (r - kGeneTiles * per_ct);
    v[0] = n0 < N ? dA1[n0] : 0.0;
    v[1] = n0 + 1 < N ? dA1[n0 + 1] : 0.0;
  } else {
    const int ct = r / per_ct, x = r % per_ct;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] = 0.0;
      if (x < tiles * kWarp) {  // drfe's B
        const int l = x % kWarp, tile = x / kWarp, n = c0 + 8 * ct + (l >> 2);
        const int j = 8 * (tile - st) + (l & 3) + 4 * h;
        if (tile >= st && n < N && j < SC) v[h] = dZ[(size_t)n * SC + j];
      } else if (x < 2 * tiles * kWarp) {  // the tiles' own B
        const int l = x % kWarp, col = 8 * (x / kWarp - tiles) + (l >> 2);
        const int n = c0 + 8 * ct + 2 * (l & 3) + h;
        if (n >= N) continue;
        if (col < 8 * st) {
          if (col < nA2) v[h] = dA2[(size_t)n * nA2 + col];
        } else if (col - 8 * st < SC) {
          v[h] = dZ[(size_t)n * SC + (col - 8 * st)];
        }
      } else if (x < (2 * tiles + nk) * kWarp) {  // dW's B
        const int y = x - 2 * tiles * kWarp, l = y % kWarp, k = 8 * (y / kWarp) + (l >> 2);
        const int n = c0 + 8 * ct + 2 * (l & 3) + h;
        if (n < N && k < Kf) v[h] = psi[(size_t)n * Kf + k];
      } else {  // psi for log_rfe
        const int y = x - (2 * tiles + nk) * kWarp, k = y / 4, n = c0 + 8 * ct + 2 * (y % 4) + h;
        if (n < N) v[h] = psi[(size_t)n * Kf + k];
      }
    }
  }
  table[e] = make_double2(v[0], v[1]);
}

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

// Each kernel's dynamic shared memory, in bytes (the layouts above;
// ops/fused_likelihood.py's f64_fwd_smem, f64_gene_smem).
inline long long fwd_smem(int Kf, int nt) {
  return 8LL * (kFwdWarps * 16 * Kf + 2LL * kFwdGenes * (8 * nt + Kf)) + 2LL * kFwdYStageBytes;
}
inline long long dpsi_smem(int Kf, int cols) {
  return 8LL * ((2LL * Kf + cols) * kCells + (long long)(Kf + cols) * kGenes);
}
inline long long gene_smem(int Kf, int nt, int nk) {
  return 8LL * (kGeneWarps * 16 * Kf + 2LL * (kGeneCells * (16LL * nt + 8 * nk + Kf) + kGeneCells)) +
         2LL * kGeneYStageBytes;
}

// Columns split evenly into groups of at most cap: `groups` of `cols`,
// every group holding at least one column.
inline bool even_split(long long n, int cap, int groups, int cols) {
  return cols >= 1 && cols <= cap && groups == cdiv(n, cap) && cols == cdiv(n, groups);
}

// The packed tables, in doubles: the forward's gene side (fwd_f64_pack_kernel)
// and the gene part's cell side (gene_f64_pack_kernel).
inline long long fwd_table(int G, int Kf, int tiles) {
  return 2LL * cdiv(G, kFwdGenes) * kFwdSteps * (tiles * kWarp + Kf * 4);
}
inline long long gene_table(int N, int Kf, int tiles, int nk) {
  return 2LL * cdiv(N, kGeneCells) *
         (kGeneTiles * ((2LL * tiles + nk) * kWarp + Kf * 4) + kGeneCells / 2);
}

// The least of the built counts c[0..n) that is >= v (else the largest).
inline long long least_count(const int* c, int n, long long v) {
  for (int i = 0; i < n; ++i)
    if (c[i] >= v) return c[i];
  return c[n - 1];
}
// The gene part's built tile counts beside nk of dW's tiles (none: 0).
inline int gene_tile_counts(int nk, const int** c) {
  switch (nk) {
    case 1: *c = kGeneTileCounts1; return 5;
    case 2: *c = kGeneTileCounts2; return 3;
    case 8: *c = kGeneTileCounts8; return 2;
    default: return 0;
  }
}

bool bad_sizes(int N, int G, int Kf, int nA2, int SC, int y_type) {
  return N < 1 || G < 1 || Kf < 0 || Kf > kMaxKf || nA2 < 0 || nA2 > kMaxA2 || SC < 1 ||
         SC > kMaxSC || y_type < kYF64 || y_type > kYI8;
}

// The plan ops/fused_likelihood.py's f64_plan made (its F64_PLAN_KEYS, in
// order), or false where a number does not fit these sizes: the forward's
// and the gene part's tiles of each width, split evenly into groups or
// passes each the least built count that holds them (the gene part's
// beside dW's built count), grid.y within 65535, dpsi's columns split even
// and within their cap, the blocks covering the cells and genes, the chunks
// whole stages covering the cells, each shared memory size the kernel's
// layout and within the card's, and the room of the partial sums and of
// the packed tables.
bool plan_of(const long long* v, int N, int G, int Kf, int nA2, int SC, Plan& p) {
  constexpr int kKeys = 24;  // the last three are sizes
  for (int i = 0; i < kKeys; ++i)
    if (v[i] < 0 || (i < kKeys - 3 && v[i] > 0x7fffffff)) return false;
  p.f_yt = (int)v[0], p.f_tiles = (int)v[1], p.f_count = (int)v[2], p.f_nt = (int)v[3];
  p.f_groups = (int)v[4], p.f_blocks = (int)v[5], p.f_smem = (int)v[6];
  p.d_cols = (int)v[7], p.d_groups = (int)v[8], p.d_blocks = (int)v[9], p.d_smem = (int)v[10];
  p.g_st = (int)v[11], p.g_tiles = (int)v[12], p.g_nk = (int)v[13], p.g_count = (int)v[14];
  p.g_nt = (int)v[15], p.g_passes = (int)v[16], p.g_blocks = (int)v[17], p.rows = (int)v[18];
  p.n_chunks = (int)v[19], p.g_smem = (int)v[20];
  p.part = (size_t)v[21], p.f_table = (size_t)v[22], p.g_table = (size_t)v[23];
  const long long F = (long long)Kf + SC + nA2, zt = cdiv(SC, 8);
  constexpr int kFwdCounts = sizeof(kFwdTileCounts) / sizeof(int);
  const int* gc = nullptr;
  const int n_gc = gene_tile_counts(p.g_nk, &gc);
  return p.f_yt == cdiv(Kf + nA2, 8) && p.f_tiles == p.f_yt + zt &&
         p.f_groups == cdiv(p.f_tiles, kFwdTileCounts[kFwdCounts - 1]) && p.f_groups <= 65535 &&
         p.f_count == cdiv(p.f_tiles, p.f_groups) &&
         p.f_nt == least_count(kFwdTileCounts, kFwdCounts, p.f_count) && p.f_nt >= p.f_count &&
         p.f_blocks == cdiv(N, 16 * kFwdWarps) && p.f_smem == fwd_smem(Kf, p.f_nt) &&
         p.f_smem <= kMaxSmem && even_split(SC, kDpsiCols, p.d_groups, p.d_cols) &&
         p.d_blocks == cdiv(N, kCells) && p.d_smem == dpsi_smem(Kf, p.d_cols) &&
         p.d_smem <= kMaxSmem && p.g_st == cdiv(nA2, 8) && p.g_tiles == p.g_st + zt &&
         p.g_nk == least_count(kGeneKCounts, 3, Kf > 8 ? cdiv(Kf, 8) : 1) && n_gc > 0 &&
         p.g_passes == cdiv(p.g_tiles, gc[n_gc - 1]) && p.g_count == cdiv(p.g_tiles, p.g_passes) &&
         p.g_nt == least_count(gc, n_gc, p.g_count) && p.g_nt >= p.g_count &&
         p.g_blocks == cdiv(G, 16 * kGeneWarps) && p.rows >= kGeneCells &&
         p.rows % kGeneCells == 0 && p.n_chunks == cdiv(N, p.rows) && p.n_chunks <= 65535 &&
         p.g_smem == gene_smem(Kf, p.g_nt, p.g_nk) && p.g_smem <= kMaxSmem &&
         p.part >= (size_t)p.n_chunks * F * G && p.part % 2 == 0 &&
         p.f_table >= (size_t)fwd_table(G, Kf, p.f_tiles) &&
         p.g_table >= (size_t)gene_table(N, Kf, p.g_tiles, p.g_nk);
}

}  // namespace

namespace fl64 {

#if F64_ANY_TYPED
template <int YT>
using FwdKernel = void (*)(const typename Y64<YT>::Elem*, const double*, const double*,
                           const double*, const double*, double*, double*, double*, double*,
                           const double2*, int, int, int, int, int, int, int, bool);
template <int YT>
using GeneKernel = void (*)(const typename Y64<YT>::Elem*, const double*, const double*,
                            const double*, const double*, const double*, const double*,
                            const double2*, double*, int, int, int, int, int, int, int, int, int,
                            bool);

// The instantiation a plan names (plan_of has checked its counts).
template <int YT>
FwdKernel<YT> fwd_kernel_of(const Plan& p) {
  switch (p.f_nt) {
    case 1: return fwd_f64_kernel<YT, 1>;
    case 2: return fwd_f64_kernel<YT, 2>;
    case 3: return fwd_f64_kernel<YT, 3>;
    case 4: return fwd_f64_kernel<YT, 4>;
    case 6: return fwd_f64_kernel<YT, 6>;
    case 8: return fwd_f64_kernel<YT, 8>;
    default: return fwd_f64_kernel<YT, 12>;
  }
}
template <int YT>
GeneKernel<YT> gene_kernel_of(const Plan& p) {
  if (p.g_nk == 1) {
    switch (p.g_nt) {
      case 1: return gene_f64_kernel<YT, 1, 1>;
      case 2: return gene_f64_kernel<YT, 2, 1>;
      case 3: return gene_f64_kernel<YT, 3, 1>;
      case 4: return gene_f64_kernel<YT, 4, 1>;
      default: return gene_f64_kernel<YT, 5, 1>;
    }
  }
  if (p.g_nk == 2) {
    switch (p.g_nt) {
      case 1: return gene_f64_kernel<YT, 1, 2>;
      case 2: return gene_f64_kernel<YT, 2, 2>;
      default: return gene_f64_kernel<YT, 4, 2>;
    }
  }
  return p.g_nt == 1 ? gene_f64_kernel<YT, 1, 8> : gene_f64_kernel<YT, 2, 8>;
}

template <int YT>
void forward_typed(const FwdArgs& a) {
  using Elem = typename Y64<YT>::Elem;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const bool vec = a.G % 8 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  const FwdKernel<YT> kernel = fwd_kernel_of<YT>(a.plan);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.plan.f_smem);
  kernel<<<dim3(a.plan.f_blocks, a.plan.f_groups), kFwdWarps * kWarp, a.plan.f_smem, a.stream>>>(
      Y, a.psi, a.W, a.logmu, a.muL, a.A1, a.A2, a.Z, a.YW, a.table, a.N, a.G, a.Kf, a.nA2, a.SC,
      a.plan.f_yt, a.plan.f_count, vec);
}

template <int YT>
void gene_typed(const GeneArgs& a) {
  using Elem = typename Y64<YT>::Elem;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const bool vec = a.G % 8 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  const GeneKernel<YT> kernel = gene_kernel_of<YT>(a.plan);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.plan.g_smem);
  kernel<<<dim3(a.plan.g_blocks, a.plan.n_chunks), kGeneWarps * kWarp, a.plan.g_smem,
           a.stream>>>(Y, a.psi, a.W, a.muL, a.dA1, a.dA2, a.dZ, a.table, a.part, a.N, a.G,
                       a.Kf, a.nA2, a.SC, a.plan.rows, a.plan.g_st, a.plan.g_count,
                       a.plan.g_passes, vec);
}

template <int YT>
int blocks_per_sm(int which, const Plan& p) {
  int blocks = 0;
  if (which == 0) {
    const FwdKernel<YT> kernel = fwd_kernel_of<YT>(p);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.f_smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kFwdWarps * kWarp, p.f_smem);
  } else {
    const GeneKernel<YT> kernel = gene_kernel_of<YT>(p);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.g_smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kGeneWarps * kWarp, p.g_smem);
  }
  return blocks;
}
#endif  // F64_ANY_TYPED

#if F64_TYPED(0)
template void forward_typed<kYF64>(const FwdArgs&);
template void gene_typed<kYF64>(const GeneArgs&);
template int blocks_per_sm<kYF64>(int, const Plan&);
#endif
#if F64_TYPED(1)
template void forward_typed<kYBF16>(const FwdArgs&);
template void gene_typed<kYBF16>(const GeneArgs&);
template int blocks_per_sm<kYBF16>(int, const Plan&);
#endif
#if F64_TYPED(2)
template void forward_typed<kYI16>(const FwdArgs&);
template void gene_typed<kYI16>(const GeneArgs&);
template int blocks_per_sm<kYI16>(int, const Plan&);
#endif
#if F64_TYPED(3)
template void forward_typed<kYI8>(const FwdArgs&);
template void gene_typed<kYI8>(const GeneArgs&);
template int blocks_per_sm<kYI8>(int, const Plan&);
#endif

}  // namespace fl64

#if F64_COMMON
extern "C" {

// Y (N,G) is a device pointer to a contiguous array of the storage type
// y_type (0 float64, 1 bfloat16, 2 int16, 3 int8); every other pointer is a
// device pointer to a contiguous float64 array: psi (N,Kf), W (G,Kf), logmu
// (nA2,G), muL (G,SC); outputs A1 (N), A2 (N,nA2), Z (N,SC) and YW (N,Kf) =
// Y W. nA2 == 0 skips A2 (logmu and A2 are then not read or written). table
// holds the plan's f_table doubles, the packed gene side
// (fwd_f64_pack_kernel, launched first). plan is f64_plan's for these sizes
// (F64_PLAN_KEYS, in order). Returns cudaErrorInvalidValue where the sizes
// or the plan do not fit, else cudaGetLastError() after launch.
int fl64_forward(const void* Y, const double* psi, const double* W, const double* logmu,
                 const double* muL, double* A1, double* A2, double* Z, double* YW, double* table,
                 const long long* plan, int N, int G, int Kf, int nA2, int SC, int y_type,
                 cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  const long long n = fwd_table(G, Kf, p.f_tiles) / 2;
  fwd_f64_pack_kernel<<<(int)cdiv(n, 256), 256, 0, stream>>>(
      W, logmu, muL, reinterpret_cast<double2*>(table), G, Kf, nA2, SC, p.f_yt, p.f_tiles, n);
  const FwdArgs a{Y,  psi, W, logmu, muL, A1, A2, Z, YW, reinterpret_cast<const double2*>(table),
                  N,  G,   Kf, nA2, SC, p,  stream};
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
// sums of each chunk (an even count), then its g_table doubles, the packed cell side
// (gene_f64_pack_kernel, launched first). Kf == 0 runs with rfe = 1.
int fl64_backward_gene(const void* Y, const double* psi, const double* W, const double* muL,
                       const double* dA1, const double* dA2, const double* dZ, double* scratch,
                       double* dgene, const long long* plan, int N, int G, int Kf, int nA2,
                       int SC, int y_type, cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  double* table = scratch + p.part;
  const long long n = gene_table(N, Kf, p.g_tiles, p.g_nk) / 2;
  gene_f64_pack_kernel<<<(int)cdiv(n, 256), 256, 0, stream>>>(
      psi, dA1, dA2, dZ, reinterpret_cast<double2*>(table), N, Kf, nA2, SC, p.g_st, p.g_tiles,
      p.g_nk, n);
  const GeneArgs a{Y,  psi, W,  muL, dA1, dA2, dZ, scratch, reinterpret_cast<const double2*>(table),
                   N,  G,   Kf, nA2, SC,  p,   stream};
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
      case kYF64: blocks = blocks_per_sm<kYF64>(which, p); break;
      case kYBF16: blocks = blocks_per_sm<kYBF16>(which, p); break;
      case kYI16: blocks = blocks_per_sm<kYI16>(which, p); break;
      default: blocks = blocks_per_sm<kYI8>(which, p);
    }
    out[4 * which] = smem;
    out[4 * which + 1] = blocks;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // F64_COMMON

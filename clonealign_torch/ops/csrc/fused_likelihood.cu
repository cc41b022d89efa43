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
//    (the slowest of its units at their peaks).
//  * gene-major kernel (dW, d(muL), dlog mu), the backward's only read of Y
//    (0.60 ms at full width). drfe = dZ muL^T is never formed: with
//    B = [dZ | dZ psi_1 | ... | dZ psi_Kf] (N x (1 + Kf) SC),
//      d(muL) = rfe^T dZ,   dlog_mu = dA2^T Y,
//      dW[g,k] = (Y^T (dA1 psi_k))[g] + sum_j muL[g,j] (rfe^T B)[g, (k+1) SC + j],
//    exactly. rfe^T B runs on tensor cores with genes as M: each warp owns
//    16 genes and walks a chunk of 1,024 cells in k-steps of 8, forming its
//    A fragments exp(psi.W_g) in registers (W of its genes held for the
//    whole kernel). B is the same for every gene block, so a small kernel
//    packs it once per call in B-fragment order, split into TF32 hi and lo,
//    with a table of the per-cell factors (psi, dA1 psi, dA2); the blocks
//    copy it per 64-cell tile with cp.async into a ring of two tiles in
//    shared memory, one barrier a tile. Y goes through the same ring: for
//    each cell of a tile one warp copies the block's 128-gene piece of the
//    row as 16-byte cp.async (each thread later reads only what it copied)
//    and spends Kf (+ nA2) FMAs per element on it; the 8 warps' sums are
//    added in shared memory in a fixed order. On the main path B has 20
//    columns, 3 n-tiles; a pass holds at most 4 (fewer at larger Kf, where
//    128 registers would spill), and wider B takes several passes over the
//    chunk, recomputing rfe. Each pass's d(muL) columns are stored and its
//    dW columns folded with muL. Each (chunk, gene block) writes its own
//    partial sums and a third kernel adds the chunks in a fixed order: no
//    atomics, so every result is deterministic.
//    Accuracy: the fold cancels (dW is a small sum of large muL E terms), so
//    3xTF32 with fresh accumulators per k-step was not enough with a float32
//    running sum; pairs of k-steps are added into float hi + lo pairs
//    instead (float64 cost a conversion per term). What bounds it: the
//    conversions and exps share a pipe that issues 16 a clock per SM, so
//    the A operand is split with integer adds and masks (the same values as
//    cvt.rna), leaving one exp per element there. Measured at full width
//    (S*C = 10, Kf = 1) on an H100 80GB HBM3 (700 W) by chip_smoke.py:
//    0.91 ms with the packing and the reduction, against 0.60 ms for one
//    read of Y.
//
// Y storage. Y reaches both Y-reading kernels (fwd_kernel, gene_kernel) in
// its storage type: float32, bfloat16, int16 or int8 (YT, the codes of
// ops/fused_likelihood.py's Y_DTYPES), so one read of Y moves 4, 2 or 1
// bytes an element (2 GB, 1 GB or 0.5 GB at full width: 0.60, 0.30 or
// 0.15 ms). A lane loads four consecutive counts as one piece (16, 8 or 4
// bytes) and converts them in registers where it uses them, exactly: a
// bfloat16 is the top half of a float, and an integer is permuted into the
// significand of 1.5 * 2^23 and taken off it with one subtraction, on the
// integer and FMA pipes rather than the conversion pipe the exps use
// (piece_to_float4). The warp geometry is the float32 one; rows whose
// pieces are not aligned (G % 4 != 0) take a scalar path. Measured at full
// width on an H100 80GB HBM3 (700 W): the forward 0.887, 0.769 and 0.716 ms
// for float32, int16 and int8 Y (chip_smoke.py), the gene part 0.90-0.92
// and 0.87-0.88 ms for float32 and int8 (gene_variants.py). A warp's load
// covers 128, 64 or 32 bytes of a row, so the narrow stream moves fewer
// bytes in as many loads, and Y's bytes no longer set either kernel's time.
//
// TMA and a lane axis for batched restarts are not used here.
//
// The wide family (replaces the jnp.dot branches of _fwd_kernel and
// _bwd_kernel, clonealign_tpu/ops/fused_likelihood.py:91, :102, :105, :182,
// :187, :201-202, :211, :213): the kernels above are built for Kf <= 4,
// nA2 <= 4 and SC <= 32; fwd_wide_kernel, dpsi_wide_kernel and
// gene_wide_kernel take any Kf <= 64, nA2 <= 64 and SC <= 2048 with the
// same contract, and the wrapper launches them only past a narrow limit.
// They are plain tiled products on the CUDA cores in float32 FMAs (no TF32,
// so no splitting): a block stages a tile of each operand in shared memory
// and each thread keeps 8 outputs of one row in registers. What bounds them
// is that arithmetic, 2 N G SC FMAs a product with muL at the FMA rate, and
// the shared-memory loads beside it (3 loads for 8 FMAs), not Y's bytes.
//
//  * fwd_wide_kernel: grid (cell tiles, column groups of JW = 16 or 32).
//    A Z group forms exp(psi . W_g) for its tile (Kf FMAs an element,
//    psi^T and W^T of the tile in shared memory) and multiplies it with
//    muL's JW columns; so the exps are recomputed once a Z group. A Y group
//    multiplies Y (converted as it is staged) with JW columns of
//    [W | log mu^T] (Y W and A2), and the first one also sums A1 =
//    sum_g Y log_rfe. Y is read once a Y group: once, for Kf + nA2 <= 32.
//  * dpsi_wide_kernel (Y-free): per 64-cell block, for each pass of 32
//    columns of dZ (kept in shared memory for the pass), drfe = dZ muL^T over
//    32-gene tiles, then rfe drfe, then its product with W^T for the Kf
//    columns of dpsi; drfe is linear in dZ's columns, so the passes add, each
//    recomputing rfe. dA1 YW is added at the end.
//  * gene_wide_kernel: per (64-gene block, chunk of cells), the same passes
//    over dZ's columns with 32-cell tiles: drfe and rfe of the tile, then
//    d(muL) of the pass's columns (rfe^T dZ), dW (dlog_rfe^T psi, dlog_rfe =
//    rfe drfe plus Y dA1 in the first pass) and in the first pass dlog mu
//    (dA2^T Y). Each (chunk, block) writes its own partial sums, which
//    reduce_chunks_kernel adds in a fixed order: deterministic, no atomics.
//
// Build: one translation unit holds everything, or ops/_build.py compiles
// this file as five in parallel and links them: FL_PART = -1 holds the
// Y-free kernels and the C entry points, FL_PART = YT the Y-reading kernels
// of one storage type (fl::forward_typed<YT>, fl::gene_typed<YT>).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#ifndef FL_PART
#define FL_COMMON 1
#define FL_TYPED(code) 1
#elif FL_PART < 0
#define FL_COMMON 1
#define FL_TYPED(code) 0
#else
#define FL_COMMON 0
#define FL_TYPED(code) ((code) == FL_PART)
#endif
#define FL_ANY_TYPED (FL_TYPED(0) || FL_TYPED(1) || FL_TYPED(2) || FL_TYPED(3))

namespace fl {

// Y storage types: the codes of ops/fused_likelihood.py's Y_DTYPES.
constexpr int kYF32 = 0, kYBF16 = 1, kYI16 = 2, kYI8 = 3;

// Cells are packed and walked in tiles of kCellTile; N is padded to a whole
// tile with zeros.
struct GenePlan {
  int KF, NT, n_pass, kCT, n_pad, n_chunks;
  size_t part, bp, ct;  // floats of the scratch: partial sums, packed B, cell table
};

struct FwdArgs {
  const void* Y;  // (N, G) in the storage type
  const float *psi, *W, *logmu, *muL;
  float *A1, *A2, *Z, *YW;
  int N, G, Kf, nA2, SC;
  cudaStream_t stream;
};

struct GeneArgs {
  const void* Y;  // (N, G) in the storage type
  const float *W, *muL;
  const float4* bp;  // packed by gene_pack_kernel
  const float* ct;
  float* part;
  int N, G, Kf, nA2, SC, rows_per_chunk;
  GenePlan plan;
  cudaStream_t stream;
};

// The wide gene part's arguments: part holds the partial sums of n_chunks
// chunks of rows_per_chunk cells.
struct GeneWideArgs {
  const void* Y;  // (N, G) in the storage type
  const float *psi, *W, *muL, *dA1, *dA2, *dZ;
  float* part;
  int N, G, Kf, nA2, SC, rows_per_chunk, n_chunks;
  cudaStream_t stream;
};

// The Y-reading kernels of one storage type: fwd_kernel, and gene_kernel
// (between gene_pack_kernel and reduce_chunks_kernel, which fl_backward_gene
// launches); and the wide family's fwd_wide_kernel and gene_wide_kernel.
template <int YT> void forward_typed(const FwdArgs& a);
template <int YT> void gene_typed(const GeneArgs& a);
template <int YT> void forward_wide_typed(const FwdArgs& a);
template <int YT> void gene_wide_typed(const GeneWideArgs& a);

}  // namespace fl

namespace {

using namespace fl;

constexpr int kWarp = 32;
constexpr int kMaxKf = 4;
constexpr int kMaxA2 = 4;
constexpr int kTileG = 128;        // genes per shared-memory table tile
constexpr int kFwdWarps = 8;       // forward and dpsi blocks: 8 warps x 16 cell rows
constexpr int kFwdRows = 16;       // cell rows a warp owns (the MMA's M)
constexpr int kFwdSub = 32;        // genes a warp takes per sub-tile
constexpr int kSteps = kTileG / 8;  // MMA k-steps of 8 genes per table tile
constexpr int kGeneWarps = 8;                          // gene-major blocks: 8 warps x 16 genes
constexpr int kGeneBlock = kGeneWarps * kFwdRows;      // genes a gene-major block owns
constexpr int kCellTile = 64;                          // cells staged in shared memory at once
constexpr int kCellSteps = kCellTile / 8;              // MMA k-steps of 8 cells per tile
constexpr int kCellsPerWarp = kCellTile / kGeneWarps;  // Y rows a warp streams per tile
// n-tiles of B a gene-major pass holds: 4 (32 columns) at Kf <= 1; fewer
// where ptxas spilled at 128 registers, the bound that keeps two blocks on
// an SM (KF = 2 at NT = 4, KF = 3 and 4 at NT = 3).
constexpr int max_live_nt(int KF) { return KF == 1 ? 4 : KF == 2 ? 3 : 2; }
// The wide family: its bounds (ops/fused_likelihood.py's WIDE_MAX_*) and tiles.
constexpr int kWideMaxKf = 64, kWideMaxA2 = 64, kWideMaxSC = 2048;
constexpr int kWideThreads = 256;
constexpr int kWideOut = 8;     // outputs a thread keeps, along one row of a tile
constexpr int kWideG = 32;      // genes a forward / dpsi tile
constexpr int kWideJ = 32;      // dZ and muL columns a backward pass
constexpr int kDpsiCells = 64;  // cells a dpsi block
constexpr int kGeneCells = 32;  // cells a gene-part tile
constexpr int kGeneGenes = 64;  // genes a gene-part block
// Pairs (output row, column) a thread keeps in the backward's products with
// psi and W: dpsi's kDpsiCells x Kf, the gene part's kGeneGenes x (Kf + nA2).
constexpr int kDpsiPairs = kDpsiCells * kWideMaxKf / kWideThreads;
constexpr int kGenePairs = kGeneGenes * (kWideMaxKf + kWideMaxA2) / kWideThreads;

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

// Y in its storage type: Elem is one count, Piece four consecutive ones.
template <int YT> struct YStore;
template <> struct YStore<kYF32> { using Elem = float; using Piece = float4; };
template <> struct YStore<kYBF16> { using Elem = uint16_t; using Piece = uint2; };  // bfloat16 bits
template <> struct YStore<kYI16> { using Elem = int16_t; using Piece = uint2; };
template <> struct YStore<kYI8> { using Elem = int8_t; using Piece = uint32_t; };

// The four counts of a piece as floats, exactly. An integer v of b bits
// with its sign bit flipped is v + 2^(b-1) >= 0; permuted into the low
// bytes of 0x4b400000 (1.5 * 2^23, whose significand's low 22 bits are 0)
// it makes the float 1.5 * 2^23 + v + 2^(b-1), and one subtraction leaves
// v: a byte permute and an add, not a conversion on the pipe the exps use.
template <int YT>
__device__ __forceinline__ float4 piece_to_float4(typename YStore<YT>::Piece p) {
  if constexpr (YT == kYF32) {
    return p;
  } else if constexpr (YT == kYBF16) {
    return make_float4(__uint_as_float(p.x << 16), __uint_as_float(p.x & 0xffff0000u),
                       __uint_as_float(p.y << 16), __uint_as_float(p.y & 0xffff0000u));
  } else if constexpr (YT == kYI16) {
    constexpr float kOff = 12582912.f + 32768.f;
    const uint32_t a = p.x ^ 0x80008000u, b = p.y ^ 0x80008000u;
    return make_float4(__uint_as_float(__byte_perm(a, 0x4b400000u, 0x7610)) - kOff,
                       __uint_as_float(__byte_perm(a, 0x4b400000u, 0x7632)) - kOff,
                       __uint_as_float(__byte_perm(b, 0x4b400000u, 0x7610)) - kOff,
                       __uint_as_float(__byte_perm(b, 0x4b400000u, 0x7632)) - kOff);
  } else {
    constexpr float kOff = 12582912.f + 128.f;
    const uint32_t a = p ^ 0x80808080u;
    return make_float4(__uint_as_float(__byte_perm(a, 0x4b400000u, 0x7650)) - kOff,
                       __uint_as_float(__byte_perm(a, 0x4b400000u, 0x7651)) - kOff,
                       __uint_as_float(__byte_perm(a, 0x4b400000u, 0x7652)) - kOff,
                       __uint_as_float(__byte_perm(a, 0x4b400000u, 0x7653)) - kOff);
  }
}

// Genes g .. g+3 of one Y row as a piece, zero past G. vec: every piece is
// aligned (G % 4 == 0 and Y aligned to a piece), so g .. g+3 are all in or
// all out; otherwise each count is loaded alone.
template <int YT>
__device__ __forceinline__ typename YStore<YT>::Piece load_y4(
    const typename YStore<YT>::Elem* __restrict__ row, int g, int G, bool vec) {
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  if (vec) return g < G ? __ldcs(reinterpret_cast<const Piece*>(row + g)) : Piece{};
  Elem e[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) e[u] = g + u < G ? __ldcs(row + g + u) : Elem(0);
  if constexpr (YT == kYF32) {
    return make_float4(e[0], e[1], e[2], e[3]);
  } else if constexpr (YT == kYI8) {
    return (uint32_t)(uint8_t)e[0] | (uint32_t)(uint8_t)e[1] << 8 |
           (uint32_t)(uint8_t)e[2] << 16 | (uint32_t)(uint8_t)e[3] << 24;
  } else {
    return make_uint2((uint32_t)(uint16_t)e[0] | (uint32_t)(uint16_t)e[1] << 16,
                      (uint32_t)(uint16_t)e[2] | (uint32_t)(uint16_t)e[3] << 16);
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

#if FL_ANY_TYPED
// ---------------------------------------------------------------------------
// Forward: A1, optional A2, Z and Y W. YT: Y's storage type; KF = max(Kf, 1).
// ---------------------------------------------------------------------------
// Two blocks an SM, so at most 128 registers: with only the block size
// given, ptxas cut some narrow-Y instantiations to 64 registers and spilled.
template <int YT, int KF, int NT, bool WITH_A2>
__global__ void __launch_bounds__(kFwdWarps * kWarp, 2)
fwd_kernel(const typename YStore<YT>::Elem* __restrict__ Y, const float* __restrict__ psi,
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
  using Piece = typename YStore<YT>::Piece;
  const typename YStore<YT>::Elem* y_rows = Y + (size_t)(row0 + yr) * G;
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) live[i] = row0 + yr + 4 * i < N;
  // The next sub-tile's pieces stay in the storage type until they are used.
  auto load_sub = [&](Piece (&y)[4], int g) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      y[i] = live[i] ? load_y4<YT>(y_rows + (size_t)(4 * i) * G, g + 4 * q, G, vec) : Piece{};
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

  // A2's 16 sums take the registers of the next sub-tile's Y: with A2 each
  // sub-tile's Y is loaded at its start (still ahead of its Z work).
  constexpr bool kPrefetch = !WITH_A2;
  Piece y_next[4];
  if constexpr (kPrefetch) load_sub(y_next, 0);
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

    Piece y_raw[4];
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < 4; ++i) y_raw[i] = y_next[i];
      if (sub + 1 < n_sub) load_sub(y_next, gs + kFwdSub);
    } else {
      load_sub(y_raw, gs);
    }

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

    // Y W (and Y log mu) on CUDA cores, Y converted only now: its pieces
    // stay narrow in registers while the Z work hides their loads.
    float4 y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = piece_to_float4<YT>(y_raw[i]);
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
#endif  // FL_ANY_TYPED

#if FL_COMMON
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
#endif  // FL_COMMON

// ---------------------------------------------------------------------------
// Backward, gene-major partial sums over one chunk of cells:
//   part[chunk, f, g] for f in [dW^T (Kf rows) | d(muL)^T (SC rows) | dlog_mu (nA2 rows)]
// With rfe = exp(psi W^T) and B = [dZ | dZ psi_1 | ... | dZ psi_Kf] (N x NC,
// NC = (1 + Kf) SC, column c SC + j is dZ[:, j] psi[:, c - 1]):
//   d(muL)[g,j]  = (rfe^T B)[g, j],
//   dW[g,k]      = sum_n Y[n,g] dA1[n] psi[n,k] + sum_j muL[g,j] (rfe^T B)[g, (k+1) SC + j],
//   dlog_mu[s,g] = sum_n Y[n,g] dA2[n,s].
// KF = max(Kf, 1); NT n-tiles of B (8 columns each) are live in a pass, and
// wider B takes several passes over the chunk. The cell-side operands are
// packed once per call by gene_pack_kernel: B in MMA fragment order, split
// into TF32 hi and lo, and a table of kCT floats a cell (psi, dA1 psi, dA2).
// ---------------------------------------------------------------------------

// x = hi + lo, both TF32, exactly as split_tf32 gives them (each rounded to
// nearest, ties away from zero, as cvt.rna does), but with integer adds and
// masks: a conversion issues at 16 a clock on an SM, on the pipe that also
// runs the exps, and the gene kernel splits every element it multiplies.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// cp.async of kBytes (16, 8 or 4) that reads the first `bytes` of them from
// gmem and zero-fills the rest.
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// bp[pass][ks][t][lane] = (hi(b0), hi(b1), lo(b0), lo(b1)) with b0 = B[8 ks +
// (lane & 3), q], b1 = B[8 ks + (lane & 3) + 4, q], q = 8 (pass NT + t) +
// (lane >> 2): a lane's operands for n-tile t of k-step ks, zero past N and NC.
// ct[n] = [psi[n, 0..KF) | dA1[n] psi[n, 0..KF) | dA2[n, 0..kMaxA2)] (the last
// part only WITH_A2), zero past N, Kf and nA2.
#if FL_COMMON
template <int KF, int NT, bool WITH_A2>
__global__ void gene_pack_kernel(const float* __restrict__ psi, const float* __restrict__ dA1,
                                 const float* __restrict__ dA2, const float* __restrict__ dZ,
                                 float4* __restrict__ bp, float* __restrict__ ct, int N,
                                 int Kf, int nA2, int SC, int n_pass, int n_pad) {
  constexpr int kCT = 2 * KF + (WITH_A2 ? kMaxA2 : 0);
  const int NC = (Kf + 1) * SC, n_steps = n_pad / 8;
  const long long n_bp = (long long)n_pass * n_steps * NT * kWarp;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n_bp) {
    const int l = (int)(i % kWarp), t = (int)((i / kWarp) % NT);
    const long long r = i / (kWarp * NT);
    const int ks = (int)(r % n_steps), pass = (int)(r / n_steps);
    const int q = 8 * (pass * NT + t) + (l >> 2), n = 8 * ks + (l & 3);
    float b0 = 0.f, b1 = 0.f;
    if (q < NC) {
      const int c = q / SC, j = q - c * SC;
      if (n < N)
        b0 = c ? dZ[(size_t)n * SC + j] * psi[(size_t)n * Kf + c - 1] : dZ[(size_t)n * SC + j];
      if (n + 4 < N)
        b1 = c ? dZ[(size_t)(n + 4) * SC + j] * psi[(size_t)(n + 4) * Kf + c - 1]
               : dZ[(size_t)(n + 4) * SC + j];
    }
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    bp[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                        __uint_as_float(l1));
  } else if (i < n_bp + (long long)n_pad * kCT) {
    const long long e = i - n_bp;
    const int n = (int)(e / kCT), r = (int)(e % kCT);
    float v = 0.f;
    if (n < N) {
      if (r < 2 * KF) {
        const int k = r % KF;
        if (k < Kf) v = r < KF ? psi[(size_t)n * Kf + k] : dA1[n] * psi[(size_t)n * Kf + k];
      } else if (r - 2 * KF < nA2) {
        v = dA2[(size_t)n * nA2 + (r - 2 * KF)];
      }
    }
    ct[e] = v;
  }
}
#endif  // FL_COMMON

#if FL_ANY_TYPED
template <int YT, int KF, int NT, bool WITH_A2>
__global__ void __launch_bounds__(kGeneWarps * kWarp, 2)
gene_kernel(const typename YStore<YT>::Elem* __restrict__ Y, const float* __restrict__ W,
            const float* __restrict__ muL, const float4* __restrict__ bp,
            const float* __restrict__ ct, float* __restrict__ part, int N, int G,
            int Kf, int nA2, int SC, int rows_per_chunk, int n_pad, bool vec) {
  constexpr int kYF = KF + (WITH_A2 ? kMaxA2 : 0);  // Y-stream factors: dA1 psi_k, dA2_s
  constexpr int kCT = KF + kYF;                     // cell-table floats a cell
  constexpr int kBTile = kCellSteps * NT * kWarp;   // float4s of B a tile
  constexpr int kCTTile = kCellTile * kCT / 4;      // float4s of the cell table a tile
  // The pair loop and the Y terms' loop unrolled as far as fits in 128
  // registers without spilling, for every Y storage type (the Y loop fully
  // unrolled was 6% faster than by two: gene_variants.py).
  constexpr int kPairUnroll =
      NT == 1 || (NT <= 3 && KF == 1 && !WITH_A2) ? kCellSteps / 2 : NT == 2 ? 2 : 1;
  constexpr int kYUnroll = NT == 4 && KF == 1 && !WITH_A2 ? 2 : kCellsPerWarp;
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  // Dynamic shared memory (sized by gene_typed): a ring of two tiles of B
  // fragments and of Y rows (in Y's storage type) during the walk; the
  // warps' Y sums after it.
  extern __shared__ float4 s_dyn[];
  __shared__ __align__(16) float s_ct[2][kCellTile][kCT];
  __shared__ float s_dw[KF][kGeneBlock];
  auto s_b = reinterpret_cast<float4 (*)[kCellSteps][NT][kWarp]>(s_dyn);
  auto s_yt = reinterpret_cast<Piece (*)[kCellTile][kGeneBlock / 4]>(s_dyn + 2 * kBTile);
  auto s_y = reinterpret_cast<float (*)[kYF][kGeneBlock]>(s_dyn);

  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int gbase = blockIdx.x * kGeneBlock;
  // MMA fragments: this lane's A rows (genes) g0 and g1, its A columns
  // (cells) c and c + 4 of a k-step, its D columns 2c and 2c + 1.
  const int fr = lane >> 2, fc = lane & 3;
  const int g0 = gbase + warp * kFwdRows + fr, g1 = g0 + 8;
  // Y stream: this lane copies and reads genes gy .. gy + 3 of the tile's
  // rows warp, warp + 8, ..., so a thread reads only what it copied.
  const int gy = gbase + 4 * lane;
  const int chunk = blockIdx.y;
  const int n_begin = chunk * rows_per_chunk;
  const int n_end = min(N, n_begin + rows_per_chunk);
  const int n_tiles = (n_end - n_begin + kCellTile - 1) / kCellTile;
  const int F = Kf + SC + nA2;
  const int NC = (Kf + 1) * SC;
  const int n_pass = (NC + 8 * NT - 1) / (8 * NT);

  float w0[KF], w1[KF];  // W of the lane's two genes
#pragma unroll
  for (int k = 0; k < KF; ++k) {
    w0[k] = (k < Kf && g0 < G) ? W[(size_t)g0 * Kf + k] : 0.f;
    w1[k] = (k < Kf && g1 < G) ? W[(size_t)g1 * Kf + k] : 0.f;
  }
  float ys[4][kYF];  // Y-stream sums of the lane's 4 genes
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < kYF; ++r) ys[i][r] = 0.f;
  float dw[KF][2];  // dW's rfe term for g0 and g1 over this lane's columns
#pragma unroll
  for (int k = 0; k < KF; ++k) dw[k][0] = dw[k][1] = 0.f;

  // No early exit: every warp takes part in the block's barriers; genes past
  // G and cells past N compute on zeros and write nothing.
#pragma unroll 1
  for (int pass = 0; pass < n_pass; ++pass) {
    const bool stream_y = pass == 0;
    const float4* bp_pass = bp + (size_t)pass * (n_pad / 8) * NT * kWarp;
    auto stage = [&](int tile, int buf) {  // cp.async of one tile into the ring
      const int n0 = n_begin + tile * kCellTile;
      const float4* src = bp_pass + (size_t)(n0 / 8) * NT * kWarp;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int e = threadIdx.x + i * kGeneWarps * kWarp;
        cp_async_zfill<16>(&s_b[buf][0][0][0] + e, src + e, 16);
      }
      if (threadIdx.x < kCTTile)
        cp_async_zfill<16>(&s_ct[buf][0][0] + 4 * threadIdx.x, ct + (size_t)n0 * kCT + 4 * threadIdx.x, 16);
      if (stream_y) {
        // Not unrolled: the row addresses are then formed as they are needed
        // rather than kept in registers across the walk.
#pragma unroll 1
        for (int i = 0; i < kCellsPerWarp; ++i) {
          const int cl = warp + kGeneWarps * i, n = n0 + cl;
          Piece* dst = &s_yt[buf][cl][lane];
          const Elem* row = Y + (size_t)(n < n_end ? n : 0) * G;
          if (vec) {
            cp_async_zfill<sizeof(Piece)>(dst, row + (gy < G ? gy : 0),
                                          n < n_end && gy < G ? (int)sizeof(Piece) : 0);
          } else {
            // Unaligned pieces go count by count: a float32 one by a 4-byte
            // cp.async, one of 1 or 2 bytes (under cp.async's least size)
            // by the thread's own load and store.
            Elem* d = reinterpret_cast<Elem*>(dst);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const bool in = n < n_end && gy + u < G;
              if constexpr (YT == kYF32)
                cp_async_zfill<4>(d + u, row + (in ? gy + u : 0), in ? 4 : 0);
              else
                d[u] = in ? row[gy + u] : Elem(0);
            }
          }
        }
      }
      cp_async_commit();
    };
    // Sums of this pass's columns as unevaluated pairs hi + lo of floats:
    // a float32 running sum, even over the 8 k-steps of a tile, lost more to
    // rounding than the 3xTF32 products do, and float64 would cost a
    // conversion per term on the same narrow pipe as the exps.
    float acc_hi[NT][4], acc_lo[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_hi[t][e] = acc_lo[t][e] = 0.f;

    __syncthreads();  // the previous pass is done with the ring
    stage(0, 0);
#pragma unroll 1
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = tile & 1;
      cp_async_wait_all();
      __syncthreads();  // the tile has landed, and the other buffer is free
      if (tile + 1 < n_tiles) stage(tile + 1, buf ^ 1);

      // rfe^T B on tensor cores, each k-step's three products in fresh
      // accumulators added on CUDA cores (the tensor cores' own sum does not
      // round to nearest, and dZ is signed): two k-steps in float32, then
      // into the pair sums (Fast2Sum: s = hi + x, lo += x - (s - hi)).
#pragma unroll kPairUnroll
      for (int kp = 0; kp < kCellSteps / 2; ++kp) {
        float x[NT][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int ks = 2 * kp + h2, c = ks * 8 + fc;
          // A fragment order: (g0, c), (g1, c), (g0, c + 4), (g1, c + 4).
          float lr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < KF; ++k) {
            const float p0 = s_ct[buf][c][k], p1 = s_ct[buf][c + 4][k];
            lr[0] = fmaf(p0, w0[k], lr[0]);
            lr[1] = fmaf(p0, w1[k], lr[1]);
            lr[2] = fmaf(p1, w0[k], lr[2]);
            lr[3] = fmaf(p1, w1[k], lr[3]);
          }
          uint32_t a_hi[4], a_lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32_int(__expf(lr[e]), a_hi[e], a_lo[e]);
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(d, a_hi, a_lo, s_b[buf][ks][t][lane]);
#pragma unroll
            for (int e = 0; e < 4; ++e) x[t][e] = h2 ? x[t][e] + d[e] : d[e];
          }
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s = acc_hi[t][e] + x[t][e];
            acc_lo[t][e] += x[t][e] - (s - acc_hi[t][e]);
            acc_hi[t][e] = s;
          }
      }

      // The Y terms on CUDA cores: the warp's rows of the tile.
      if (stream_y) {
#pragma unroll kYUnroll
        for (int i = 0; i < kCellsPerWarp; ++i) {
          const int cl = warp + kGeneWarps * i;
          const float4 y = piece_to_float4<YT>(s_yt[buf][cl][lane]);
#pragma unroll
          for (int r = 0; r < kYF; ++r) {
            const float f = s_ct[buf][cl][KF + r];
            ys[0][r] = fmaf(y.x, f, ys[0][r]);
            ys[1][r] = fmaf(y.y, f, ys[1][r]);
            ys[2][r] = fmaf(y.z, f, ys[2][r]);
            ys[3][r] = fmaf(y.w, f, ys[3][r]);
          }
        }
      }
    }

    // The pass's columns: d(muL) is stored, dW's rfe term folded with muL.
    // D fragment order: (g0, 2c), (g0, 2c + 1), (g1, 2c), (g1, 2c + 1).
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 8 * (pass * NT + t) + 2 * fc + e, g = h ? g1 : g0;
          const bool live = q < NC && g < G;
          const int c = live ? q / SC : -1, j = q - c * SC;
          const float v = acc_hi[t][2 * h + e] + acc_lo[t][2 * h + e];
          if (c == 0) part[((size_t)chunk * F + Kf + j) * G + g] = v;
          const float m = c > 0 ? muL[(size_t)g * SC + j] : 0.f;
#pragma unroll
          for (int k = 0; k < KF; ++k)
            if (c == k + 1) dw[k][h] = fmaf(m, v, dw[k][h]);
        }
  }

  // dW's rfe term: the 4 lanes of a row group hold disjoint columns.
#pragma unroll
  for (int k = 0; k < KF; ++k)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = dw[k][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      dw[k][h] = v;
    }
  __syncthreads();  // the ring is consumed
  if (fc == 0) {
#pragma unroll
    for (int k = 0; k < KF; ++k) {
      s_dw[k][warp * kFwdRows + fr] = dw[k][0];
      s_dw[k][warp * kFwdRows + fr + 8] = dw[k][1];
    }
  }
#pragma unroll
  for (int r = 0; r < kYF; ++r)
    *reinterpret_cast<float4*>(&s_y[warp][r][4 * lane]) =
        make_float4(ys[0][r], ys[1][r], ys[2][r], ys[3][r]);
  __syncthreads();
  // The warps' Y sums added in a fixed order; dW gains its rfe term.
  for (int i = threadIdx.x; i < kYF * kGeneBlock; i += blockDim.x) {
    const int r = i / kGeneBlock, gl = i % kGeneBlock, g = gbase + gl;
    if (g >= G) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kGeneWarps; ++w) v += s_y[w][r][gl];
    if (r < Kf)
      part[((size_t)chunk * F + r) * G + g] = v + s_dw[r][gl];
    else if (r >= KF && r - KF < nA2)
      part[((size_t)chunk * F + Kf + SC + r - KF) * G + g] = v;
  }
}
#endif  // FL_ANY_TYPED

#if FL_COMMON
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

#endif  // FL_COMMON

// ---------------------------------------------------------------------------
// The wide family (see the note at the top): float32 FMAs on CUDA cores,
// runtime Kf, nA2 and SC. Every loop over a register array is unrolled, so
// the arrays stay in registers; a thread's outputs past the live rows and
// columns compute on zeros and are not written. Each tile's products are
// summed in float32 and the tiles' sums in float64: the backward's sums are
// signed and cancel, and a float32 running sum over 1,024 cells lost more
// than the tolerance at cancelling elements of dW (one add and one
// conversion a tile per output, against 32 FMAs).
// ---------------------------------------------------------------------------

// One count of Y as a float, exactly.
template <int YT>
__device__ __forceinline__ float y_to_float(typename YStore<YT>::Elem e) {
  if constexpr (YT == kYBF16)
    return __uint_as_float((uint32_t)e << 16);
  else
    return (float)e;
}

// acc[0..8) += a * b[0..8), b a 16-byte-aligned row of 8 floats in shared memory.
__device__ __forceinline__ void fma8(float (&acc)[kWideOut], float a, const float* b) {
  const float4 b0 = *reinterpret_cast<const float4*>(b);
  const float4 b1 = *reinterpret_cast<const float4*>(b + 4);
  acc[0] = fmaf(a, b0.x, acc[0]);
  acc[1] = fmaf(a, b0.y, acc[1]);
  acc[2] = fmaf(a, b0.z, acc[2]);
  acc[3] = fmaf(a, b0.w, acc[3]);
  acc[4] = fmaf(a, b1.x, acc[4]);
  acc[5] = fmaf(a, b1.y, acc[5]);
  acc[6] = fmaf(a, b1.z, acc[6]);
  acc[7] = fmaf(a, b1.w, acc[7]);
}

#if FL_ANY_TYPED
// Forward, wide. Grid (cell tiles of TN, nZ + nY column groups of JW):
// blockIdx.y < nZ computes Z's columns [JW y, JW y + JW) from exp(psi W^T);
// else group y - nZ of the Y products [Y W | Y log mu^T] (Kf + nA2 columns),
// the first of which also writes A1 = sum_g Y log_rfe. Thread t keeps row
// t % TN and the 8 columns from 8 (t / TN) of its block's outputs, and stages
// gene t % 32 of rows t / 32 + 8 i of each tile. Dynamic shared memory: psi^T
// of the block's cells (Kf x TN), then W^T of the tile (Kf x kWideG).
template <int YT, int JW>
__global__ void __launch_bounds__(kWideThreads)
fwd_wide_kernel(const typename YStore<YT>::Elem* __restrict__ Y, const float* __restrict__ psi,
                const float* __restrict__ W, const float* __restrict__ logmu,
                const float* __restrict__ muL, float* __restrict__ A1,
                float* __restrict__ A2, float* __restrict__ Z, float* __restrict__ YW,
                int N, int G, int Kf, int nA2, int SC, int nZ) {
  constexpr int TN = kWideThreads * kWideOut / JW;    // cells a block
  constexpr int kRowStep = kWideThreads / kWideG;     // rows between a thread's staged elements
  constexpr int kStage = TN / kRowStep;               // tile elements a thread stages
  __shared__ float s_a[TN][kWideG + 1];               // the tile's rfe or Y, cell-major
  __shared__ __align__(16) float s_b[kWideG][JW];     // the tile's muL or [W | log mu^T] columns
  extern __shared__ __align__(16) float s_wide[];
  float* s_psi = s_wide;           // [k][row]
  float* s_wt = s_wide + Kf * TN;  // [k][gene of the tile]

  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const int n0 = blockIdx.x * TN;
  const bool z_part = (int)blockIdx.y < nZ;
  const int c0 = (z_part ? (int)blockIdx.y : (int)blockIdx.y - nZ) * JW;
  const bool with_a1 = !z_part && c0 == 0;
  const bool with_rfe = z_part || with_a1;
  const int n_cols = z_part ? SC : Kf + nA2;
  const int r_out = t % TN, j_out = (t / TN) * kWideOut;

  for (int i = t; i < Kf * TN; i += kWideThreads) {
    const int k = i / TN, n = n0 + i % TN;
    s_psi[i] = n < N ? psi[(size_t)n * Kf + k] : 0.f;
  }
  double acc[kWideOut];
  float a1[kStage];
#pragma unroll
  for (int j = 0; j < kWideOut; ++j) acc[j] = 0.0;
#pragma unroll
  for (int i = 0; i < kStage; ++i) a1[i] = 0.f;

#pragma unroll 1
  for (int gs = 0; gs < G; gs += kWideG) {
    __syncthreads();  // the previous tile is consumed (and psi^T staged)
    for (int i = t; i < kWideG * JW; i += kWideThreads) {
      const int gl = i / JW, c = c0 + i % JW, g = gs + gl;
      float v = 0.f;
      if (g < G && c < n_cols)
        v = z_part ? muL[(size_t)g * SC + c]
            : c < Kf ? W[(size_t)g * Kf + c] : logmu[(size_t)(c - Kf) * G + g];
      s_b[gl][i % JW] = v;
    }
    if (with_rfe) {
      for (int i = t; i < Kf * kWideG; i += kWideThreads) {
        const int g = gs + i % kWideG;
        s_wt[i] = g < G ? W[(size_t)g * Kf + i / kWideG] : 0.f;
      }
    }
    __syncthreads();
    // Stage A: rfe (Z groups) or Y (Y groups), with log_rfe where needed.
    const int g = gs + lane;
    float lr[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) lr[i] = 0.f;
    if (with_rfe) {
#pragma unroll 1
      for (int k = 0; k < Kf; ++k) {
        const float w = s_wt[k * kWideG + lane];
#pragma unroll
        for (int i = 0; i < kStage; ++i)
          lr[i] = fmaf(s_psi[k * TN + warp + kRowStep * i], w, lr[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int r = warp + kRowStep * i, n = n0 + r;
      float a;
      if (z_part) {
        a = g < G ? __expf(lr[i]) : 0.f;
      } else {
        a = (n < N && g < G) ? y_to_float<YT>(Y[(size_t)n * G + g]) : 0.f;
        a1[i] = fmaf(a, lr[i], a1[i]);
      }
      s_a[r][lane] = a;
    }
    __syncthreads();
    float tile[kWideOut] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int gl = 0; gl < kWideG; ++gl) fma8(tile, s_a[r_out][gl], &s_b[gl][j_out]);
#pragma unroll
    for (int j = 0; j < kWideOut; ++j) acc[j] += tile[j];
  }

  const int n = n0 + r_out;
  if (n < N) {
#pragma unroll
    for (int j = 0; j < kWideOut; ++j) {
      const int c = c0 + j_out + j;
      if (z_part) {
        if (c < SC) Z[(size_t)n * SC + c] = (float)acc[j];
      } else if (c < Kf) {
        YW[(size_t)n * Kf + c] = (float)acc[j];
      } else if (c < Kf + nA2) {
        A2[(size_t)n * nA2 + c - Kf] = (float)acc[j];
      }
    }
  }
  if (with_a1) {  // the 32 lanes of a warp hold one row's sums over disjoint genes
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      float v = a1[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      const int nr = n0 + warp + kRowStep * i;
      if (lane == 0 && nr < N) A1[nr] = v;
    }
  }
}
#endif  // FL_ANY_TYPED

#if FL_COMMON
// Backward, wide, Y-free: dpsi[n,k] = dA1[n] YW[n,k] + sum_g rfe[n,g]
// drfe[n,g] W[g,k], drfe = dZ muL^T, in passes over kWideJ columns of dZ.
// Thread t computes drfe and rfe at row t % 64, genes 8 (t / 64) .. + 8 of a
// tile, and keeps the dpsi pairs p = t + 256 i (row p % 64, column p / 64).
// Dynamic shared memory: psi^T of the block's cells (Kf x kDpsiCells), then
// W^T of the tile (Kf x kWideG).
__global__ void __launch_bounds__(kWideThreads)
dpsi_wide_kernel(const float* __restrict__ psi, const float* __restrict__ W,
                 const float* __restrict__ muL, const float* __restrict__ dA1,
                 const float* __restrict__ dZ, const float* __restrict__ YW,
                 float* __restrict__ dpsi, int N, int G, int Kf, int SC) {
  __shared__ float s_dz[kDpsiCells][kWideJ + 1];              // the pass's dZ, cell-major
  __shared__ __align__(16) float s_mt[kWideJ][kWideG + 4];    // the tile's muL^T
  __shared__ float s_t[kDpsiCells][kWideG + 1];               // rfe drfe of the tile
  extern __shared__ __align__(16) float s_wide[];
  float* s_psi = s_wide;                   // [k][row]
  float* s_wt = s_wide + Kf * kDpsiCells;  // [k][gene of the tile]

  const int t = threadIdx.x;
  const int n0 = blockIdx.x * kDpsiCells;
  const int r = t % kDpsiCells, g_out = (t / kDpsiCells) * kWideOut;
  const int n_pairs = kDpsiCells * Kf;

  for (int i = t; i < Kf * kDpsiCells; i += kWideThreads) {
    const int n = n0 + i % kDpsiCells;
    s_psi[i] = n < N ? psi[(size_t)n * Kf + i / kDpsiCells] : 0.f;
  }
  double acc[kDpsiPairs];
#pragma unroll
  for (int i = 0; i < kDpsiPairs; ++i) acc[i] = 0.0;

#pragma unroll 1
  for (int c0 = 0; c0 < SC; c0 += kWideJ) {
    __syncthreads();  // the previous pass is done with s_dz
    for (int i = t; i < kDpsiCells * kWideJ; i += kWideThreads) {
      const int rr = i / kWideJ, j = i % kWideJ, n = n0 + rr, c = c0 + j;
      s_dz[rr][j] = (n < N && c < SC) ? dZ[(size_t)n * SC + c] : 0.f;
    }
#pragma unroll 1
    for (int gs = 0; gs < G; gs += kWideG) {
      __syncthreads();  // the previous tile is consumed
      for (int i = t; i < kWideJ * kWideG; i += kWideThreads) {
        // 8 columns of 4 genes a warp: 32-byte pieces of muL's rows, and
        // no two lanes on one shared-memory bank
        const int j = (i >> 8) * 8 + (i & 7), gl = (i >> 3) & 31, g = gs + gl, c = c0 + j;
        s_mt[j][gl] = (g < G && c < SC) ? muL[(size_t)g * SC + c] : 0.f;
      }
      for (int i = t; i < Kf * kWideG; i += kWideThreads) {
        const int g = gs + i % kWideG;
        s_wt[i] = g < G ? W[(size_t)g * Kf + i / kWideG] : 0.f;
      }
      __syncthreads();
      float d[kWideOut], lr[kWideOut];
#pragma unroll
      for (int e = 0; e < kWideOut; ++e) d[e] = lr[e] = 0.f;
#pragma unroll 8
      for (int j = 0; j < kWideJ; ++j) fma8(d, s_dz[r][j], &s_mt[j][g_out]);
#pragma unroll 1
      for (int k = 0; k < Kf; ++k) fma8(lr, s_psi[k * kDpsiCells + r], &s_wt[k * kWideG + g_out]);
      // past G, muL and W are zero: drfe = 0
#pragma unroll
      for (int e = 0; e < kWideOut; ++e) s_t[r][g_out + e] = __expf(lr[e]) * d[e];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kDpsiPairs; ++i) {
        const int p = t + kWideThreads * i;
        if (p >= n_pairs) break;
        const int rr = p % kDpsiCells, k = p / kDpsiCells;
        float v = 0.f;
#pragma unroll 8
        for (int gl = 0; gl < kWideG; ++gl) v = fmaf(s_t[rr][gl], s_wt[k * kWideG + gl], v);
        acc[i] += v;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kDpsiPairs; ++i) {
    const int p = t + kWideThreads * i;
    if (p >= n_pairs) break;
    const int n = n0 + p % kDpsiCells, k = p / kDpsiCells;
    if (n < N) dpsi[(size_t)n * Kf + k] = (float)fma((double)dA1[n], (double)YW[(size_t)n * Kf + k], acc[i]);
  }
}
#endif  // FL_COMMON

#if FL_ANY_TYPED
// Backward, wide, gene part: part[chunk, f, g] for f in [dW^T (Kf rows) |
// d(muL)^T (SC rows) | dlog_mu (nA2 rows)] over one chunk of cells, in
// passes over kWideJ columns of dZ and muL, with 32-cell tiles:
//   drfe = dZ muL^T and rfe = exp(psi W^T) at cell t % 32, genes 8 (t / 32) .. + 8;
//   d(muL)[g, pass's columns] += rfe^T dZ, at gene t % 64, columns 8 (t / 64) .. + 8;
//   dW[g,k] += sum_n dlog_rfe[n,g] psi[n,k], dlog_rfe = rfe drfe (+ Y dA1 in
//   the first pass), and dlog_mu[s,g] += sum_n dA2[n,s] Y[n,g] in the first
//   pass: pairs p = t + 256 i, gene p % 64, column p / 64 (dW's Kf, then
//   dlog mu's nA2).
// Dynamic shared memory: W^T of the block's genes (Kf x kGeneGenes), then
// the tile's psi^T (Kf x 33), dA2^T (nA2 x 33) and dA1 (kGeneCells).
template <int YT>
__global__ void __launch_bounds__(kWideThreads)
gene_wide_kernel(const typename YStore<YT>::Elem* __restrict__ Y, const float* __restrict__ psi,
                 const float* __restrict__ W, const float* __restrict__ muL,
                 const float* __restrict__ dA1, const float* __restrict__ dA2,
                 const float* __restrict__ dZ, float* __restrict__ part, int N, int G,
                 int Kf, int nA2, int SC, int rows_per_chunk) {
  constexpr int kCS = kGeneCells + 1;  // row stride of the tile's cell vectors
  __shared__ __align__(16) float s_mt[kWideJ][kGeneGenes + 4];  // the pass's muL^T
  __shared__ float s_dz[kGeneCells][kWideJ + 1];                // the tile's dZ, for drfe
  __shared__ __align__(16) float s_dz4[kGeneCells][kWideJ];     // the same, for d(muL)
  __shared__ float s_r[kGeneCells][kGeneGenes + 1];             // rfe
  __shared__ float s_t[kGeneCells][kGeneGenes + 1];             // dlog_rfe (this pass's part)
  __shared__ float s_y[kGeneCells][kGeneGenes + 1];             // Y
  extern __shared__ __align__(16) float s_wide[];
  float* s_w = s_wide;                      // [k][gene of the block]
  float* s_psi = s_w + Kf * kGeneGenes;     // [k][cell of the tile]
  float* s_da2 = s_psi + Kf * kCS;          // [s][cell of the tile]
  float* s_da1 = s_da2 + nA2 * kCS;         // [cell of the tile]

  const int t = threadIdx.x, lane = t % kWarp, warp = t / kWarp;
  const int gb = blockIdx.x * kGeneGenes;
  const int chunk = blockIdx.y;
  const int n_begin = chunk * rows_per_chunk;
  const int n_end = min(N, n_begin + rows_per_chunk);
  const int F = Kf + SC + nA2;
  const int g_out = warp * kWideOut;                                    // drfe, rfe
  const int gm = t % kGeneGenes, j_out = (t / kGeneGenes) * kWideOut;  // d(muL)

  for (int i = t; i < Kf * kGeneGenes; i += kWideThreads) {
    const int g = gb + i % kGeneGenes;
    s_w[i] = g < G ? W[(size_t)g * Kf + i / kGeneGenes] : 0.f;
  }
  double acc[kGenePairs];
#pragma unroll
  for (int i = 0; i < kGenePairs; ++i) acc[i] = 0.0;

#pragma unroll 1
  for (int c0 = 0; c0 < SC; c0 += kWideJ) {
    const bool first = c0 == 0;
    __syncthreads();  // the previous pass is done with s_mt
    for (int i = t; i < kWideJ * kGeneGenes; i += kWideThreads) {
      // 8 columns of 4 genes a warp, as in dpsi_wide_kernel
      const int j = (i >> 9) * 8 + (i & 7), gl = (i >> 3) & 63, g = gb + gl, c = c0 + j;
      s_mt[j][gl] = (g < G && c < SC) ? muL[(size_t)g * SC + c] : 0.f;
    }
    double dm[kWideOut];
#pragma unroll
    for (int e = 0; e < kWideOut; ++e) dm[e] = 0.0;
    const int n_pairs = kGeneGenes * (Kf + (first ? nA2 : 0));

#pragma unroll 1
    for (int ns = n_begin; ns < n_end; ns += kGeneCells) {
      __syncthreads();  // the previous tile is consumed
      for (int i = t; i < kGeneCells * kWideJ; i += kWideThreads) {
        const int r = i / kWideJ, j = i % kWideJ, n = ns + r, c = c0 + j;
        const float v = (n < n_end && c < SC) ? dZ[(size_t)n * SC + c] : 0.f;
        s_dz[r][j] = v;
        s_dz4[r][j] = v;
      }
      for (int i = t; i < Kf * kGeneCells; i += kWideThreads) {
        const int k = i / kGeneCells, r = i % kGeneCells, n = ns + r;
        s_psi[k * kCS + r] = n < n_end ? psi[(size_t)n * Kf + k] : 0.f;
      }
      if (first) {
        for (int i = t; i < kGeneCells * kGeneGenes; i += kWideThreads) {
          const int r = i / kGeneGenes, gl = i % kGeneGenes, n = ns + r, g = gb + gl;
          s_y[r][gl] = (n < n_end && g < G) ? y_to_float<YT>(Y[(size_t)n * G + g]) : 0.f;
        }
        for (int i = t; i < nA2 * kGeneCells; i += kWideThreads) {
          const int s = i / kGeneCells, r = i % kGeneCells, n = ns + r;
          s_da2[s * kCS + r] = n < n_end ? dA2[(size_t)n * nA2 + s] : 0.f;
        }
        if (t < kGeneCells) s_da1[t] = ns + t < n_end ? dA1[ns + t] : 0.f;
      }
      __syncthreads();
      // drfe and rfe; cells past the chunk have dZ = psi = dA1 = Y = 0, so
      // they add nothing below
      float d[kWideOut], lr[kWideOut];
#pragma unroll
      for (int e = 0; e < kWideOut; ++e) d[e] = lr[e] = 0.f;
#pragma unroll 8
      for (int j = 0; j < kWideJ; ++j) fma8(d, s_dz[lane][j], &s_mt[j][g_out]);
#pragma unroll 1
      for (int k = 0; k < Kf; ++k) fma8(lr, s_psi[k * kCS + lane], &s_w[k * kGeneGenes + g_out]);
#pragma unroll
      for (int e = 0; e < kWideOut; ++e) {
        const float rfe = __expf(lr[e]);
        float v = rfe * d[e];
        if (first) v = fmaf(s_y[lane][g_out + e], s_da1[lane], v);
        s_r[lane][g_out + e] = rfe;
        s_t[lane][g_out + e] = v;
      }
      __syncthreads();
      float tile[kWideOut] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int r = 0; r < kGeneCells; ++r) fma8(tile, s_r[r][gm], &s_dz4[r][j_out]);
#pragma unroll
      for (int e = 0; e < kWideOut; ++e) dm[e] += tile[e];
#pragma unroll
      for (int i = 0; i < kGenePairs; ++i) {
        const int p = t + kWideThreads * i;
        if (p >= n_pairs) break;
        const int gl = p % kGeneGenes, c = p / kGeneGenes;
        float v = 0.f;
        if (c < Kf) {
#pragma unroll 8
          for (int r = 0; r < kGeneCells; ++r) v = fmaf(s_t[r][gl], s_psi[c * kCS + r], v);
        } else {
#pragma unroll 8
          for (int r = 0; r < kGeneCells; ++r) v = fmaf(s_y[r][gl], s_da2[(c - Kf) * kCS + r], v);
        }
        acc[i] += v;
      }
    }
    const int g = gb + gm;
#pragma unroll
    for (int e = 0; e < kWideOut; ++e) {
      const int c = c0 + j_out + e;
      if (g < G && c < SC) part[((size_t)chunk * F + Kf + c) * G + g] = (float)dm[e];
    }
  }
#pragma unroll
  for (int i = 0; i < kGenePairs; ++i) {
    const int p = t + kWideThreads * i;
    if (p >= kGeneGenes * (Kf + nA2)) break;
    const int g = gb + p % kGeneGenes, c = p / kGeneGenes;
    // dW^T rows, then dlog mu's after d(muL)'s
    if (g < G) part[((size_t)chunk * F + (c < Kf ? c : SC + c)) * G + g] = (float)acc[i];
  }
}
#endif  // FL_ANY_TYPED

inline int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

// Calls f(KF, NT, A2), each a std::integral_constant, for the gene-major
// instantiation that plan p and nA2 > 0 (with_a2) select. Only the n-tile
// counts gene_plan can pick for a KF are instantiated.
template <class F>
inline void gene_dispatch(const GenePlan& p, bool with_a2, F&& f) {
  auto at_kf = [&](auto kf) {
    constexpr int KF = decltype(kf)::value;
    auto at_nt = [&](auto nt) {
      if (with_a2)
        f(kf, nt, std::true_type{});
      else
        f(kf, nt, std::false_type{});
    };
    if (p.NT == 1) {
      at_nt(std::integral_constant<int, 1>{});
    } else if (p.NT == 2) {
      at_nt(std::integral_constant<int, 2>{});
    } else if constexpr (max_live_nt(KF) >= 3) {
      if (p.NT == 3)
        at_nt(std::integral_constant<int, 3>{});
      else if constexpr (max_live_nt(KF) >= 4)
        at_nt(std::integral_constant<int, 4>{});
    }
  };
  switch (p.KF) {
    case 1: at_kf(std::integral_constant<int, 1>{}); break;
    case 2: at_kf(std::integral_constant<int, 2>{}); break;
    case 3: at_kf(std::integral_constant<int, 3>{}); break;
    default: at_kf(std::integral_constant<int, 4>{});
  }
}

#if FL_COMMON
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

// B has (1 + Kf) SC columns, ceil((1 + Kf) SC / 8) n-tiles. A pass holds at
// most max_live_nt(KF) of them, and the passes split them evenly, so the
// padding is under one n-tile a pass (the main path, 20 columns, is one pass
// of 3).
GenePlan gene_plan(int N, int G, int Kf, int nA2, int SC, int rows_per_chunk) {
  GenePlan p;
  p.KF = Kf > 1 ? Kf : 1;
  const int tiles = ((Kf + 1) * SC + 7) / 8;
  p.n_pass = (tiles + max_live_nt(p.KF) - 1) / max_live_nt(p.KF);
  p.NT = (tiles + p.n_pass - 1) / p.n_pass;
  p.n_pass = (tiles + p.NT - 1) / p.NT;
  p.kCT = 2 * p.KF + (nA2 > 0 ? kMaxA2 : 0);
  p.n_pad = (N + kCellTile - 1) / kCellTile * kCellTile;
  p.n_chunks = (N + rows_per_chunk - 1) / rows_per_chunk;
  p.part = ((size_t)p.n_chunks * (Kf + SC + nA2) * G + 3) / 4 * 4;  // keeps bp 16-byte aligned
  p.bp = (size_t)p.n_pass * (p.n_pad / 8) * p.NT * kWarp * 4;
  p.ct = (size_t)p.n_pad * p.kCT;
  return p;
}

bool bad_sizes(int N, int G, int Kf, int nA2, int SC, int rows_per_chunk, int y_type) {
  return N < 1 || G < 1 || Kf < 0 || Kf > kMaxKf || nA2 < 0 || nA2 > kMaxA2 ||
         SC < 1 || SC > 32 || rows_per_chunk < 1 || y_type < kYF32 || y_type > kYI8;
}

// The wide family's sizes; rows_per_chunk (the gene part's) a whole number
// of 32-cell tiles.
bool bad_wide_sizes(int N, int G, int Kf, int nA2, int SC, int rows_per_chunk, int y_type) {
  return N < 1 || G < 1 || Kf < 0 || Kf > kWideMaxKf || nA2 < 0 || nA2 > kWideMaxA2 ||
         SC < 1 || SC > kWideMaxSC || rows_per_chunk < 1 || rows_per_chunk % kGeneCells ||
         y_type < kYF32 || y_type > kYI8;
}
#endif  // FL_COMMON

// Shared memory the wide kernels take beyond their static arrays.
inline int fwd_wide_smem(int Kf, int TN) { return Kf * (TN + kWideG) * (int)sizeof(float); }
inline int dpsi_wide_smem(int Kf) { return Kf * (kDpsiCells + kWideG) * (int)sizeof(float); }
inline int gene_wide_smem(int Kf, int nA2) {
  return (Kf * kGeneGenes + (Kf + nA2) * (kGeneCells + 1) + kGeneCells) * (int)sizeof(float);
}

#if FL_ANY_TYPED
template <int YT, int KF, int NT>
void launch_fwd(const FwdArgs& a) {
  using Elem = typename YStore<YT>::Elem;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const int grid = blocks_for(a.N, kFwdWarps * kFwdRows);
  const bool vec = a.G % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(Y) % sizeof(typename YStore<YT>::Piece) == 0;
  if (a.nA2 > 0)
    fwd_kernel<YT, KF, NT, true><<<grid, kFwdWarps * kWarp, 0, a.stream>>>(
        Y, a.psi, a.W, a.logmu, a.muL, a.A1, a.A2, a.Z, a.YW, a.N, a.G, a.Kf, a.nA2, a.SC, vec);
  else
    fwd_kernel<YT, KF, NT, false><<<grid, kFwdWarps * kWarp, 0, a.stream>>>(
        Y, a.psi, a.W, a.logmu, a.muL, a.A1, a.A2, a.Z, a.YW, a.N, a.G, a.Kf, a.nA2, a.SC, vec);
}

// One instantiation per n-tile count (8 Z columns each): every padding
// column costs the tensor cores a third of an n-tile's work.
template <int YT, int KF>
void launch_fwd_nt(const FwdArgs& a) {
  if (a.SC <= 8)
    launch_fwd<YT, KF, 1>(a);
  else if (a.SC <= 16)
    launch_fwd<YT, KF, 2>(a);
  else
    launch_fwd<YT, KF, 4>(a);
}
#endif  // FL_ANY_TYPED

}  // namespace

namespace fl {

#if FL_ANY_TYPED
template <int YT>
void forward_typed(const FwdArgs& a) {
  switch (a.Kf) {
    case 0:  // rfe = exp(0) = 1 and A1 = 0: one zero column
    case 1: launch_fwd_nt<YT, 1>(a); break;
    case 2: launch_fwd_nt<YT, 2>(a); break;
    case 3: launch_fwd_nt<YT, 3>(a); break;
    default: launch_fwd_nt<YT, 4>(a);
  }
}

template <int YT>
void gene_typed(const GeneArgs& a) {
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const dim3 grid(blocks_for(a.G, kGeneBlock), a.plan.n_chunks);
  const bool vec = a.G % 4 == 0 && reinterpret_cast<uintptr_t>(Y) % sizeof(Piece) == 0;
  gene_dispatch(a.plan, a.nA2 > 0, [&](auto kf, auto nt, auto a2) {
    constexpr int KF = decltype(kf)::value, NT = decltype(nt)::value;
    constexpr bool A2 = decltype(a2)::value;
    // Dynamic shared memory: the ring's two tiles of B fragments and of Y
    // pieces, or the warps' Y sums after the walk, whichever is larger.
    constexpr int kYF = KF + (A2 ? kMaxA2 : 0);
    constexpr int kRing = 2 * (kCellSteps * NT * kWarp * 16 +
                               kCellTile * (kGeneBlock / 4) * (int)sizeof(Piece));
    constexpr int kYSums = kGeneWarps * kYF * kGeneBlock * 4;
    constexpr int kSmem = kRing > kYSums ? kRing : kYSums;
    cudaFuncSetAttribute(gene_kernel<YT, KF, NT, A2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    gene_kernel<YT, KF, NT, A2><<<grid, kGeneWarps * kWarp, kSmem, a.stream>>>(
        Y, a.W, a.muL, a.bp, a.ct, a.part, a.N, a.G, a.Kf, a.nA2, a.SC, a.rows_per_chunk,
        a.plan.n_pad, vec);
  });
}

// The wide forward's column groups are JW = 16 or 32 wide: 16 when Z's SC
// columns and the Y products' Kf + nA2 fit in 16, else 32 (a narrower group
// has more cells a block, the same 8 outputs a thread).
template <int YT>
void forward_wide_typed(const FwdArgs& a) {
  using Elem = typename YStore<YT>::Elem;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  auto launch = [&](auto jw) {
    constexpr int JW = decltype(jw)::value, TN = kWideThreads * kWideOut / JW;
    const int nZ = (a.SC + JW - 1) / JW;
    const int nY = a.Kf + a.nA2 > JW ? (a.Kf + a.nA2 + JW - 1) / JW : 1;  // A1 takes one
    const dim3 grid(blocks_for(a.N, TN), nZ + nY);
    const int smem = fwd_wide_smem(a.Kf, TN);
    cudaFuncSetAttribute(fwd_wide_kernel<YT, JW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    fwd_wide_kernel<YT, JW><<<grid, kWideThreads, smem, a.stream>>>(
        Y, a.psi, a.W, a.logmu, a.muL, a.A1, a.A2, a.Z, a.YW, a.N, a.G, a.Kf, a.nA2, a.SC, nZ);
  };
  if (a.SC <= 16 && a.Kf + a.nA2 <= 16)
    launch(std::integral_constant<int, 16>{});
  else
    launch(std::integral_constant<int, 32>{});
}

template <int YT>
void gene_wide_typed(const GeneWideArgs& a) {
  using Elem = typename YStore<YT>::Elem;
  const dim3 grid(blocks_for(a.G, kGeneGenes), a.n_chunks);
  const int smem = gene_wide_smem(a.Kf, a.nA2);
  cudaFuncSetAttribute(gene_wide_kernel<YT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gene_wide_kernel<YT><<<grid, kWideThreads, smem, a.stream>>>(
      static_cast<const Elem*>(a.Y), a.psi, a.W, a.muL, a.dA1, a.dA2, a.dZ, a.part, a.N, a.G,
      a.Kf, a.nA2, a.SC, a.rows_per_chunk);
}
#endif  // FL_ANY_TYPED

#if FL_TYPED(0)
template void forward_typed<kYF32>(const FwdArgs&);
template void gene_typed<kYF32>(const GeneArgs&);
template void forward_wide_typed<kYF32>(const FwdArgs&);
template void gene_wide_typed<kYF32>(const GeneWideArgs&);
#endif
#if FL_TYPED(1)
template void forward_typed<kYBF16>(const FwdArgs&);
template void gene_typed<kYBF16>(const GeneArgs&);
template void forward_wide_typed<kYBF16>(const FwdArgs&);
template void gene_wide_typed<kYBF16>(const GeneWideArgs&);
#endif
#if FL_TYPED(2)
template void forward_typed<kYI16>(const FwdArgs&);
template void gene_typed<kYI16>(const GeneArgs&);
template void forward_wide_typed<kYI16>(const FwdArgs&);
template void gene_wide_typed<kYI16>(const GeneWideArgs&);
#endif
#if FL_TYPED(3)
template void forward_typed<kYI8>(const FwdArgs&);
template void gene_typed<kYI8>(const GeneArgs&);
template void forward_wide_typed<kYI8>(const FwdArgs&);
template void gene_wide_typed<kYI8>(const GeneWideArgs&);
#endif

}  // namespace fl

#if FL_COMMON
extern "C" {

// Y (N,G) is a device pointer to a contiguous array of the storage type
// y_type (0 float32, 1 bfloat16, 2 int16, 3 int8); every other pointer is a
// device pointer to a contiguous float32 array: psi (N,Kf), W (G,Kf), logmu
// (nA2,G), muL (G,SC); outputs A1 (N), A2 (N,nA2), Z (N,SC) and YW (N,Kf) =
// Y W. nA2 == 0 skips A2 (logmu and A2 are then not read or written).
// Returns cudaGetLastError() after launch.
int fl_forward(const void* Y, const float* psi, const float* W,
               const float* logmu, const float* muL, float* A1, float* A2,
               float* Z, float* YW, int N, int G, int Kf, int nA2, int SC,
               int y_type, cudaStream_t stream) {
  if (bad_sizes(N, G, Kf, nA2, SC, 1, y_type)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream};
  switch (y_type) {
    case kYF32: forward_typed<kYF32>(a); break;
    case kYBF16: forward_typed<kYBF16>(a); break;
    case kYI16: forward_typed<kYI16>(a); break;
    default: forward_typed<kYI8>(a);
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
  if (bad_sizes(N, G, Kf, 0, SC, 1, kYF32)) return (int)cudaErrorInvalidValue;
  switch (Kf) {
    case 0: return (int)cudaSuccess;
    case 1: launch_dpsi<1>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream); break;
    case 2: launch_dpsi<2>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream); break;
    case 3: launch_dpsi<3>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream); break;
    default: launch_dpsi<4>(psi, W, muL, dA1, dZ, YW, dpsi, N, G, SC, stream);
  }
  return (int)cudaGetLastError();
}

// Floats of scratch that fl_backward_gene needs for these sizes (0 if they
// are out of range). rows_per_chunk must be a multiple of 64.
size_t fl_backward_gene_scratch(int N, int G, int Kf, int nA2, int SC, int rows_per_chunk) {
  if (bad_sizes(N, G, Kf, nA2, SC, rows_per_chunk, kYF32) || rows_per_chunk % kCellTile) return 0;
  const GenePlan p = gene_plan(N, G, Kf, nA2, SC, rows_per_chunk);
  return p.part + p.bp + p.ct;
}

// Backward, gene part. Y (in y_type), psi, W and muL as fl_forward, dA1
// (N), dA2 (N,nA2), dZ (N,SC). Output dgene (Kf+SC+nA2, G) = [dW^T;
// d(muL)^T; dlog_mu]; scratch (16-byte aligned) holds
// fl_backward_gene_scratch(...) floats. Kf == 0 runs as one zero column
// (rfe = 1).
int fl_backward_gene(const void* Y, const float* psi, const float* W,
                     const float* muL, const float* dA1, const float* dA2,
                     const float* dZ, float* scratch, float* dgene, int N, int G,
                     int Kf, int nA2, int SC, int rows_per_chunk, int y_type,
                     cudaStream_t stream) {
  if (bad_sizes(N, G, Kf, nA2, SC, rows_per_chunk, y_type) || rows_per_chunk % kCellTile)
    return (int)cudaErrorInvalidValue;
  const GenePlan p = gene_plan(N, G, Kf, nA2, SC, rows_per_chunk);
  float* part = scratch;
  float4* bp = reinterpret_cast<float4*>(scratch + p.part);
  float* ct = scratch + p.part + p.bp;
  gene_dispatch(p, nA2 > 0, [&](auto kf, auto nt, auto a2) {
    gene_pack_kernel<decltype(kf)::value, decltype(nt)::value, decltype(a2)::value>
        <<<blocks_for((long long)(p.bp / 4 + p.ct), 256), 256, 0, stream>>>(
            psi, dA1, dA2, dZ, bp, ct, N, Kf, nA2, SC, p.n_pass, p.n_pad);
  });
  const GeneArgs a{Y, W, muL, bp, ct, part, N, G, Kf, nA2, SC, rows_per_chunk, p, stream};
  switch (y_type) {
    case kYF32: gene_typed<kYF32>(a); break;
    case kYBF16: gene_typed<kYBF16>(a); break;
    case kYI16: gene_typed<kYI16>(a); break;
    default: gene_typed<kYI8>(a);
  }
  const int FG = (Kf + SC + nA2) * G;
  reduce_chunks_kernel<<<blocks_for(FG, 256), 256, 0, stream>>>(part, dgene, p.n_chunks, FG);
  return (int)cudaGetLastError();
}

// The wide family: the same arguments and outputs as fl_forward,
// fl_backward_dpsi and fl_backward_gene, for Kf <= 64, nA2 <= 64 and SC <=
// 2048; fl_backward_gene_wide's scratch holds the (Kf+SC+nA2, G) partial sums
// of each chunk of rows_per_chunk cells (a multiple of 32).
int fl_forward_wide(const void* Y, const float* psi, const float* W,
                    const float* logmu, const float* muL, float* A1, float* A2,
                    float* Z, float* YW, int N, int G, int Kf, int nA2, int SC,
                    int y_type, cudaStream_t stream) {
  if (bad_wide_sizes(N, G, Kf, nA2, SC, kGeneCells, y_type)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{Y, psi, W, logmu, muL, A1, A2, Z, YW, N, G, Kf, nA2, SC, stream};
  switch (y_type) {
    case kYF32: forward_wide_typed<kYF32>(a); break;
    case kYBF16: forward_wide_typed<kYBF16>(a); break;
    case kYI16: forward_wide_typed<kYI16>(a); break;
    default: forward_wide_typed<kYI8>(a);
  }
  return (int)cudaGetLastError();
}

int fl_backward_dpsi_wide(const float* psi, const float* W, const float* muL,
                          const float* dA1, const float* dZ, const float* YW,
                          float* dpsi, int N, int G, int Kf, int SC,
                          cudaStream_t stream) {
  if (bad_wide_sizes(N, G, Kf, 0, SC, kGeneCells, kYF32)) return (int)cudaErrorInvalidValue;
  if (Kf == 0) return (int)cudaSuccess;
  const int smem = dpsi_wide_smem(Kf);
  cudaFuncSetAttribute(dpsi_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dpsi_wide_kernel<<<blocks_for(N, kDpsiCells), kWideThreads, smem, stream>>>(
      psi, W, muL, dA1, dZ, YW, dpsi, N, G, Kf, SC);
  return (int)cudaGetLastError();
}

int fl_backward_gene_wide(const void* Y, const float* psi, const float* W,
                          const float* muL, const float* dA1, const float* dA2,
                          const float* dZ, float* scratch, float* dgene, int N, int G,
                          int Kf, int nA2, int SC, int rows_per_chunk, int y_type,
                          cudaStream_t stream) {
  if (bad_wide_sizes(N, G, Kf, nA2, SC, rows_per_chunk, y_type))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (N + rows_per_chunk - 1) / rows_per_chunk;
  const GeneWideArgs a{Y, psi, W, muL, dA1, dA2, dZ, scratch,
                       N, G, Kf, nA2, SC, rows_per_chunk, n_chunks, stream};
  switch (y_type) {
    case kYF32: gene_wide_typed<kYF32>(a); break;
    case kYBF16: gene_wide_typed<kYBF16>(a); break;
    case kYI16: gene_wide_typed<kYI16>(a); break;
    default: gene_wide_typed<kYI8>(a);
  }
  const int FG = (Kf + SC + nA2) * G;
  reduce_chunks_kernel<<<blocks_for(FG, 256), 256, 0, stream>>>(scratch, dgene, n_chunks, FG);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // FL_COMMON

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
//   log_rfe[n,g] = sum_k psi[n,k] W[g,k]
//   A1[n]        = sum_g Y[n,g] log_rfe[n,g]
//   A2[n,s]      = sum_g Y[n,g] log_mu[s,g]         (optional)
//   Z[n,j]       = sum_g exp(log_rfe[n,g]) muL[g,j] (j = s*C + c)
//   YW[n,k]      = sum_g Y[n,g] W[g,k]              (kept for dpsi)
//
// and the vector-Jacobian product: with rfe = exp(log_rfe), drfe = dZ muL^T
// and dlog_rfe = Y dA1 + rfe drfe, dpsi = dlog_rfe W, dW = dlog_rfe^T psi,
// dlog_mu = dA2^T Y and d(muL) = rfe^T dZ. Every product and sum is float64
// (the FP64 tensor cores' mma.sync f64 and the CUDA cores' DFMA), every exp
// the double exp() (no fast-math, no TF32): the kernels serve the oracle
// configuration, and their results differ from the plain float64 versions
// only by the order of their sums. One family takes every width, with
// runtime widths (as far as f64_plan's shared memory fits a block); there
// is no narrow/wide split.
//
// Design. Every kernel runs its products on the FP64 tensor cores
// (mma.sync m16n8k8 f64: wgmma has no f64 type), and the exps on the CUDA
// cores, one exp an element, each in the register where an MMA takes it:
// the forward as unnormalised attention (cells the queries, genes the
// keys, muL the values), dpsi as FlashAttention-2's dQ pass and the gene
// part as its dK/dV pass. A warp owns 16 rows (cells, or genes) and its
// sums are MMA accumulators in registers, each column group or pass a
// built count of 8-column tiles (f64_plan's counts); the block's warps
// share a ring of two shared-memory stages of the walked axis, filled by
// 16-byte cp.async while the other is consumed, with the operands in
// fragment order (one 16-byte load a lane per fragment, no bank conflict):
// fwd_f64_pack_kernel, dpsi_f64_pack_kernel and gene_f64_pack_kernel lay
// each side out so once a call, since copying operand by operand into that
// order cost more instructions than the arithmetic. Each (chunk, gene
// block) of the gene part writes its own partial sums, which
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
//    no exp, one without Y tiles (and not the first) reads no Y. Past the
//    old bound its table holds only the Y products' tiles (tiles == yt)
//    and it forms no log_rfe: Z and A1 are the split forward's (below).
//  * dpsi_f64_kernel<NK, NZ> reads no Y: dpsi = (rfe drfe) W, then dA1 YW
//    (the forward's) added last, the term order of the plain version
//    reference_dpsi. A warp owns 16 cells and walks the genes in k-steps
//    of 8 (a stage 4, or 2 where 4 would leave room for one block an SM).
//    Per k-step, at drfe's C positions (cells g, g + 8; genes 2t, 2t + 1):
//    drfe = dZ muL^T by NZ MMAs in two independent chains (dZ's A
//    fragments of the group in registers, loaded once a group), log_rfe
//    by Kf FMAs from psi's two rows and W's two genes (Kf <= 8, NK = 1) or
//    by NK MMAs psi W^T (psi's A fragments in shared memory), one exp an
//    element, t = rfe drfe, and
//    dpsi += t W by NK MMAs with t's C fragment as the A fragment (columns
//    2t, 2t + 1 as k-columns t, t + 4; W's B rows permuted to match). Up to
//    Kf 64 only: past the old bound dpsi is the split one (below).
//    dpsi_f64_pack_kernel lays the gene side out once a call: muL^T, W in
//    C-to-A order (whose tile also holds the FMAs' pairs) and, past Kf 8,
//    W^T. dZ's tiles go in groups of NZ (at most 10: S*C 80 is one group),
//    one after another in the block (dpsi is linear in drfe), each
//    recomputing log_rfe and the exps; NK tiles of [psi, X] and NZ are
//    built counts (f64_plan's d_nk, d_nz). What bounds it
//    (gene_variants.py f64_dpsi_*, int8, Kf 1, full width, H100 80GB HBM3
//    at 700 W): at S*C 10 the exps, 0.61 of 1.33 ms, at S*C 80 drfe's
//    MMAs, 1.03 of 2.82 ms, beside 0.61-0.67 of exps.
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
//    ones add), and the first pass adds Y dA1 psi. Up to the old bound
//    (Kf 64, nA2 64, SC 2,048) only: past it the gene part is the split one.
//  * The split gene part, past the old bound: dlog_rfe_f64_kernel<YT, 1> and
//    gene_product_f64_kernel<YT, YV>, in place of gene_f64_kernel's grouped
//    form, which formed rfe and drfe again in each of dW's column groups
//    (a launch each) and each pass of d(muL)'s tiles (at Kf 72, S*C 660:
//    1,066.8-1,074.8 ms against the plain VJP's 46.5-46.8; H100 80GB HBM3,
//    700 W). The float32 split backward's design in float64: over row
//    blocks of plan.rows cells (a workspace of at most 2^22 doubles a
//    buffer, half the float32 one's cells), dlog_rfe_f64_kernel forms
//    log_rfe = psi W^T, rfe = exp(log_rfe) (written to the workspace at
//    once), then drfe = dZ muL^T over all of S*C in the same accumulators
//    and dlog_rfe = rfe drfe + Y dA1; gene_product_f64_kernel takes dW^T =
//    psi^T dlog_rfe and d(muL)^T = dZ^T rfe (and dlog mu = dA2^T Y) from
//    the workspace, K the block's cells, summed over the row blocks in order
//    in the output (a single block's cells in slices whose partial sums
//    reduce_chunks_f64_kernel adds, where its grid would not fill the card
//    twice over). Tiled products: blocks of 64 x 64 outputs, 4 warps of 32
//    x 32 (2 x 4 accumulator tiles of m16n8k8 f64, 64 registers of sums),
//    stages of 16 values of K filled by cp.async into a ring of three (16
//    bytes a copy where rows allow, else 8), rows padded to 4 mod 16
//    doubles so that a fragment's reads hit every bank pair once; three
//    blocks an SM. Deterministic, no atomics. The exps (one an element,
//    ~1% of the DMMAs' work at S*C 660) run between the two products of a
//    block, beside the other blocks' DMMAs. The operands, copies, ring and
//    epilogue walk are split_tiles.cuh's, shared with the float32 split
//    kernels; the stage's DMMAs (db_stage) are this file's.
//  * The split forward and dpsi, past the old bound, in place of
//    fwd_f64_kernel's Z groups and dpsi_f64_kernel's output groups, which
//    formed log_rfe over every column of [psi, X] and the exps again in
//    each group (at Kf 72, S*C 660: 114.2-116.1 and 162.6-163.9 ms against
//    the plain versions' 22.9-23.2 and 30.5-30.7; H100 80GB HBM3, 700 W).
//    The same row blocks and workspace: dlog_rfe_f64_kernel<YT, OUT> writes
//    rfe alone (kOutRfe, the forward's) or t = rfe drfe without Y (kOutT,
//    for dpsi alone), and dpsi_product_f64_kernel takes part[z] = t[:, range
//    z] w[range z, :] over gene ranges (enough blocks to fill the last wave
//    of three an SM, f64_plan's zsplit and dsplit), which
//    dpsi_sum_f64_kernel adds in order: Z = rfe muL (w = muL; one range
//    writes Z's rows itself) and dpsi = t W + dA1 YW (w = W; dA1 YW added
//    last, reference_dpsi's order). The autograd function's backward takes
//    dpsi = dlog_rfe W from the gene part's own dlog_rfe a row block, in the
//    one call of fl64_backward_gene with dpsi. The forward's rfe kernel
//    also takes A1 = Y log_rfe from its log_rfe accumulators (a row's sums
//    over each warp's 32 genes, which reduce_chunks_f64_kernel adds in
//    order), so Y's other products (YW, A2) stay fwd_f64_kernel's, in
//    groups of Y tiles only, which form no log_rfe or exp and hold no psi
//    or W (two blocks an SM where psi's and W's 72 columns left one).
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
// each FL_PART and links the objects: FL_PART = -1 holds the Y-free kernels
// (the packing kernels, dpsi_f64_kernel, reduce_chunks_f64_kernel, the
// split forward's and dpsi's) and the C entry points (fl64_*), FL_PART = YT
// the Y-reading kernels of one Y storage type.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "split_tiles.cuh"

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
// count) over f_blocks blocks; dpsi's built counts of [psi, X]'s tiles
// (d_nk) and of dZ's tiles a group (d_nz), its d_groups groups, k-steps a
// stage and blocks; the gene part's tiles (g_st of dlog mu, g_tiles in
// all) in g_passes passes of g_count (g_nt built) beside dW's g_nk, its
// blocks of 64 genes, its chunks of rows cells and its partial sums (part
// doubles); each kernel's dynamic shared memory in bytes; and the packed
// tables' doubles (f_table the forward's, g_table the gene part's, d_table
// dpsi's).
//
// split: past Kf 64, nA2 64 or SC 2,048 the forward, dpsi and the gene part
// are the split ones: rows and n_chunks are then their row blocks, ldw the
// workspace's row pitch (doubles, even), gslices slices of gcells cells a
// row block (more than one only in a single row block: part then holds
// their partial sums), dsplit gene ranges of dgenes genes of dpsi's product
// and zsplit of zgenes of Z's; the forward's tiles are the Y products'
// alone (f_tiles == f_yt), and the d_* and other g_* numbers, d_table and
// g_table are 0.
struct Plan {
  int f_yt, f_tiles, f_count, f_nt, f_groups, f_blocks, f_smem;
  int d_nk, d_nz, d_groups, d_steps, d_blocks, d_smem;
  int g_st, g_tiles, g_nk, g_count, g_nt, g_passes, g_blocks, rows, n_chunks, g_smem;
  size_t part, f_table, g_table, d_table;
  int split, ldw, gslices, gcells, dsplit, dgenes, zsplit, zgenes;
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

// The split kernels' arguments: the workspace of one row block (rfe and
// dlog_rfe, plan.rows x plan.ldw doubles each; for the split forward rfe
// and A1's partial sums), the (Kf + SC + nA2, G) output and, where the plan
// slices the cells (gslices > 1), the slices' partial sums of it.
struct SplitArgs {
  const void* Y;  // (N, G) in the storage type
  const double *psi, *W, *muL, *dA1, *dA2, *dZ;
  double *rfe, *dl, *dgene, *gpart;
  int N, G, Kf, nA2, SC;
  Plan plan;
  cudaStream_t stream;
};

// The Y-reading kernels of one storage type, and their blocks an SM under
// the plan (which: 0 the forward, 1 the gene part: gene_f64_kernel, or
// where the plan is the split one dlog_rfe_f64_kernel<YT, 1>, 2 the split
// forward's dlog_rfe_f64_kernel<YT, 2>); the split kernels', for row block
// b: dlog_rfe_f64_kernel<YT, 1> (which 0), dlog mu's
// gene_product_f64_kernel<YT, true> (which 1) or the split forward's rfe and
// A1's partial sums, dlog_rfe_f64_kernel<YT, 2> (which 2).
template <int YT> void forward_typed(const FwdArgs& a);
template <int YT> void gene_typed(const GeneArgs& a);
template <int YT> int blocks_per_sm(int which, const Plan& p, int Kf);
template <int YT> void split_typed(const SplitArgs& a, int b, int which);

}  // namespace fl64

namespace {

using namespace fl64;

constexpr int kWarp = 32;
// dpsi_f64_kernel (ops/fused_likelihood.py's F64_DPSI_WARPS,
// F64_DPSI_K_COUNTS, F64_DPSI_Z_COUNTS, _TWO_BLOCK_SMEM): warps of 16 cells
// a block; the tile counts of [psi, X] and of dZ's group it is built for;
// the shared memory a block may take for two blocks an SM (228 KB an SM,
// 1 KB a block kept).
constexpr int kDpsiWarps = 4;
constexpr int kDpsiKCounts[] = {1, 2, 4, 8};
constexpr int kDpsiZCounts[] = {1, 2, 4, 6, 8, 10};
constexpr int kTwoBlockSmem = (228 - 2) / 2 * 1024;
// log_rfe's W^T tiles a k-step takes beside dpsi's NK (none at NK = 1,
// where the FMAs read W's pairs from dpsi's tile).
__host__ __device__ constexpr int dpsi_lr_tiles(int nk) { return nk > 1 ? nk : 0; }
// drfe's MMAs go to this many independent accumulators (tile z to z mod
// chains), added last, so that its chain of dependent MMAs is shorter; the
// k-steps of a stage are unrolled by two where the registers allow it, so
// that one k-step's exps run beside the other's MMAs. (gene_variants.py on
// an H100 80GB HBM3 at 700 W, int8, Kf 1, full width: two chains 3.98 ->
// 3.31 ms at S*C 80, four no better; unrolling 2-3% at S*C 10.)
__host__ __device__ constexpr int dpsi_chains(int nz) { return nz >= 2 ? 2 : 1; }
__host__ __device__ constexpr int dpsi_step_unroll(int nk, int nz) { return nk + nz <= 6 ? 2 : 1; }
// Blocks an SM: at least 3 for every NK = 1 instantiation (S*C 80: 2.82 ms
// against 3.30 at 2, the same card; no spill), 4 where NK + NZ <= 3, 2
// where the fragments held need more room.
__host__ __device__ constexpr int dpsi_min_blocks(int nk, int nz) {
  return nk + nz <= 3 ? 4 : nk + nz <= 6 || nk == 1 ? 3 : 2;
}
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
constexpr int kMaxWidth = 1 << 20;  // any width whose indices fit an int
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

// cp_async_zfill of kBytes (8 or 16) from src, or of kBytes of zeros where
// src is null (then `dummy`, a valid address, is named and not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, const void* dummy) {
  cp_async_zfill<kBytes>(dst, src ? src : dummy, src ? kBytes : 0);
}

#if F64_ANY_TYPED
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
// idle) of [Y W | Y log mu^T] (yt tiles) then Z (tiles in all). Past the old
// bound (a1 false) there are no Z tiles (tiles == yt) and no A1, which the
// split forward's rfe kernel takes from its log_rfe: the kernel forms no
// log_rfe and holds no psi or W (klr = 0). Dynamic shared memory: the
// warps' psi ([warp][k][g] pairs of rows g, g + 8; klr columns), then two
// stages, each the group's B fragments ([k-step][tile][lane] pairs), W
// ([k-step][k][t] pairs of genes 8t + 2ks, + 1; klr columns) and the warps'
// Y rows.
// ---------------------------------------------------------------------------
template <int YT, int NT>
__global__ void __launch_bounds__(kFwdWarps * kWarp, NT >= 8 ? 2 : NT >= 4 ? 3 : 4)
fwd_f64_kernel(const typename Y64<YT>::Elem* __restrict__ Y, const double* __restrict__ psi,
               const double* __restrict__ W, const double* __restrict__ logmu,
               const double* __restrict__ muL, double* __restrict__ A1, double* __restrict__ A2,
               double* __restrict__ Z, double* __restrict__ YW,
               const double2* __restrict__ table, int N, int G, int Kf, int nA2, int SC, int yt,
               int tiles, int count, bool a1, bool vec) {
  using Row = FwdRow<YT>;
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kFwdWarps + warp) * 16;
  const int n0 = row0 + g, n1 = n0 + 8;
  const int klr = a1 ? Kf : 0;  // log_rfe's columns
  const int tile0 = blockIdx.y * count, nt = min(count, tiles - tile0);
  const int ny = max(0, min(nt, yt - tile0));  // the group's Y-product tiles (its first)
  const bool first = blockIdx.y == 0 && a1;
  const bool with_exp = nt > ny, with_lr = with_exp || first, with_y = ny > 0 || first;
  double2* s_psi = reinterpret_cast<double2*>(s_dyn);
  unsigned char* s_stage = s_dyn + (size_t)kFwdWarps * 16 * klr * 8;
  const int tab_bytes = kFwdSteps * NT * kWarp * 16, w_bytes = kFwdSteps * klr * 4 * 16;
  const int stage_bytes = tab_bytes + w_bytes + kFwdYStageBytes;

  // psi of the warp's rows, in pairs (row g, row g + 8); read after the
  // first stage's barrier
  for (int i = lane; i < 16 * klr; i += kWarp) {
    const int k = i / 16, r = i % 16, n = row0 + (r >> 1) + 8 * (r & 1);
    reinterpret_cast<double*>(s_psi)[warp * klr * 16 + i] = n < N ? psi[(size_t)n * Kf + k] : 0.0;
  }

  // cp.async of stage s (genes [32 s, 32 s + 32)) into buffer buf: for each
  // k-step the group's tiles and W's pairs, contiguous in the packed table
  const int per_ks = tiles * kWarp + klr * 4;
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
        for (int i = threadIdx.x; i < klr * 4; i += blockDim.x)
          cp_async<16>(sw + ks * klr * 4 + i, src + ks * per_ks + tiles * kWarp + i, src);
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
        const double2* pp = s_psi + warp * klr * 8 + g;
        const double2* pw = sw + ks * klr * 4 + t;
        for (int k = 0; k < klr; ++k) {
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

// ---------------------------------------------------------------------------
// The split gene part, past the old bound (see the note at the top): tiled
// products on the FP64 tensor cores over row blocks of plan.rows cells.
// ---------------------------------------------------------------------------
constexpr int kDbM = 64, kDbN = 64, kDbK = 16;  // a block's tile of outputs, and K a stage
constexpr int kDbThreads = 4 * kWarp;            // 2 x 2 warps of 32 x 32 outputs
constexpr int kDbStages = 3;                     // the cp.async ring
// Row pitches (doubles) of a stage's tiles, whose rows hold K, M or N
// values: 4 mod 16, so that the 16 lanes of each half of a fragment's read
// hit 16 different pairs of banks.
constexpr int kDbPitchK = kDbK + 4, kDbPitchM = kDbM + 4, kDbPitchN = kDbN + 4;
// A stage's doubles: dlog_rfe_f64_kernel's cell and gene tiles (rows of K
// values); gene_product_f64_kernel's cell side and workspace (or Y) tile
// (rows of M, of N values); dpsi_product_f64_kernel's workspace tile and
// w's (rows of K, of N values).
constexpr int kDbStageDlog = (kDbM + kDbN) * kDbPitchK;
constexpr int kDbStageGene = kDbK * (kDbPitchM + kDbPitchN);
constexpr int kDbStageDpsi = kDbM * kDbPitchK + kDbK * kDbPitchN;
constexpr int db_smem(int stage_doubles) { return 8 * kDbStages * stage_doubles; }
// The operands and jobs of split_tiles.cuh, in doubles.
using DbMat = TileMat<double>;
using DbJob = TileJob<double>;
using DbJobs = TileJobs<double>;

// acc += A B over one stage's kDbK values of K for the warp's 32 x 32 part
// of the block's tile (2 x 4 tiles of m16n8k8): A's (m, k) in sa (rows of
// PA values of K, or where A_KROWS of M), B's (k, n) from bval.
template <bool A_KROWS, int PA, class BVal>
__device__ __forceinline__ void db_stage(const double* sa, BVal&& bval, double (&acc)[2][4][4]) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp / 2), wn = 32 * (warp % 2);
  auto a = [&](int m, int k) { return A_KROWS ? sa[k * PA + m] : sa[m * PA + k]; };
#pragma unroll
  for (int kk = 0; kk < kDbK; kk += 8) {
    double af[2][4];
    double2 bf[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = wm + 16 * i + g, k = kk + t;
      af[i][0] = a(m, k);
      af[i][1] = a(m + 8, k);
      af[i][2] = a(m, k + 4);
      af[i][3] = a(m + 8, k + 4);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn + 8 * j + g;
      bf[j] = make_double2(bval(kk + t, n), bval(kk + t + 4, n));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dmma(acc[i][j], af[i], bf[j]);
  }
}

// What dlog_rfe_f64_kernel writes beside rfe: t = rfe drfe (kOutT, for
// dpsi alone), dlog_rfe = rfe drfe + Y dA1 (kOutDlog, with Y), or A1's
// partial sums (kOutRfe, the split forward's, with Y).
constexpr int kOutT = 0, kOutDlog = 1, kOutRfe = 2;

// A row block's rfe = exp(psi W^T) and, as OUT says, dlog_rfe = rfe drfe +
// Y dA1 or t = rfe drfe, drfe = dZ muL^T: grid (tiles of kDbN genes, tiles
// of kDbM cells). log_rfe is formed first, its exps stored to rfe at once,
// then drfe in the same accumulators (rfe may be dl: each thread reads back
// only the rfe it wrote). kOutRfe forms no drfe: its dl holds A1's partial
// sums of Y log_rfe, each row's over each warp's 32 genes (partial 2
// blockIdx.x + its column half, the partials rows apart), which
// reduce_chunks_f64_kernel adds in order. Rows of psi, dZ, Y and dA1 are
// the block's.
template <int YT, int OUT>
__global__ void __launch_bounds__(kDbThreads, 3)
dlog_rfe_f64_kernel(const typename Y64<YT>::Elem* __restrict__ Y, const double* __restrict__ dA1,
                    DbMat psi, DbMat W, DbMat dZ, DbMat muL, double* rfe, double* dl,
                    long long ldw) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  double* smem = reinterpret_cast<double*>(s_dyn);
  const int m0 = blockIdx.y * kDbM, n0 = blockIdx.x * kDbN;  // the tile's first cell and gene
  const int rows = psi.rows, G = W.rows;
  double acc[2][4][4];
  auto product = [&](const DbMat& a, const DbMat& b) {  // acc = a b^T over a's columns
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
    tile_mainloop<kDbStages>(
        (a.cols + kDbK - 1) / kDbK,
        [&](int kt, int buf) {
          double* st = smem + buf * kDbStageDlog;
          tile_load<kDbThreads, kDbM, kDbK, kDbPitchK>(st, a, m0, kt * kDbK);
          tile_load<kDbThreads, kDbN, kDbK, kDbPitchK>(st + kDbM * kDbPitchK, b, n0, kt * kDbK);
        },
        [&](int buf) {
          const double* st = smem + buf * kDbStageDlog;
          const double* sb = st + kDbM * kDbPitchK;
          db_stage<false, kDbPitchK>(st, [&](int k, int n) { return sb[n * kDbPitchK + k]; }, acc);
        });
  };
  product(psi, W);
  double a1[2][2] = {};  // kOutRfe: the thread's rows' sums of Y log_rfe over its columns
  tile_each_pair<kDbThreads>([&](int r, int c, int i, int j, int h) {
    const int n = m0 + r, g = n0 + c;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (n >= rows || g + u >= G) continue;
      const double lr = acc[i][j][2 * h + u];
      rfe[n * ldw + g + u] = exp(lr);
      if constexpr (OUT == kOutRfe)
        a1[i][h] = fma(y_to_double<YT>(Y[(long long)n * G + g + u]), lr, a1[i][h]);
    }
  });
  if constexpr (OUT == kOutRfe) {  // the quad's sums of a row, in a fixed order
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    const long long q = 2 * blockIdx.x + warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double v = a1[i][h];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        const int n = m0 + 32 * (warp / 2) + 16 * i + (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && n < rows) dl[q * rows + n] = v;
      }
  } else {
    product(dZ, muL);
    tile_each_pair<kDbThreads>([&](int r, int c, int i, int j, int h) {
      const int n = m0 + r, g = n0 + c;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (n >= rows || g + u >= G) continue;
        double v = rfe[n * ldw + g + u] * acc[i][j][2 * h + u];
        if constexpr (OUT == kOutDlog)
          v = fma(y_to_double<YT>(Y[(long long)n * G + g + u]), dA1[n], v);
        dl[n * ldw + g + u] = v;
      }
    });
  }
}

// The gene-side products of a row block: grid (tiles of kDbN genes, the
// first job's m_tiles then the second's tiles of kDbM rows f, slices of
// zcells cells), K the slice's cells. YV: v is Y (the block's rows, in its
// storage type, converted into the stage), else the jobs' own v. Slice z
// writes out + z zstride, the first row block's (first) or adds to it, in
// order.
template <int YT, bool YV>
__global__ void __launch_bounds__(kDbThreads, 3)
gene_product_f64_kernel(DbJobs jobs, const typename Y64<YT>::Elem* __restrict__ Y, int G,
                        bool first, int zcells, long long zstride) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  double* smem = reinterpret_cast<double*>(s_dyn);
  constexpr int kA = kDbK * kDbPitchM;
  const int second = (int)blockIdx.y >= jobs.job[0].m_tiles;
  const DbJob& job = jobs.job[second];
  const int m0 = ((int)blockIdx.y - (second ? jobs.job[0].m_tiles : 0)) * kDbM;
  const int n0 = blockIdx.x * kDbN;
  const int c0 = blockIdx.z * zcells;  // the slice's cells
  const int rows = min(zcells, job.x.rows - c0);
  DbMat x = job.x, v = job.v;
  x.p += c0 * x.ld;
  x.rows = rows;
  v.p += c0 * v.ld;
  v.rows = rows;
  double acc[2][4][4] = {};
  tile_mainloop<kDbStages>(
      (rows + kDbK - 1) / kDbK,
      [&](int kt, int buf) {
        double* st = smem + buf * kDbStageGene;
        tile_load<kDbThreads, kDbK, kDbM, kDbPitchM>(st, x, kt * kDbK, m0);
        if constexpr (YV) {  // the threads' own loads, visible after the ring's barrier
          for (int i = threadIdx.x; i < kDbK * kDbN; i += kDbThreads) {
            const int r = i / kDbN, c = i % kDbN, n = kt * kDbK + r, g = n0 + c;
            st[kA + r * kDbPitchN + c] =
                n < rows && g < G ? y_to_double<YT>(Y[(long long)(c0 + n) * G + g]) : 0.0;
          }
        } else {
          tile_load<kDbThreads, kDbK, kDbN, kDbPitchN>(st + kA, v, kt * kDbK, n0);
        }
      },
      [&](int buf) {
        const double* st = smem + buf * kDbStageGene;
        const double* sv = st + kA;
        db_stage<true, kDbPitchM>(st, [&](int k, int n) { return sv[k * kDbPitchN + n]; }, acc);
      });
  double* out = job.out + blockIdx.z * zstride;
  tile_each_pair<kDbThreads>([&](int r, int c, int i, int j, int h) {
    const int f = m0 + r, g = n0 + c;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (f >= x.cols || g + u >= G) continue;
      double* o = out + (long long)f * G + g + u;
      *o = first ? acc[i][j][2 * h + u] : *o + acc[i][j][2 * h + u];
    }
  });
}

#if F64_COMMON
// part[z][n][k] = sum over genes [z genes, (z + 1) genes) of t[n, g] w[g, k]
// for a row block's cells n: grid (tiles of kDbM cells, tiles of kDbN
// columns of w, ranges of genes), K the range's genes. The split dpsi's t W
// (or the joint backward's dlog_rfe W; w = W, dsplit ranges) and the split
// forward's Z = rfe muL (w = muL, zsplit ranges; with one range part is Z's
// rows of the block). Range z starts at a whole number of 32 genes, so t's
// copies stay 16-byte aligned; w's are where its width is even.
__global__ void __launch_bounds__(kDbThreads, 3)
dpsi_product_f64_kernel(DbMat t, DbMat w, double* __restrict__ part, long long zstride,
                        int genes) {
  extern __shared__ __align__(16) unsigned char s_dyn[];
  double* smem = reinterpret_cast<double*>(s_dyn);
  constexpr int kA = kDbM * kDbPitchK;
  const int z = blockIdx.z, g0 = z * genes;
  DbMat a = t, b = w;  // the range's genes
  a.p += g0;
  a.cols = min(genes, t.cols - g0);
  b.p += (long long)g0 * w.ld;
  b.rows = min(genes, w.rows - g0);
  const int m0 = blockIdx.x * kDbM, n0 = blockIdx.y * kDbN;
  double acc[2][4][4] = {};
  tile_mainloop<kDbStages>(
      (a.cols + kDbK - 1) / kDbK,
      [&](int kt, int buf) {
        double* st = smem + buf * kDbStageDpsi;
        tile_load<kDbThreads, kDbM, kDbK, kDbPitchK>(st, a, m0, kt * kDbK);
        tile_load<kDbThreads, kDbK, kDbN, kDbPitchN>(st + kA, b, kt * kDbK, n0);
      },
      [&](int buf) {
        const double* st = smem + buf * kDbStageDpsi;
        const double* sw = st + kA;
        db_stage<false, kDbPitchK>(st, [&](int k, int n) { return sw[k * kDbPitchN + n]; }, acc);
      });
  const int cols = w.cols;
  tile_each_pair<kDbThreads>([&](int r, int c, int i, int j, int h) {
    const int n = m0 + r, k = n0 + c;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (n < t.rows && k + u < cols)
        part[z * zstride + (long long)n * cols + k + u] = acc[i][j][2 * h + u];
  });
}

// out = the ranges' sums of part (a row block's rows x cols values, range
// z at z zstride) added in order, then dA1 YW (dpsi alone: YW given, t's
// rows; not for the joint backward, whose dlog_rfe had Y dA1, nor for Z).
__global__ void dpsi_sum_f64_kernel(const double* __restrict__ part,
                                    const double* __restrict__ dA1,
                                    const double* __restrict__ YW, double* __restrict__ out,
                                    int rows, int cols, int nsplit, long long zstride) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  double s = 0.0;
  for (int z = 0; z < nsplit; ++z) s += part[z * zstride + i];
  out[i] = YW ? fma(dA1[i / cols], YW[i], s) : s;
}

// The forward's gene side, once a call, in the order its stages take it:
// for each stage of 32 genes and each of its 4 k-steps, the B fragment
// pairs of every tile ([tile][lane]: genes 8t + 2ks and 8t + 2ks + 1 at
// column 8 tile + g of [W | log mu^T] (yt tiles), then of muL), then W's
// pairs for log_rfe ([k][t], the same genes; klr columns: Kf, or none past
// the old bound). Zero past G and every width.
__global__ void fwd_f64_pack_kernel(const double* __restrict__ W, const double* __restrict__ logmu,
                                    const double* __restrict__ muL, double2* __restrict__ table,
                                    int G, int Kf, int nA2, int SC, int yt, int tiles, int klr,
                                    long long n) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int per_ks = tiles * kWarp + klr * 4, r = (int)(e % per_ks);
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
// (nk tiles; [kt][lane]: psi at those cells, column 8 kt + g) and psi's
// for log_rfe
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

// dpsi_f64_kernel's gene side, once a call, in the order its stages take it:
// for each k-step of 8 genes, `tiles` B fragment tiles of 32 lane pairs:
// muL^T for drfe (nz_all tiles, every group's in turn; lane (g, t): gene g
// of the k-step at columns 8 tile + t and + 4), W for dpsi += t W (nk
// tiles, the k-step's genes in C-to-A order; lane (g, t): genes 2t and 2t
// + 1 at column 8 kc + g, so entry 4k + t of the first tile is also the
// pair log_rfe's FMAs take at column k; every output group's in turn) and,
// past Kf 8, W^T for log_rfe (the rest of the k-step's tiles; lane (g, t):
// gene g at columns 8 kc + t and + 4). Zero past G and every width.
__global__ void dpsi_f64_pack_kernel(const double* __restrict__ W, const double* __restrict__ muL,
                                     double2* __restrict__ table, int G, int Kf, int SC,
                                     int nz_all, int nk, int tiles, long long n) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int l = (int)(e % kWarp), r = (int)(e / kWarp % tiles), ks = (int)(e / kWarp / tiles);
  const int g = l >> 2, t = l & 3;
  double v0 = 0.0, v1 = 0.0;
  if (r < nz_all) {
    const int gene = 8 * ks + g, j = 8 * r + t;
    if (gene < G && j < SC) v0 = muL[(size_t)gene * SC + j];
    if (gene < G && j + 4 < SC) v1 = muL[(size_t)gene * SC + j + 4];
  } else if (r < nz_all + nk) {
    const int gene = 8 * ks + 2 * t, k = 8 * (r - nz_all) + g;
    if (gene < G && k < Kf) v0 = W[(size_t)gene * Kf + k];
    if (gene + 1 < G && k < Kf) v1 = W[(size_t)(gene + 1) * Kf + k];
  } else {
    const int gene = 8 * ks + g, k = 8 * (r - nz_all - nk) + t;
    if (gene < G && k < Kf) v0 = W[(size_t)gene * Kf + k];
    if (gene < G && k + 4 < Kf) v1 = W[(size_t)gene * Kf + k + 4];
  }
  table[e] = make_double2(v0, v1);
}

// ---------------------------------------------------------------------------
// dpsi (reads no Y; FlashAttention-2's dQ pass in float64, cells as M):
// dpsi = dA1 YW + (rfe drfe) W, drfe = dZ muL^T, rfe = exp(psi W^T). Block
// of kDpsiWarps x 16 cells; dZ's tiles in `groups` groups of NZ, one after
// another, each walking the genes in stages of `steps` k-steps of 8 (the
// padded table's; genes past G are zeros and add nothing). NK tiles of
// [psi, X]'s columns (at most 8: up to Kf 64). Dynamic shared memory: each
// warp's psi (NK == 1: [k][g] pairs of rows g, g + 8 for k < 8; else A
// fragments [kc][half][lane], half 1 the columns + 4), then two stages of
// `steps` k-steps of [the group's NZ muL^T tiles | NK W tiles | LR W^T tiles
// where NK > 1][lane] pairs.
// ---------------------------------------------------------------------------
template <int NK, int NZ>
__global__ void __launch_bounds__(kDpsiWarps * kWarp, dpsi_min_blocks(NK, NZ))
dpsi_f64_kernel(const double* __restrict__ psi, const double* __restrict__ dZ,
                const double* __restrict__ dA1, const double* __restrict__ YW,
                const double2* __restrict__ table, double* __restrict__ dpsi, int N, int G, int Kf,
                int SC, int groups, int steps) {
  constexpr int LR = dpsi_lr_tiles(NK);  // log_rfe's W^T tiles
  constexpr int RW = NZ + NK + LR;       // tiles a k-step of a stage
  extern __shared__ __align__(16) unsigned char s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (blockIdx.x * kDpsiWarps + warp) * 16, n0 = row0 + g, n1 = n0 + 8;
  const int tab_tiles = groups * NZ + NK + LR;  // a k-step's in the table
  double2* s_psi = reinterpret_cast<double2*>(s_dyn) + warp * 2 * NK * kWarp;
  double2* s_stage = reinterpret_cast<double2*>(s_dyn) + kDpsiWarps * 2 * NK * kWarp;

  // psi of the warp's rows (read after the first stage's barrier)
  if constexpr (NK == 1) {
    for (int i = lane; i < 64; i += kWarp) {
      const int k = i >> 3, m0 = row0 + (i & 7), m1 = m0 + 8;
      s_psi[i] = make_double2(m0 < N && k < Kf ? psi[(size_t)m0 * Kf + k] : 0.0,
                              m1 < N && k < Kf ? psi[(size_t)m1 * Kf + k] : 0.0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2 * NK; ++i) {
      const int k = 8 * (i >> 1) + t + 4 * (i & 1);
      s_psi[i * kWarp + lane] = make_double2(n0 < N && k < Kf ? psi[(size_t)n0 * Kf + k] : 0.0,
                                             n1 < N && k < Kf ? psi[(size_t)n1 * Kf + k] : 0.0);
    }
  }

  double acc[NK][4];
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[kc][e] = 0.0;
  const int stage_tiles = steps * RW * kWarp;
  const int n_stages = (G + 8 * steps - 1) / (8 * steps);
  // No early exit: every warp takes part in the block's barriers; rows past
  // N compute on zeros and write nothing.
#pragma unroll 1
  for (int grp = 0; grp < groups; ++grp) {
    // dZ's A fragments of the group's tiles: (n0, j), (n1, j), (n0, j + 4),
    // (n1, j + 4), j = 8 tile + t; zero past N and S*C
    double az[NZ][4];
#pragma unroll
    for (int z = 0; z < NZ; ++z) {
      const int j0 = 8 * (grp * NZ + z) + t, j1 = j0 + 4;
      az[z][0] = n0 < N && j0 < SC ? dZ[(size_t)n0 * SC + j0] : 0.0;
      az[z][1] = n1 < N && j0 < SC ? dZ[(size_t)n1 * SC + j0] : 0.0;
      az[z][2] = n0 < N && j1 < SC ? dZ[(size_t)n0 * SC + j1] : 0.0;
      az[z][3] = n1 < N && j1 < SC ? dZ[(size_t)n1 * SC + j1] : 0.0;
    }
    // cp.async of stage s (k-steps [steps s, steps (s + 1))) into buffer
    // buf: each k-step's group tiles of muL^T, then its W tiles
    auto stage = [&](int s, int buf) {
      double2* dst = s_stage + (size_t)buf * stage_tiles;
      for (int i = threadIdx.x; i < stage_tiles; i += blockDim.x) {
        const int l = i % kWarp, r = i / kWarp % RW, ks = i / (kWarp * RW);
        const int tile = r < NZ ? grp * NZ + r : groups * NZ + r - NZ;
        cp_async<16>(dst + i, table + ((size_t)(s * steps + ks) * tab_tiles + tile) * kWarp + l,
                     table);
      }
      cp_async_commit();
    };
    __syncthreads();  // the previous group is done with the ring
    stage(0, 0);
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s) {
      const int buf = s & 1;
      cp_async_wait_all();
      __syncthreads();  // the stage has landed, and the other buffer is free
      if (s + 1 < n_stages) stage(s + 1, buf ^ 1);
      const double2* tab = s_stage + (size_t)buf * stage_tiles;
      constexpr int kUnroll = dpsi_step_unroll(NK, NZ);
#pragma unroll kUnroll
      for (int ks = 0; ks < steps; ++ks) {
        const double2* b = tab + ks * RW * kWarp;
        // drfe and log_rfe at C positions (n0, 2t), (n0, 2t + 1), (n1, 2t),
        // (n1, 2t + 1) of the k-step's genes
        constexpr int NC = dpsi_chains(NZ);
        double dc[NC][4], dr[4], lr[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) dc[c][e] = 0.0;
#pragma unroll
        for (int z = 0; z < NZ; ++z) dmma(dc[z % NC], az[z], b[z * kWarp + lane]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dr[e] = dc[0][e];
#pragma unroll
          for (int c = 1; c < NC; ++c) dr[e] += dc[c][e];
        }
        if constexpr (NK == 1) {  // W's pairs (genes 2t, 2t + 1) at column k: entry 4k + t
          const double2* pw = b + NZ * kWarp + t;
          for (int k = 0; k < Kf; ++k) {
            const double2 p = s_psi[8 * k + g], w = pw[4 * k];
            lr[0] = fma(p.x, w.x, lr[0]);
            lr[1] = fma(p.x, w.y, lr[1]);
            lr[2] = fma(p.y, w.x, lr[2]);
            lr[3] = fma(p.y, w.y, lr[3]);
          }
        } else {
#pragma unroll
          for (int kc = 0; kc < LR; ++kc) {
            const double2 lo = s_psi[2 * kc * kWarp + lane];
            const double2 hi = s_psi[(2 * kc + 1) * kWarp + lane];
            const double a[4] = {lo.x, lo.y, hi.x, hi.y};
            dmma(lr, a, b[(NZ + NK + kc) * kWarp + lane]);
          }
        }
        double tv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[e] = exp(lr[e]) * dr[e];  // rfe drfe
        // the C fragment as the A fragment: columns 2t, 2t + 1 as k-columns
        // t, t + 4 (the W tiles' B rows hold genes 2t, 2t + 1)
        const double ta[4] = {tv[0], tv[2], tv[1], tv[3]};
#pragma unroll
        for (int kc = 0; kc < NK; ++kc) dmma(acc[kc], ta, b[(NZ + kc) * kWarp + lane]);
      }
    }
  }

  // C (n0, 8 kc + 2t), (n0, + 1), (n1, 8 kc + 2t), (n1, + 1); dA1 YW last
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? n0 : n1, k = 8 * kc + 2 * t + (e & 1);
      if (n < N && k < Kf)
        dpsi[(size_t)n * Kf + k] = fma(dA1[n], YW[(size_t)n * Kf + k], acc[kc][e]);
    }
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
// ops/fused_likelihood.py's f64_fwd_smem, f64_dpsi_smem, f64_gene_smem).
inline long long fwd_smem(int klr, int nt) {  // klr: log_rfe's columns (none past the old bound)
  return 8LL * (kFwdWarps * 16 * klr + 2LL * kFwdGenes * (8 * nt + klr)) + 2LL * kFwdYStageBytes;
}
inline long long dpsi_smem(int nk, int nz, int steps) {
  return 16LL * kWarp * (kDpsiWarps * 2 * nk + 2LL * steps * (nz + nk + dpsi_lr_tiles(nk)));
}
inline long long gene_smem(int Kf, int nt, int nk) {
  return 8LL * (kGeneWarps * 16 * Kf + 2LL * (kGeneCells * (16LL * nt + 8 * nk + Kf) + kGeneCells)) +
         2LL * kGeneYStageBytes;
}

// The packed tables, in doubles: the forward's gene side (fwd_f64_pack_kernel),
// the gene part's cell side (gene_f64_pack_kernel) and dpsi's gene side
// (dpsi_f64_pack_kernel: for every k-step of the stages that cover G, its
// tiles of 32 pairs).
inline long long fwd_table(int G, int klr, int tiles) {
  return 2LL * cdiv(G, kFwdGenes) * kFwdSteps * (tiles * kWarp + klr * 4);
}
inline long long gene_table(int N, int Kf, int tiles, int nk) {
  return 2LL * cdiv(N, kGeneCells) *
         (kGeneTiles * ((2LL * tiles + nk) * kWarp + Kf * 4) + kGeneCells / 2);
}

inline int dpsi_tiles(int nk, int nz, int groups) {
  return groups * nz + nk + dpsi_lr_tiles(nk);
}
inline long long dpsi_table(int G, int nk, int nz, int groups, int steps) {
  return 2LL * cdiv(G, 8 * steps) * steps * dpsi_tiles(nk, nz, groups) * kWarp;
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
  return N < 1 || G < 1 || Kf < 0 || Kf > kMaxWidth || nA2 < 0 || nA2 > kMaxWidth || SC < 1 ||
         SC > kMaxWidth || y_type < kYF64 || y_type > kYI8;
}

// The plan ops/fused_likelihood.py's f64_plan made (its F64_PLAN_KEYS, in
// order), or false where a number does not fit these sizes: the forward's
// tiles of each width (past the old bound the Y products' alone, at least
// one), split evenly into groups each the least built count that holds
// them, grid.y within 65535, the blocks covering the cells, its shared
// memory its layout's and within the card's, and the room of its packed
// table. Within the old bound, dpsi's built counts the least that hold
// [psi, X] and an even split of dZ's tiles into its groups, its k-steps a
// stage 4 unless that leaves room for one block an SM, its blocks, shared
// memory and table likewise; the gene part's tiles split evenly into
// passes each the least built count that holds them beside dW's built
// count, the blocks covering the genes, the chunks whole stages covering
// the cells with grid.y within 65535, its shared memory and the room of the
// partial sums and of its packed table. Past it (split) dpsi's and the
// gene part's grouped keys 0, row blocks that hold every cell once, each
// within grid.y's 65535 tiles, the workspace's row pitch a whole number of
// 16 bytes of at least G, slices of cells (of 32) that hold every cell of
// the one row block once, or one slice a row block, with room for their
// partial sums, and each product's gene ranges (of 32) holding every gene
// once.
constexpr int kPlanKeys = 35;
bool plan_of(const long long* v, int N, int G, int Kf, int nA2, int SC, Plan& p) {
  for (int i = 0; i < kPlanKeys; ++i)
    if (v[i] < 0 || ((i < 23 || i > 26) && v[i] > 0x7fffffff)) return false;
  p.f_yt = (int)v[0], p.f_tiles = (int)v[1], p.f_count = (int)v[2], p.f_nt = (int)v[3];
  p.f_groups = (int)v[4], p.f_blocks = (int)v[5], p.f_smem = (int)v[6];
  p.d_nk = (int)v[7], p.d_nz = (int)v[8], p.d_groups = (int)v[9], p.d_steps = (int)v[10];
  p.d_blocks = (int)v[11], p.d_smem = (int)v[12];
  p.g_st = (int)v[13], p.g_tiles = (int)v[14], p.g_nk = (int)v[15], p.g_count = (int)v[16];
  p.g_nt = (int)v[17], p.g_passes = (int)v[18], p.g_blocks = (int)v[19], p.rows = (int)v[20];
  p.n_chunks = (int)v[21], p.g_smem = (int)v[22];
  p.part = (size_t)v[23], p.f_table = (size_t)v[24], p.g_table = (size_t)v[25];
  p.d_table = (size_t)v[26];
  p.split = (int)v[27], p.ldw = (int)v[28], p.gslices = (int)v[29], p.gcells = (int)v[30];
  p.dsplit = (int)v[31], p.dgenes = (int)v[32], p.zsplit = (int)v[33], p.zgenes = (int)v[34];
  const long long F = (long long)Kf + SC + nA2, zt = cdiv(SC, 8);
  const bool split = p.split == 1;
  constexpr int kFwdCounts = sizeof(kFwdTileCounts) / sizeof(int);
  const bool fwd =
      (split ? p.f_yt == (Kf + nA2 ? cdiv(Kf + nA2, 8) : 1) && p.f_tiles == p.f_yt
             : p.split == 0 && p.f_yt == cdiv(Kf + nA2, 8) && p.f_tiles == p.f_yt + zt) &&
      p.f_groups == cdiv(p.f_tiles, kFwdTileCounts[kFwdCounts - 1]) && p.f_groups <= 65535 &&
      p.f_count == cdiv(p.f_tiles, p.f_groups) &&
      p.f_nt == least_count(kFwdTileCounts, kFwdCounts, p.f_count) && p.f_nt >= p.f_count &&
      p.f_blocks == cdiv(N, 16 * kFwdWarps) && p.f_smem == fwd_smem(split ? 0 : Kf, p.f_nt) &&
      p.f_smem <= kMaxSmem && p.f_table >= (size_t)fwd_table(G, split ? 0 : Kf, p.f_tiles);
  if (!fwd) return false;
  // a product's gene ranges: whole stages of 32 that hold every gene once
  auto ranges = [&](int n, int genes) {
    return n >= 1 && n <= 65535 && genes >= 32 && genes % 32 == 0 &&
           (long long)n * genes >= G && (long long)(n - 1) * genes < G;
  };
  if (split) {
    const long long keys = (long long)p.d_nk + p.d_nz + p.d_groups + p.d_steps + p.d_blocks +
                           p.d_smem + (long long)p.d_table + p.g_st + p.g_tiles + p.g_nk +
                           p.g_count + p.g_nt + p.g_passes + p.g_blocks + p.g_smem +
                           (long long)p.g_table;
    return keys == 0 && p.rows >= 1 && p.n_chunks >= 1 && (long long)p.n_chunks * p.rows >= N &&
           (long long)(p.n_chunks - 1) * p.rows < N && cdiv(p.rows, kDbM) <= 65535 &&
           p.ldw >= G && p.ldw % 2 == 0 && cdiv(Kf, kDbM) + cdiv(SC, kDbM) <= 65535 &&
           cdiv(nA2, kDbM) <= 65535 && p.gslices >= 1 && p.gslices <= 65535 &&
           (p.gslices == 1 ? p.gcells == p.rows : p.n_chunks == 1) && p.gcells >= 32 &&
           p.gcells % 32 == 0 && (long long)p.gslices * p.gcells >= (N < p.rows ? N : p.rows) &&
           (long long)(p.gslices - 1) * p.gcells < N && p.part % 2 == 0 &&
           p.part >= (p.gslices > 1 ? (size_t)p.gslices * F * G : 0) &&
           ranges(p.dsplit, p.dgenes) && ranges(p.zsplit, p.zgenes);
  }
  constexpr int kDpsiK = sizeof(kDpsiKCounts) / sizeof(int);
  constexpr int kDpsiZ = sizeof(kDpsiZCounts) / sizeof(int);
  const int* gc = nullptr;
  const int n_gc = gene_tile_counts(p.g_nk, &gc);
  return p.ldw == 0 && p.gslices == 0 && p.gcells == 0 && p.dsplit == 0 && p.dgenes == 0 &&
         p.zsplit == 0 && p.zgenes == 0 &&
         p.d_nk == least_count(kDpsiKCounts, kDpsiK, Kf > 8 ? cdiv(Kf, 8) : 1) &&
         cdiv(Kf, 8) <= p.d_nk && p.d_groups == cdiv(zt, kDpsiZCounts[kDpsiZ - 1]) &&
         p.d_nz == least_count(kDpsiZCounts, kDpsiZ, cdiv(zt, p.d_groups)) &&
         (long long)p.d_nz * p.d_groups >= zt &&
         p.d_steps == (dpsi_smem(p.d_nk, p.d_nz, 4) <= kTwoBlockSmem ? 4 : 2) &&
         p.d_blocks == cdiv(N, 16 * kDpsiWarps) &&
         p.d_smem == dpsi_smem(p.d_nk, p.d_nz, p.d_steps) && p.d_smem <= kMaxSmem &&
         p.d_table >= (size_t)dpsi_table(G, p.d_nk, p.d_nz, p.d_groups, p.d_steps) &&
         p.g_st == cdiv(nA2, 8) && p.g_tiles == p.g_st + zt &&
         p.g_nk == least_count(kGeneKCounts, 3, Kf > 8 ? cdiv(Kf, 8) : 1) && n_gc > 0 &&
         cdiv(Kf, 8) <= p.g_nk && p.g_passes == cdiv(p.g_tiles, gc[n_gc - 1]) &&
         p.g_count == cdiv(p.g_tiles, p.g_passes) &&
         p.g_nt == least_count(gc, n_gc, p.g_count) && p.g_nt >= p.g_count &&
         p.g_blocks == cdiv(G, 16 * kGeneWarps) && p.rows >= kGeneCells &&
         p.rows % kGeneCells == 0 && p.n_chunks == cdiv(N, p.rows) && p.n_chunks <= 65535 &&
         p.g_smem == gene_smem(Kf, p.g_nt, p.g_nk) && p.g_smem <= kMaxSmem &&
         p.part >= (size_t)p.n_chunks * F * G && p.part % 2 == 0 &&
         p.g_table >= (size_t)gene_table(N, Kf, p.g_tiles, p.g_nk);
}

// Cells of row block b of the split gene part.
inline int db_block_rows(const Plan& p, int N, int b) {
  return N - b * p.rows < p.rows ? N - b * p.rows : p.rows;
}

#if F64_COMMON
using DpsiKernel = void (*)(const double*, const double*, const double*, const double*,
                            const double2*, double*, int, int, int, int, int, int);

// The instantiation a plan names (plan_of has checked its counts; within
// the old bound).
template <int NK>
DpsiKernel dpsi_kernel_nz(int nz) {
  switch (nz) {
    case 1: return dpsi_f64_kernel<NK, 1>;
    case 2: return dpsi_f64_kernel<NK, 2>;
    case 4: return dpsi_f64_kernel<NK, 4>;
    case 6: return dpsi_f64_kernel<NK, 6>;
    case 8: return dpsi_f64_kernel<NK, 8>;
    default: return dpsi_f64_kernel<NK, 10>;
  }
}
DpsiKernel dpsi_kernel_of(const Plan& p) {
  switch (p.d_nk) {
    case 1: return dpsi_kernel_nz<1>(p.d_nz);
    case 2: return dpsi_kernel_nz<2>(p.d_nz);
    case 4: return dpsi_kernel_nz<4>(p.d_nz);
    default: return dpsi_kernel_nz<8>(p.d_nz);
  }
}
#endif  // F64_COMMON

}  // namespace

namespace fl64 {

#if F64_ANY_TYPED
template <int YT>
using FwdKernel = void (*)(const typename Y64<YT>::Elem*, const double*, const double*,
                           const double*, const double*, double*, double*, double*, double*,
                           const double2*, int, int, int, int, int, int, int, int, bool, bool);
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
      a.plan.f_yt, a.plan.f_tiles, a.plan.f_count, !a.plan.split, vec);
}

template <int YT>
void gene_typed(const GeneArgs& a) {
  using Elem = typename Y64<YT>::Elem;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const bool vec = a.G % 8 == 0 && reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  const GeneKernel<YT> kernel = gene_kernel_of<YT>(a.plan);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.plan.g_smem);
  kernel<<<dim3(a.plan.g_blocks, a.plan.n_chunks), kGeneWarps * kWarp, a.plan.g_smem,
           a.stream>>>(Y, a.psi, a.W, a.muL, a.dA1, a.dA2, a.dZ, a.table, a.part, a.N, a.G, a.Kf,
                       a.nA2, a.SC, a.plan.rows, a.plan.g_st, a.plan.g_count, a.plan.g_passes,
                       vec);
}

template <int YT>
int blocks_per_sm(int which, const Plan& p, int Kf) {
  int blocks = 0;
  if (which == 0) {
    const FwdKernel<YT> kernel = fwd_kernel_of<YT>(p);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.f_smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kFwdWarps * kWarp, p.f_smem);
  } else if (p.split) {
    constexpr int smem = db_smem(kDbStageDlog);
    const auto kernel = which == 1 ? dlog_rfe_f64_kernel<YT, kOutDlog>
                                   : dlog_rfe_f64_kernel<YT, kOutRfe>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kDbThreads, smem);
  } else {
    const GeneKernel<YT> kernel = gene_kernel_of<YT>(p);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.g_smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kGeneWarps * kWarp, p.g_smem);
  }
  return blocks;
}

// The split kernels' Y-reading launches on row block b: which 0,
// dlog_rfe_f64_kernel<YT, kOutDlog> (rfe and dlog_rfe to the workspace);
// which 1, dlog mu = dA2^T Y by gene_product_f64_kernel<YT, true> into the
// output's last nA2 rows (or the slices' partial sums); which 2, the split
// forward's dlog_rfe_f64_kernel<YT, kOutRfe> (rfe, and A1's partial sums
// to a.dl).
template <int YT>
void split_typed(const SplitArgs& a, int b, int which) {
  using Elem = typename Y64<YT>::Elem;
  const Plan& p = a.plan;
  const long long n0 = (long long)b * p.rows;
  const int rows = db_block_rows(p, a.N, b), G = a.G, Kf = a.Kf, SC = a.SC;
  const Elem* Y = static_cast<const Elem*>(a.Y) + n0 * G;
  if (which == 2) {
    constexpr int smem = db_smem(kDbStageDlog);
    cudaFuncSetAttribute(dlog_rfe_f64_kernel<YT, kOutRfe>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dlog_rfe_f64_kernel<YT, kOutRfe><<<dim3((unsigned)cdiv(G, kDbN), (unsigned)cdiv(rows, kDbM)),
                                       kDbThreads, smem, a.stream>>>(
        Y, nullptr, tile_mat(a.psi + n0 * Kf, Kf, rows, Kf), tile_mat(a.W, Kf, G, Kf), DbMat{},
        DbMat{}, a.rfe, a.dl, p.ldw);
    return;
  }
  if (which == 0) {
    constexpr int smem = db_smem(kDbStageDlog);
    cudaFuncSetAttribute(dlog_rfe_f64_kernel<YT, kOutDlog>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dlog_rfe_f64_kernel<YT, kOutDlog><<<dim3((unsigned)cdiv(G, kDbN), (unsigned)cdiv(rows, kDbM)),
                                        kDbThreads, smem, a.stream>>>(
        Y, a.dA1 + n0, tile_mat(a.psi + n0 * Kf, Kf, rows, Kf), tile_mat(a.W, Kf, G, Kf),
        tile_mat(a.dZ + n0 * SC, SC, rows, SC), tile_mat(a.muL, SC, G, SC), a.rfe, a.dl, p.ldw);
    return;
  }
  const bool sliced = p.gslices > 1;
  const DbJob job{tile_mat(a.dA2 + n0 * a.nA2, a.nA2, rows, a.nA2), DbMat{},
                  (sliced ? a.gpart : a.dgene) + (long long)(Kf + SC) * G,
                  (int)cdiv(a.nA2, kDbM)};
  constexpr int smem = db_smem(kDbStageGene);
  cudaFuncSetAttribute(gene_product_f64_kernel<YT, true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  gene_product_f64_kernel<YT, true>
      <<<dim3((unsigned)cdiv(G, kDbN), job.m_tiles, p.gslices), kDbThreads, smem, a.stream>>>(
          DbJobs{{job, job}}, Y, G, sliced || b == 0, p.gcells,
          sliced ? (long long)(Kf + SC + a.nA2) * G : 0);
}
#endif  // F64_ANY_TYPED

#if F64_TYPED(0)
template void forward_typed<kYF64>(const FwdArgs&);
template void gene_typed<kYF64>(const GeneArgs&);
template int blocks_per_sm<kYF64>(int, const Plan&, int);
template void split_typed<kYF64>(const SplitArgs&, int, int);
#endif
#if F64_TYPED(1)
template void forward_typed<kYBF16>(const FwdArgs&);
template void gene_typed<kYBF16>(const GeneArgs&);
template int blocks_per_sm<kYBF16>(int, const Plan&, int);
template void split_typed<kYBF16>(const SplitArgs&, int, int);
#endif
#if F64_TYPED(2)
template void forward_typed<kYI16>(const FwdArgs&);
template void gene_typed<kYI16>(const GeneArgs&);
template int blocks_per_sm<kYI16>(int, const Plan&, int);
template void split_typed<kYI16>(const SplitArgs&, int, int);
#endif
#if F64_TYPED(3)
template void forward_typed<kYI8>(const FwdArgs&);
template void gene_typed<kYI8>(const GeneArgs&);
template int blocks_per_sm<kYI8>(int, const Plan&, int);
template void split_typed<kYI8>(const SplitArgs&, int, int);
#endif

}  // namespace fl64

#if F64_COMMON
// out (a row block's rows x cols) = t w over nsplit gene ranges of `genes`
// (t's rows ldt doubles apart, w G x cols) by dpsi_product_f64_kernel into
// part (nsplit x rows x cols), added in order with dA1 YW (where YW is
// given) by dpsi_sum_f64_kernel; one range without YW writes out itself.
static void range_product(const double* t, long long ldt, const double* w, double* out,
                          double* part, const double* dA1, const double* YW, int rows, int G,
                          int cols, int nsplit, int genes, cudaStream_t stream) {
  constexpr int smem = db_smem(kDbStageDpsi);
  cudaFuncSetAttribute(dpsi_product_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const bool direct = nsplit == 1 && !YW;
  const long long zstride = (long long)rows * cols;
  dpsi_product_f64_kernel<<<dim3((unsigned)cdiv(rows, kDbM), (unsigned)cdiv(cols, kDbN), nsplit),
                            kDbThreads, smem, stream>>>(
      tile_mat(t, ldt, rows, G), tile_mat(w, cols, G, cols), direct ? out : part, zstride, genes);
  if (!direct)
    dpsi_sum_f64_kernel<<<(int)cdiv(zstride, 256), 256, 0, stream>>>(part, dA1, YW, out, rows,
                                                                     cols, nsplit, zstride);
}

// split_typed<YT> at y_type.
static void split_launch(const SplitArgs& a, int y_type, int b, int which) {
  switch (y_type) {
    case kYF64: split_typed<kYF64>(a, b, which); break;
    case kYBF16: split_typed<kYBF16>(a, b, which); break;
    case kYI16: split_typed<kYI16>(a, b, which); break;
    default: split_typed<kYI8>(a, b, which);
  }
}

// Doubles of the split forward's gene ranges' sums of Z (none for one
// range), an even count.
inline size_t db_zpart(const Plan& p, int SC) {
  return p.zsplit > 1 ? (size_t)(2 * cdiv((long long)p.zsplit * p.rows * SC, 2)) : 0;
}

// The split forward's A1 and Z over the plan's row blocks (see the note at
// the top): for each, rfe = exp(psi W^T) into a.rfe and A1's partial sums
// into a.dl (dlog_rfe_f64_kernel<YT, kOutRfe>), added in order into A1's
// rows, then Z's rows = rfe muL over zsplit gene ranges (their sums in
// zpart).
static void split_forward(const SplitArgs& a, int y_type, double* A1, double* Z, double* zpart) {
  const Plan& p = a.plan;
  const int parts = 2 * (int)cdiv(a.G, kDbN);
  for (int b = 0; b < p.n_chunks; ++b) {
    const long long n0 = (long long)b * p.rows;
    const int rows = db_block_rows(p, a.N, b);
    split_launch(a, y_type, b, 2);
    reduce_chunks_f64_kernel<<<(int)cdiv(rows, 256), 256, 0, a.stream>>>(a.dl, A1 + n0, parts,
                                                                         rows);
    range_product(a.rfe, p.ldw, a.muL, Z + n0 * a.SC, zpart, nullptr, nullptr, rows, a.G, a.SC,
                  p.zsplit, p.zgenes, a.stream);
  }
}

// The split dpsi alone over the plan's row blocks: for each, t = rfe drfe
// into t (dlog_rfe_f64_kernel<0, kOutT>, no Y), then dpsi's rows = t W over
// dsplit gene ranges (their sums in dpart) + dA1 YW.
static void split_dpsi(const double* psi, const double* W, const double* muL, const double* dA1,
                       const double* dZ, const double* YW, double* dpsi, double* t, double* dpart,
                       int N, int G, int Kf, int SC, const Plan& p, cudaStream_t stream) {
  constexpr int smem = db_smem(kDbStageDlog);
  cudaFuncSetAttribute(dlog_rfe_f64_kernel<kYF64, kOutT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int b = 0; b < p.n_chunks; ++b) {
    const long long n0 = (long long)b * p.rows;
    const int rows = db_block_rows(p, N, b);
    dlog_rfe_f64_kernel<kYF64, kOutT><<<dim3((unsigned)cdiv(G, kDbN), (unsigned)cdiv(rows, kDbM)),
                                        kDbThreads, smem, stream>>>(
        nullptr, nullptr, tile_mat(psi + n0 * Kf, Kf, rows, Kf), tile_mat(W, Kf, G, Kf),
        tile_mat(dZ + n0 * SC, SC, rows, SC), tile_mat(muL, SC, G, SC), t, t, p.ldw);
    range_product(t, p.ldw, W, dpsi + n0 * Kf, dpart, dA1 + n0, YW + n0 * Kf, rows, G, Kf,
                  p.dsplit, p.dgenes, stream);
  }
}

// The split gene part over the plan's row blocks (see the note at the top):
// for each, dlog_rfe_f64_kernel (a.rfe and a.dl the block's rfe and
// dlog_rfe), dW^T = psi^T dlog_rfe and d(muL)^T = dZ^T rfe by
// gene_product_f64_kernel, and dlog mu = dA2^T Y where nA2 > 0, summed over
// the row blocks in order into a.dgene (or a single row block's slices'
// partial sums into a.gpart, which reduce_chunks_f64_kernel adds in order);
// with dpsi (and Kf > 0), dpsi's rows = dlog_rfe W over dsplit gene ranges
// (their sums in dpart) from the same dlog_rfe.
static void split_gene(const SplitArgs& a, int y_type, double* dpsi, double* dpart) {
  const Plan& p = a.plan;
  const int G = a.G, Kf = a.Kf, SC = a.SC;
  const long long FG = ((long long)Kf + SC + a.nA2) * G;
  const bool sliced = p.gslices > 1;
  double* out = sliced ? a.gpart : a.dgene;
  auto typed = [&](int b, int which) { split_launch(a, y_type, b, which); };
  constexpr int gsmem = db_smem(kDbStageGene);
  cudaFuncSetAttribute(gene_product_f64_kernel<kYF64, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, gsmem);
  for (int b = 0; b < p.n_chunks; ++b) {
    const long long n0 = (long long)b * p.rows;
    const int rows = db_block_rows(p, a.N, b);
    typed(b, 0);  // rfe and dlog_rfe of the row block
    const DbJob dw{tile_mat(a.psi + n0 * Kf, Kf, rows, Kf), tile_mat(a.dl, p.ldw, rows, G), out,
                   (int)cdiv(Kf, kDbM)};
    const DbJob dmu{tile_mat(a.dZ + n0 * SC, SC, rows, SC), tile_mat(a.rfe, p.ldw, rows, G),
                    out + (long long)Kf * G, (int)cdiv(SC, kDbM)};
    gene_product_f64_kernel<kYF64, false>
        <<<dim3((unsigned)cdiv(G, kDbN), dw.m_tiles + dmu.m_tiles, p.gslices), kDbThreads, gsmem,
           a.stream>>>(DbJobs{{dw, dmu}}, nullptr, G, sliced || b == 0, p.gcells,
                       sliced ? FG : 0);
    if (a.nA2) typed(b, 1);  // dlog mu = dA2^T Y
    if (sliced)  // one row block: its slices' partial sums, added in order
      reduce_chunks_f64_kernel<<<(int)cdiv(FG, 256), 256, 0, a.stream>>>(a.gpart, a.dgene,
                                                                         p.gslices, FG);
    if (dpsi && Kf)  // dpsi = dlog_rfe W
      range_product(a.dl, p.ldw, a.W, dpsi + n0 * Kf, dpart, nullptr, nullptr, rows, G, Kf,
                    p.dsplit, p.dgenes, a.stream);
  }
}

extern "C" {

// Y (N,G) is a device pointer to a contiguous array of the storage type
// y_type (0 float64, 1 bfloat16, 2 int16, 3 int8); every other pointer is a
// device pointer to a contiguous float64 array: psi (N,Kf), W (G,Kf), logmu
// (nA2,G), muL (G,SC); outputs A1 (N), A2 (N,nA2), Z (N,SC) and YW (N,Kf) =
// Y W. nA2 == 0 skips A2 (logmu and A2 are then not read or written). table
// (16-byte aligned) holds the plan's f_table doubles, the packed gene side
// (fwd_f64_pack_kernel, launched first), and where the plan is the split
// one rows x ldw doubles (the row block's rfe), where zsplit > 1 zsplit x
// rows x SC rounded up to even (the gene ranges' sums of Z), and rows x 2
// ceil(G / 64) (A1's partial sums). plan
// is f64_plan's for these sizes (F64_PLAN_KEYS, in order). Returns
// cudaErrorInvalidValue where the sizes or the plan do not fit, else
// cudaGetLastError() after launch.
int fl64_forward(const void* Y, const double* psi, const double* W, const double* logmu,
                 const double* muL, double* A1, double* A2, double* Z, double* YW, double* table,
                 const long long* plan, int N, int G, int Kf, int nA2, int SC, int y_type,
                 cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  const int klr = p.split ? 0 : Kf;
  const long long n = fwd_table(G, klr, p.f_tiles) / 2;
  fwd_f64_pack_kernel<<<(int)cdiv(n, 256), 256, 0, stream>>>(
      W, logmu, muL, reinterpret_cast<double2*>(table), G, Kf, nA2, SC, p.f_yt, p.f_tiles, klr,
      n);
  const FwdArgs a{Y,  psi, W, logmu, muL, A1, A2, Z, YW, reinterpret_cast<const double2*>(table),
                  N,  G,   Kf, nA2, SC, p,  stream};
  switch (y_type) {
    case kYF64: forward_typed<kYF64>(a); break;
    case kYBF16: forward_typed<kYBF16>(a); break;
    case kYI16: forward_typed<kYI16>(a); break;
    default: forward_typed<kYI8>(a);
  }
  if (p.split) {
    double* rfe = table + p.f_table;
    double* zpart = rfe + (size_t)p.rows * p.ldw;
    const SplitArgs s{Y,       psi,     W,       muL, nullptr, nullptr, nullptr, rfe,
                      zpart + db_zpart(p, SC), nullptr, nullptr, N, G, Kf, nA2, SC, p, stream};
    split_forward(s, y_type, A1, Z, zpart);
  }
  return (int)cudaGetLastError();
}

// Backward, dpsi part: psi, W, muL as fl64_forward, dA1 (N), dZ (N,SC) and
// YW (N,Kf) from fl64_forward; output dpsi (N,Kf). Reads no Y. table holds
// the plan's d_table doubles, the packed gene side (dpsi_f64_pack_kernel,
// launched first), or where the plan is the split one rows x ldw doubles
// (the row block's t = rfe drfe) and then dsplit x rows x Kf (the gene
// ranges' sums). plan is f64_plan's with nA2 = 0. Kf == 0 launches nothing.
int fl64_backward_dpsi(const double* psi, const double* W, const double* muL, const double* dA1,
                       const double* dZ, const double* YW, double* dpsi, double* table,
                       const long long* plan, int N, int G, int Kf, int SC, cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, 0, SC, kYF64) || !plan_of(plan, N, G, Kf, 0, SC, p))
    return (int)cudaErrorInvalidValue;
  if (Kf == 0) return (int)cudaSuccess;
  if (p.split) {
    split_dpsi(psi, W, muL, dA1, dZ, YW, dpsi, table, table + (size_t)p.rows * p.ldw, N, G, Kf,
               SC, p, stream);
    return (int)cudaGetLastError();
  }
  const long long n = dpsi_table(G, p.d_nk, p.d_nz, p.d_groups, p.d_steps) / 2;
  dpsi_f64_pack_kernel<<<(int)cdiv(n, 256), 256, 0, stream>>>(
      W, muL, reinterpret_cast<double2*>(table), G, Kf, SC, p.d_groups * p.d_nz, p.d_nk,
      dpsi_tiles(p.d_nk, p.d_nz, p.d_groups), n);
  const DpsiKernel kernel = dpsi_kernel_of(p);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.d_smem);
  kernel<<<p.d_blocks, kDpsiWarps * kWarp, p.d_smem, stream>>>(
      psi, dZ, dA1, YW, reinterpret_cast<const double2*>(table), dpsi, N, G, Kf, SC, p.d_groups,
      p.d_steps);
  return (int)cudaGetLastError();
}

// Backward, gene part: Y (in y_type), psi, W and muL as fl64_forward, dA1
// (N), dA2 (N,nA2), dZ (N,SC). Output dgene (Kf+SC+nA2, G) = [dW^T;
// d(muL)^T; dlog_mu]; scratch holds the plan's part doubles, the partial
// sums of each chunk (an even count), then its g_table doubles, the packed
// cell side (gene_f64_pack_kernel, launched first); where the plan is the
// split one, part (the slices' partial sums, where gslices > 1), 2 x rows x
// ldw doubles (the row block's rfe and dlog_rfe) and then dsplit x rows x
// Kf (dpsi's gene ranges' sums). With dpsi (N,Kf), which only the split
// plan takes (the autograd function's backward; else null), dpsi too, =
// dlog_rfe W from the same dlog_rfe a row block. Kf == 0 runs with rfe = 1.
int fl64_backward_gene(const void* Y, const double* psi, const double* W, const double* muL,
                       const double* dA1, const double* dA2, const double* dZ, double* dpsi,
                       double* scratch, double* dgene, const long long* plan, int N, int G,
                       int Kf, int nA2, int SC, int y_type, cudaStream_t stream) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p) ||
      (dpsi && !p.split))
    return (int)cudaErrorInvalidValue;
  if (p.split) {
    double* rfe = scratch + p.part;
    double* dl = rfe + (size_t)p.rows * p.ldw;
    const SplitArgs a{Y,     psi,     W, muL, dA1, dA2, dZ, rfe, dl, dgene,
                      scratch, N, G, Kf, nA2, SC, p,  stream};
    split_gene(a, y_type, dpsi, dl + (size_t)p.rows * p.ldw);
    return (int)cudaGetLastError();
  }
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

// What the plan's kernels take on the card: out[0..12) = fwd_f64_kernel's
// dynamic shared memory bytes and blocks an SM (the occupancy query) at Y
// storage y_type (past the old bound its Y products' groups), the same for
// dpsi_f64_kernel and gene_f64_kernel; where the plan is the split one,
// in their places dpsi_product_f64_kernel (Z's and dpsi's products) and
// dlog_rfe_f64_kernel<y_type, 1>, then gene_product_f64_kernel<0, 0>,
// dlog_rfe_f64_kernel<y_type, 2> (the forward's rfe and A1) and
// dlog_rfe_f64_kernel<0, 0> (dpsi's t), else zeros. Returns
// cudaErrorInvalidValue where the plan does not fit the sizes.
int fl64_resources(const long long* plan, int N, int G, int Kf, int nA2, int SC, int y_type,
                   int* out) {
  Plan p;
  if (bad_sizes(N, G, Kf, nA2, SC, y_type) || !plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  auto query = [](auto kernel, int smem, int* o) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    o[0] = smem;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[1], kernel, kDbThreads, smem);
  };
  for (int i = 0; i < 12; ++i) out[i] = 0;
  if (p.split) {
    query(dpsi_product_f64_kernel, db_smem(kDbStageDpsi), out + 2);
    query(gene_product_f64_kernel<kYF64, false>, db_smem(kDbStageGene), out + 6);
    query(dlog_rfe_f64_kernel<kYF64, kOutT>, db_smem(kDbStageDlog), out + 10);
  } else {
    const DpsiKernel dpsi_kernel = dpsi_kernel_of(p);
    cudaFuncSetAttribute(dpsi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.d_smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], dpsi_kernel, kDpsiWarps * kWarp,
                                                  p.d_smem);
    out[2] = p.d_smem;
  }
  for (int which = 0; which < (p.split ? 3 : 2); ++which) {
    int blocks = 0;
    switch (y_type) {
      case kYF64: blocks = blocks_per_sm<kYF64>(which, p, Kf); break;
      case kYBF16: blocks = blocks_per_sm<kYBF16>(which, p, Kf); break;
      case kYI16: blocks = blocks_per_sm<kYI16>(which, p, Kf); break;
      default: blocks = blocks_per_sm<kYI8>(which, p, Kf);
    }
    out[4 * which] = which == 0 ? p.f_smem : p.split ? db_smem(kDbStageDlog) : p.g_smem;
    out[4 * which + 1] = blocks;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // F64_COMMON

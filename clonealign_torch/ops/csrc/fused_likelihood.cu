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
// gene_wide_kernel take any Kf, nA2 and SC with the same contract (as far
// as the plan's shared memory fits a block: wide_plan raises past it), and
// the wrapper launches them only past a narrow limit. Widths past a warp's
// accumulator tiles go in column groups or passes, each recomputing what
// it needs (the exps, a read of Y): Z's column groups (grid.y of
// fwd_wide_kernel), the Y products' (grid.y of fwd_wide_y_kernel; A1's
// partial sums then added by reduce_chunks_kernel), dpsi's dZ groups and
// the gene part's passes over d(muL)'s columns. Past the old bound (Kf 64,
// nA2 64 or SC 2,048: wide_plan's split) the backward is the split one
// (the last item below) in place of dpsi_wide_kernel and gene_wide_kernel.
// The contract is unnormalized attention: Q = psi (head width Kf), K = W,
// V = muL (value width SC), P = exp(Q K^T) with no running max. Each
// launch follows one plan (WidePlan), which ops/fused_likelihood.py's
// wide_plan makes and the entry points take and check (wide_plan_of):
// 8-column tiles of [psi, X], Z, [W | log mu^T] and dA2, the forward's
// column groups, the gene part's chunks and passes, and the workspace. The
// shared-memory layout of each kernel follows from the plan here. A warp holds at most kWideTiles accumulator tiles of 8
// columns, and each loop over a group's or pass's tiles runs a count the
// kernel is built for (kWideTileCounts, kWideYTileCounts; the tiles padded
// with zeros up to it), so that the tiles' chains of dependent MMAs
// interleave: with a test of a runtime count around each tile they ran one
// after another, and the same kernels took 2.9 ms (forward) and 7.4 ms
// (gene part) at int8, Kf 5, S*C 80 on an H100 80GB HBM3 (700 W), against
// 2.4 and 5.7 with built counts (time_likelihood.py --wide).
//
//  * fwd_wide_kernel (Z = P V): each warp owns 16 cell rows, the M of
//    mma.sync m16n8k8 TF32, as in fwd_kernel. log_rfe = psi W^T is itself
//    a 3xTF32 MMA (psi's A fragments split once into shared memory, W^T's
//    B fragments staged), and its C fragment (rows r, r + 8, genes 2c,
//    2c + 1) is the A fragment of Z = rfe muL once the 8 genes of each
//    k-step are taken in the order 0, 2, 4, 6, 1, 3, 5, 7:
//    fwd_wide_pack_kernel writes muL's and [W | log mu^T]'s B fragments in
//    that order, split into TF32 hi and lo, once a call. Blocks stage 32
//    genes of that table with cp.async into a ring of two stages (16
//    genes where 32 would leave room for one block an SM, at the widest
//    [psi, X]; the warps of a row group share its psi fragments). Z's
//    columns run as n-tiles through mma_3xtf32, each k-step's three
//    products in fresh accumulators added on CUDA cores; exps are formed
//    once a column group of up to kWideTiles n-tiles (S*C <= 128 is one
//    group; wider Z takes groups in grid.y, each recomputing the exps).
//    Past 10 tiles two warps share 16 rows, each forming half the
//    k-steps' exps for both through shared memory and taking half the
//    tiles: 128 registers then hold a warp's accumulators without a spill.
//    What bounds it is the MMAs, 3 a tile and k-step, and log_rfe's 3 a
//    k-step per 8 columns of [psi, X] (gene_variants.py, int8, S*C 80):
//    log_rfe takes 0.34 of 2.4 ms at Kf 5 and 2.5 of 6.3 ms at Kf 64.
//    Forming it with Kf FMAs an element on the CUDA cores could save at
//    most 0.34 ms at Kf 5, and at Kf 64 would itself take at least 1 ms
//    (3.2e10 FMAs at the float32 rate): one path, by MMA, at every Kf.
//  * fwd_wide_y_kernel, launched beside it: Y W, A2 (one MMA with B =
//    [W | log mu^T]) and A1 = sum_k psi_k (Y W)_k from one read of Y (a
//    read a column group past 16 tiles), each warp staging its 16 rows in
//    the storage type through the same kind of ring. Y is an exact float split into hi and lo, so a narrow Y
//    gives the float32 Y's results bit for bit.
//  * dpsi_wide_kernel (Y-free; FlashAttention-2's dQ pass, cells as M):
//    dpsi = dA1 YW + (rfe drfe) W with drfe = dZ muL^T. Each warp owns 16
//    cell rows and walks the genes in k-steps of 8, with per k-step, all
//    on tensor cores in 3xTF32: log_rfe = psi W^T (psi's A fragments in
//    shared memory, split where they are used), drfe = dZ muL^T (dZ's A
//    fragments of up to 10 tiles split once into registers; K = S*C), then
//    t = exp(log_rfe) drfe in the C fragment, which is the A fragment of
//    dpsi += t W once the k-step's genes are taken in C-to-A order.
//    dpsi_wide_pack_kernel
//    writes the gene side once a call (W^T, muL^T, and W in C-to-A order,
//    split into TF32 hi and lo); blocks of 4 warps stage it with cp.async
//    into a ring of two stages of 4 k-steps (2 where 4 would leave room
//    for one block an SM). One exp per (cell, gene) up to S*C = 80; wider
//    dZ takes column groups one after another, each recomputing log_rfe
//    and the exps (dpsi is linear in drfe). Each product's k-step goes to
//    fresh accumulators added on CUDA cores; dpsi's k-steps are summed in
//    float32 over a stage and in float64 over the stages, and dA1 YW is
//    added last in float64. Every lane holds its own outputs: no shuffle,
//    no atomics, deterministic. Measured at full width on an H100 80GB
//    HBM3 (700 W), int8 or float32 alike (time_likelihood.py --wide):
//    2.35-2.39 ms at Kf 5, S*C 80, 0.84-0.87 at S*C 10 and 6.91-6.93 at Kf
//    64, against 8.33-8.35, 2.67-2.73 and 37.5 for the float32 FMA kernel
//    on CUDA cores it replaced; drfe's MMAs take 1.0 ms of the 2.35,
//    log_rfe's 0.24 and dpsi's 0.20 (gene_variants.py).
//  * gene_wide_kernel (FlashAttention-2's dK/dV pass, genes as M): each
//    warp owns 16 genes and walks its chunk of cells in k-steps of 8, with
//    per k-step, all on tensor cores in 3xTF32: log_rfe^T = W psi^T,
//    drfe^T = muL dZ^T (muL of the pass's columns split once into shared
//    memory; K = S*C), dlog_rfe = rfe drfe + Y dA1 in registers at the same
//    C positions, d(muL) += rfe^T dZ and dW += dlog_rfe^T psi (rfe and
//    dlog_rfe turned into A fragments by the cell order above), and dlog
//    mu += Y^T dA2. gene_wide_pack_kernel writes the cell side once a call
//    as (hi, lo) pairs: dZ, psi, dA2 and dA1; blocks of 4 warps stage 16
//    cells of them and of Y with cp.async into a ring of two, the stage's
//    two k-steps unrolled so that one's chain of products runs beside the
//    other's. Each k-step's products go to fresh accumulators added on CUDA
//    cores. d(muL) of a pass's columns stays in registers: S*C <= 128 (less
//    the dW and dlog mu tiles, and padded to a built count) is one pass;
//    wider takes several, each recomputing rfe and its part of drfe. dW is
//    linear in drfe, so each pass adds rfe drfe_pass psi to dW's
//    accumulators, which live through every pass and are stored once: drfe
//    is neither held nor recomputed whole. Three blocks an SM (168
//    registers; two past 10 tiles, where more would spill). Each (chunk,
//    gene block) writes its own partial sums, which reduce_chunks_kernel
//    adds in a fixed order: deterministic, no atomics. Its products weigh
//    as they should: without drfe's MMAs it took 1.9 of its 5.7 ms at
//    Kf 5, S*C 80, without d(muL)'s 1.5, without dW's 2.4, the last more
//    than their share because dW waits on drfe and the exps
//    (gene_variants.py).
//  * The split backward (dlog_rfe_kernel, gene_product_kernel,
//    dpsi_product_kernel + dpsi_sum_kernel), past the old bound: the
//    counterpart of _bwd_kernel's tile of rfe, drfe and dlog_rfe in VMEM,
//    from which it takes every product. It replaces the grouped forms
//    of dpsi_wide_kernel and gene_wide_kernel, which held their sums in
//    registers and so formed log_rfe over every tile of [psi, X], the exps
//    and drfe again in each of their groups and passes (at Kf 72, S*C 660:
//    2 x 9 and 2 x 10 of them, 145.5 and 188.8 ms against the plain VJP's
//    26.8 and 45.0; H100 80GB HBM3, 700 W). Here the split is at
//    dlog_rfe: over row blocks of plan.rows cells (a workspace of at most
//    2^23 floats a buffer, whatever N), dlog_rfe_kernel forms log_rfe =
//    psi W^T, one exp an element, and drfe = dZ muL^T over all of S*C into
//    one accumulator, and writes rfe and dlog_rfe = rfe drfe + Y dA1 (or t
//    = rfe drfe, for dpsi alone) to the workspace; gene_product_kernel takes
//    dW^T = psi^T dlog_rfe and d(muL)^T = dZ^T rfe (and dlog mu = dA2^T Y)
//    from it, K the block's cells, summed over the row blocks in order in
//    the output (a single block's cells in slices whose partial sums
//    reduce_chunks_kernel adds, where its grid would not fill the card);
//    dpsi_product_kernel takes t W (or dlog_rfe W) over ranges of genes,
//    which dpsi_sum_kernel adds in float64 beside dA1 YW. Nothing is formed
//    twice, and fl_backward_gene_wide with dpsi (the autograd function's
//    backward) forms dlog_rfe once for both parts. Each is a tiled product: blocks of 64 x
//    64 outputs, warps of 32 x 32 in two groups of four, each group taking
//    its half of each stage's 32 values of K (twice the warps a tile, for
//    small grids), stages filled by cp.async into a ring of three (16 bytes
//    a copy: at an odd S*C, dZ's row block and muL are first copied to a
//    pitch of whole float4s, pad_rows_kernel) and each pair of k-steps'
//    3xTF32 products in fresh accumulators added on CUDA cores;
//    deterministic, no atomics. What bounds them: the MMAs (at Kf 72, S*C
//    660, 2.3e12 TF32 flops in drfe and log_rfe, as many in d(muL) and dW,
//    0.4e12 in dpsi), run by mma.sync at ~110 TFLOP/s in each kernel with
//    two blocks an SM (chip_smoke.py; the same with stages of 64 or four
//    of them in the ring, so neither the barriers nor the copies set it),
//    a fifth of the 495 of the bound; wgmma is the way to more.
//  * The split forward, past the old bound: the counterpart of _fwd_kernel's
//    jnp.dot branches, in place of fwd_wide_kernel's Z groups, each of which
//    formed log_rfe over every tile of [psi, X] and the exps again (at Kf 72,
//    S*C 660: six groups, 42.67-43.5 ms against the plain forward's 22.0-22.4;
//    H100 80GB HBM3, 700 W). Over the same row blocks, dlog_rfe_kernel's
//    rfe-only form (kOutRfe) writes rfe = exp(psi W^T) to the workspace once,
//    and Z = rfe muL is dpsi_product_kernel's tiled product with muL in W's
//    place, over zsplit gene ranges (enough blocks to fill the card's last
//    wave, wide_plan's rule) that dpsi_sum_kernel adds in order (one range
//    writes Z's rows itself). Y's products stay fwd_wide_y_kernel's, one read
//    of Y a column group; the packed table then holds only their tiles.
//
// Build: one translation unit holds everything, or ops/_build.py compiles
// this file as five in parallel and links them: FL_PART = -1 holds the
// Y-free kernels and the C entry points, FL_PART = YT the Y-reading kernels
// of one storage type (fl::forward_typed<YT>, fl::gene_typed<YT>).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "split_tiles.cuh"

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

// The wide family's launch plan (made by ops/fused_likelihood.py's
// wide_plan, checked by wide_plan_of): 8-column tiles of [psi, X] (n_kc), Z (n_zt), [W | log
// mu^T] (n_yt) and dA2 (n_st); the forward's column groups (n_zgroups of
// zt_group Z tiles, zero-padded) and Y tiles (ny_pad, zero-padded); the gene
// part's chunks of rows cells and its passes over dZ's tiles (mu_passes of
// nj tiles, zero-padded, after a first pass of its own for Y's products
// where y_pass); the workspace in floats: the forward's gene table, and the
// gene part's partial sums and packed cell side; dpsi_wide_kernel's tiles
// of [psi, X] (dk_pad) and of a dZ column group (n_dgroups of dz_group),
// its k-steps a stage (dsteps) and its gene table (dtable floats).
//
// Past the widths one block's tiles hold: the Y products' column groups
// (n_ygroups of ny_pad tiles) and A1's partial sums (a1_parts rows of N
// floats, a1part floats after the table; none where one warp holds every
// column of Y W); y_pass counts the passes dlog mu takes of its own (0: it
// rides the first pass).
//
// split: the backward is the split one (past Kf 64, nA2 64 or SC 2,048, the
// old bound): rows cells a row block of the workspace, n_chunks row blocks,
// ldw the workspace's row pitch (floats), dsplit gene ranges of dgenes genes
// for dpsi's product, gslices slices of gcells cells a row block for the
// gene part's products (more than one only in a single row block: then
// partial sums that reduce_chunks_kernel adds), and ldz the row pitch dZ
// and muL are copied to where SC is no whole number of float4s (else 0);
// the gene part's and dpsi's other numbers are then 0. The forward is then
// the split one too: no Z groups (n_zgroups and zt_group 0), Z = rfe muL
// over the same row blocks in zsplit gene ranges of zgenes genes (0 within
// the old bound).
struct WidePlan {
  int n_kc, n_zt, n_yt, n_st;
  int g_pad, zt_group, n_zgroups, ny_pad;
  int rows, n_chunks, n_pad, nj, mu_passes, y_pass, n_passes;
  size_t table, part, dz, ps, a2, a1;
  int dk_pad, dz_group, n_dgroups, dsteps;
  size_t dtable;
  int n_ygroups, a1_parts;
  size_t a1part;
  int split, ldw, dsplit, dgenes, gslices, gcells, ldz, zsplit, zgenes;
};

// The forward table's first Y-product tile of a k-step: after W^T's n_kc
// tiles and the Z groups' tiles fwd_wide_kernel takes; none past the old
// bound, where the split forward forms Z and the table holds only Y's.
__host__ __device__ inline int fwd_y_tile0(const WidePlan& p) {
  return p.split ? 0 : p.n_kc + p.n_zgroups * p.zt_group;
}

struct FwdWideArgs {
  const void* Y;  // (N, G) in the storage type
  const float* psi;
  const float4* table;  // written by fwd_wide_pack_kernel
  float *A1, *A2, *Z, *YW;
  float* a1part;  // A1's partial sums (plan.a1_parts rows of N floats)
  int N, G, Kf, nA2, SC;
  WidePlan plan;
  cudaStream_t stream;
};

// The wide gene part's arguments: the cell side as gene_wide_pack_kernel
// wrote it, and part, the partial sums of plan.n_chunks chunks.
struct GeneWideArgs {
  const void* Y;  // (N, G) in the storage type
  const float *W, *muL;
  const float2 *dz, *ps, *a2;
  const float* a1;
  float* part;
  int N, G, Kf, nA2, SC;
  WidePlan plan;
  cudaStream_t stream;
};

// The split backward's arguments: the workspace of one row block (rfe and
// dlog_rfe, plan.rows x plan.ldw floats each), the (Kf + SC + nA2, G)
// output, where the plan slices the cells (gslices > 1) the slices'
// partial sums of it, and where SC is no whole number of float4s
// (plan.ldz > 0) the row block's dZ and muL at a row pitch of ldz.
struct SplitArgs {
  const void* Y;  // (N, G) in the storage type
  const float *psi, *W, *muL, *dA1, *dA2, *dZ;
  float *rfe, *dl, *dgene, *gpart, *zpad, *mupad;
  int N, G, Kf, nA2, SC;
  WidePlan plan;
  cudaStream_t stream;
};

// The Y-reading kernels of one storage type: fwd_kernel, and gene_kernel
// (between gene_pack_kernel and reduce_chunks_kernel, which fl_backward_gene
// launches); and the wide family's fwd_wide_y_kernel and gene_wide_kernel,
// with their blocks an SM at a tile count and shared memory (which: 1 the
// Y products, 2 the gene part); and the split backward's, for row block b:
// dlog_rfe_kernel<YT, kOutDlog> (which 0) or dlog mu's gene_product_kernel<YT,
// true> (which 1), with their shared memory and blocks an SM.
template <int YT> void forward_typed(const FwdArgs& a);
template <int YT> void gene_typed(const GeneArgs& a);
template <int YT> void forward_wide_typed(const FwdWideArgs& a);
template <int YT> void gene_wide_typed(const GeneWideArgs& a);
template <int YT> int wide_blocks_per_sm(int which, int nt, int smem);
template <int YT> void split_typed(const SplitArgs& a, int b, int which);
template <int YT> void split_resources_typed(int* out);

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
// The wide family's tiles.
constexpr int kWideTiles = 16;  // accumulator tiles of 8 columns a warp holds at most
// Tile counts the wide kernels are built for (a group's or pass's tiles
// are padded up to one): Z tiles a forward group and d(muL) tiles a gene
// pass; Y tiles.
constexpr int kWideTileCounts[] = {1, 2, 4, 6, 8, 10, 12, 16};
constexpr int kWideYTileCounts[] = {1, 2, 4, 8, 16};
constexpr int kFwdWideGenes = 32;                   // genes a forward stage
constexpr int kFwdWideSteps = kFwdWideGenes / 8;    // its MMA k-steps
constexpr int kGeneWideWarps = 4;                   // gene-part blocks: 4 warps x 16 genes
constexpr int kGeneWideGenes = kGeneWideWarps * kFwdRows;
constexpr int kGeneWideCells = 16;                  // cells a gene-part stage (2 k-steps)
// dpsi_wide_kernel's built widths: tiles of [psi, X] (log_rfe's K and
// dpsi's columns, zero-padded) and dZ tiles of a column group, whose A
// fragments a warp holds in registers (ops/fused_likelihood.py's
// WIDE_DPSI_K_COUNTS, WIDE_DPSI_Z_COUNTS).
constexpr int kDpsiKCounts[] = {1, 2, 4, 8};
constexpr int kDpsiZCounts[] = {1, 2, 4, 6, 8, 10};
constexpr int kDpsiWarps = 4;  // dpsi_wide_kernel blocks: 4 warps x 16 cells

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
// The wide family (see the note at the top).
// ---------------------------------------------------------------------------

// The tensor-core pieces of the wide kernels.
//
// A C fragment (rows r and r + 8, columns 2c and 2c + 1, in the order (r,
// 2c), (r, 2c + 1), (r + 8, 2c), (r + 8, 2c + 1)) becomes the A fragment of
// the next product, split into TF32 hi and lo, when that product's k-step
// takes column 2c as its column c and 2c + 1 as its column c + 4: C order
// 0, 2, 1, 3. The other operand's B fragments follow the same order.
__device__ __forceinline__ void c_to_a(const float (&c)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32_int(c[0], hi[0], lo[0]);
  split_tf32_int(c[2], hi[1], lo[1]);
  split_tf32_int(c[1], hi[2], lo[2]);
  split_tf32_int(c[3], hi[3], lo[3]);
}

// An A fragment stored as two float4s (hi, then lo) in shared memory.
__device__ __forceinline__ void load_a(const float4* f, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float4 h = f[0], l = f[kWarp];
  hi[0] = __float_as_uint(h.x), hi[1] = __float_as_uint(h.y);
  hi[2] = __float_as_uint(h.z), hi[3] = __float_as_uint(h.w);
  lo[0] = __float_as_uint(l.x), lo[1] = __float_as_uint(l.y);
  lo[2] = __float_as_uint(l.z), lo[3] = __float_as_uint(l.w);
}

// Split four values into an A fragment stored as two float4s at f and f + kWarp.
__device__ __forceinline__ void store_a(float4* f, const float (&v)[4]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_int(v[e], h[e], l[e]);
  f[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                     __uint_as_float(h[3]));
  f[kWarp] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                         __uint_as_float(l[3]));
}

// The B fragment (hi0, hi1, lo0, lo1) of two (hi, lo) pairs.
__device__ __forceinline__ float4 pair_b(float2 b0, float2 b1) {
  return make_float4(b0.x, b1.x, b0.y, b1.y);
}

__device__ __forceinline__ float2 tf32_pair(float v) {
  uint32_t h, l;
  split_tf32_int(v, h, l);
  return make_float2(__uint_as_float(h), __uint_as_float(l));
}

// Accumulate a fresh MMA sum: acc += d.
__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// Two counts of Y at consecutive genes (16-bit, 32-bit or 64-bit aligned),
// and one count, as floats, exactly: piece_to_float4's conversions.
template <int YT>
__device__ __forceinline__ float2 y_pair(const typename YStore<YT>::Elem* p) {
  if constexpr (YT == kYF32) {
    return *reinterpret_cast<const float2*>(p);
  } else if constexpr (YT == kYBF16) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  } else if constexpr (YT == kYI16) {
    constexpr float kOff = 12582912.f + 32768.f;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p) ^ 0x80008000u;
    return make_float2(__uint_as_float(__byte_perm(v, 0x4b400000u, 0x7610)) - kOff,
                       __uint_as_float(__byte_perm(v, 0x4b400000u, 0x7632)) - kOff);
  } else {
    constexpr float kOff = 12582912.f + 128.f;
    const uint32_t v = (uint32_t)*reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    return make_float2(__uint_as_float(__byte_perm(v, 0x4b400000u, 0x7650)) - kOff,
                       __uint_as_float(__byte_perm(v, 0x4b400000u, 0x7651)) - kOff);
  }
}

template <int YT>
__device__ __forceinline__ float y_one(typename YStore<YT>::Elem e) {
  if constexpr (YT == kYF32)
    return e;
  else if constexpr (YT == kYBF16)
    return __uint_as_float((uint32_t)e << 16);
  else if constexpr (YT == kYI16)
    return __uint_as_float(0x4b400000u + (uint32_t)((int)e + 32768)) - (12582912.f + 32768.f);
  else
    return __uint_as_float(0x4b400000u + (uint32_t)((int)e + 128)) - (12582912.f + 128.f);
}

// One piece of a Y row (4 counts from gene g, zero past G and for a row
// that is not live) into shared memory with cp.async where pieces are
// aligned; an unaligned piece goes count by count, a float32 one by 4-byte
// cp.async, a narrow one (under cp.async's least size) by the thread's own
// load and store.
template <int YT>
__device__ __forceinline__ void stage_y_piece(typename YStore<YT>::Elem* dst,
                                              const typename YStore<YT>::Elem* __restrict__ row,
                                              bool live, int g, int G, bool vec) {
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  if (vec) {
    cp_async_zfill<sizeof(Piece)>(dst, row + (live && g < G ? g : 0),
                                  live && g < G ? (int)sizeof(Piece) : 0);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool in = live && g + u < G;
      if constexpr (YT == kYF32)
        cp_async_zfill<4>(dst + u, row + (in ? g + u : 0), in ? 4 : 0);
      else
        dst[u] = in ? row[g + u] : Elem(0);
    }
  }
}

#if FL_COMMON
// The forward's gene-side table, once a call: for each k-step of 8 genes
// (g_pad / 8 of them), n_kc + n_zgroups zt_group + n_ygroups ny_pad B fragments (hi0,
// hi1, lo0, lo1) of 32 lanes: W^T for log_rfe (k = columns of [psi, X],
// genes in order as B's columns), then muL's Z tiles and [W | log mu^T]'s
// tiles with the genes of the k-step in C-to-A order (B's row c is gene
// 2c, row c + 4 gene 2c + 1); past the old bound only the last
// (fwd_y_tile0). Zero past G and every width.
__global__ void fwd_wide_pack_kernel(const float* __restrict__ W, const float* __restrict__ logmu,
                                     const float* __restrict__ muL, float4* __restrict__ table,
                                     int G, int Kf, int nA2, int SC, WidePlan p) {
  const int y0 = fwd_y_tile0(p), n_w = y0 - p.n_zgroups * p.zt_group;
  const int n_tab = y0 + p.n_ygroups * p.ny_pad;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)(p.g_pad / 8) * n_tab * kWarp) return;
  const int l = (int)(i % kWarp), r = (int)((i / kWarp) % n_tab), ks = (int)(i / kWarp / n_tab);
  float b0 = 0.f, b1 = 0.f;
  if (r < n_w) {
    const int g = 8 * ks + (l >> 2), k = 8 * r + (l & 3);
    if (g < G && k < Kf) b0 = W[(size_t)g * Kf + k];
    if (g < G && k + 4 < Kf) b1 = W[(size_t)g * Kf + k + 4];
  } else if (r < y0) {
    const int g = 8 * ks + 2 * (l & 3), j = 8 * (r - n_w) + (l >> 2);
    if (j < SC && g < G) b0 = muL[(size_t)g * SC + j];
    if (j < SC && g + 1 < G) b1 = muL[(size_t)(g + 1) * SC + j];
  } else {
    const int g = 8 * ks + 2 * (l & 3), c = 8 * (r - y0) + (l >> 2);
    auto x = [&](int gg) {
      return gg >= G ? 0.f
             : c < Kf ? W[(size_t)gg * Kf + c]
             : c < Kf + nA2 ? logmu[(size_t)(c - Kf) * G + gg] : 0.f;
    };
    b0 = x(g);
    b1 = x(g + 1);
  }
  const float2 h0 = tf32_pair(b0), h1 = tf32_pair(b1);
  table[i] = make_float4(h0.x, h1.x, h0.y, h1.y);
}

// Forward, wide, Z = exp(psi W^T) muL: grid (blocks of cells, p.n_zgroups
// column groups of NZ = p.zt_group Z tiles). Every tile loop runs a built
// count of tiles, so the tiles' MMA chains interleave. Up to 10 tiles each
// warp owns 16 cell rows (kFwdWarps x 16 cells a block). Past 10, two warps
// share 16 rows and each takes half the tiles, so that a warp's
// accumulators and B fragments fit 128 registers without spilling: each
// forms the exps of half the stage's k-steps, and both read the stage's
// A fragments from shared memory (kFwdWarps / 2 x 16 cells a
// block). A stage holds STEPS k-steps (fwd_wide_steps: 4, or 2 where 4
// would leave room for one block an SM). Dynamic shared memory: each row
// group's psi A fragments ([row group][kc][hi, lo][lane]), two stage buffers
// of stage_f4 float4s, each STEPS k-steps of [W^T tiles | the group's Z
// tiles][lane], and for shared rows the A fragments ([row group][k-step][hi,
// lo][lane]).
template <int NZ, int STEPS>
__global__ void __launch_bounds__(kFwdWarps * kWarp, 2)
fwd_wide_kernel(const float* __restrict__ psi, const float4* __restrict__ table,
                float* __restrict__ Z, int N, int Kf, int SC, WidePlan p, int stage_f4) {
  constexpr bool kPair = NZ > 10;
  constexpr int NT = kPair ? NZ / 2 : NZ;                      // tiles a warp
  constexpr int kGroups = kPair ? kFwdWarps / 2 : kFwdWarps;  // row groups a block
  extern __shared__ float4 s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int rg = warp % kGroups, half = warp / kGroups;
  // MMA fragments: A rows (cells) r and r + 8, A columns c and c + 4.
  const int fr = lane >> 2, fc = lane & 3;
  const int row0 = (blockIdx.x * kGroups + rg) * kFwdRows;
  const int n0 = row0 + fr, n1 = n0 + 8;
  const int z0 = blockIdx.y * NZ;
  const int RW = p.n_kc + NZ;  // table tiles a k-step of a stage
  const int n_tab = fwd_y_tile0(p) + p.n_ygroups * p.ny_pad;
  float4* s_psi = s_dyn + rg * p.n_kc * 2 * kWarp;
  float4* s_stage = s_dyn + kGroups * p.n_kc * 2 * kWarp;
  float4* s_a = s_stage + 2 * stage_f4 + rg * STEPS * 2 * kWarp;

  // psi's A fragments (rows n0, n1; columns 8 kc + c, + 4), split once by
  // the row group's first warp, read after the first stage's barrier.
  if (half == 0) {
#pragma unroll 1
    for (int kc = 0; kc < p.n_kc; ++kc) {
      const int k0 = 8 * kc + fc, k1 = k0 + 4;
      const float v[4] = {n0 < N && k0 < Kf ? psi[(size_t)n0 * Kf + k0] : 0.f,
                          n1 < N && k0 < Kf ? psi[(size_t)n1 * Kf + k0] : 0.f,
                          n0 < N && k1 < Kf ? psi[(size_t)n0 * Kf + k1] : 0.f,
                          n1 < N && k1 < Kf ? psi[(size_t)n1 * Kf + k1] : 0.f};
      store_a(s_psi + 2 * kc * kWarp + lane, v);
    }
  }

  // cp.async of stage s (genes [8 STEPS s, 8 STEPS (s + 1))) into buffer buf.
  auto stage = [&](int s, int buf) {
    float4* dst = s_stage + (size_t)buf * stage_f4;
    const int ks0 = s * STEPS;
    for (int i = threadIdx.x; i < STEPS * RW * kWarp; i += blockDim.x) {
      const int l = i % kWarp, r = (i / kWarp) % RW, ks = i / (kWarp * RW);
      const int src = r < p.n_kc ? r : z0 + r;
      cp_async_zfill<16>(dst + i, table + ((size_t)(ks0 + ks) * n_tab + src) * kWarp + l, 16);
    }
    cp_async_commit();
  };
  // exp(log_rfe) of k-step ks at the A positions (C-to-A order).
  auto rfe_a = [&](const float4* tab, int ks, float (&a)[4]) {
    float lr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
    for (int kc = 0; kc < p.n_kc; ++kc) {
      uint32_t ph[4], pl[4];
      load_a(s_psi + 2 * kc * kWarp + lane, ph, pl);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(d, ph, pl, tab[(ks * RW + kc) * kWarp + lane]);
      add4(lr, d);
    }
    a[0] = __expf(lr[0]);
    a[1] = __expf(lr[2]);
    a[2] = __expf(lr[1]);
    a[3] = __expf(lr[3]);
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const int n_stages = p.g_pad / (8 * STEPS);
  stage(0, 0);
  // No early exit: every warp takes part in the block's barriers; rows past
  // N compute on zeros and write nothing.
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // the stage has landed, and the other buffer is free
    if (s + 1 < n_stages) stage(s + 1, buf ^ 1);
    const float4* tab = s_stage + (size_t)buf * stage_f4;
    if constexpr (kPair) {
#pragma unroll 1
      for (int j = 0; j < STEPS / 2; ++j) {
        const int ks = 2 * j + half;
        float a[4];
        rfe_a(tab, ks, a);
        store_a(s_a + 2 * ks * kWarp + lane, a);
      }
      __syncthreads();  // both warps' A fragments are in shared memory
    }
#pragma unroll 1
    for (int ks = 0; ks < STEPS; ++ks) {
      // the k-step's A fragment, then each n-tile's three products in
      // fresh accumulators
      uint32_t ah[4], al[4];
      if constexpr (kPair) {
        load_a(s_a + 2 * ks * kWarp + lane, ah, al);
      } else {
        float a[4];
        rfe_a(tab, ks, a);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32_int(a[e], ah[e], al[e]);
      }
      const float4* b = tab + (ks * RW + p.n_kc + half * NT) * kWarp + lane;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(d, ah, al, b[t * kWarp]);
        add4(acc[t], d);
      }
    }
  }

  // D fragment order: (n0, 2c), (n0, 2c + 1), (n1, 2c), (n1, 2c + 1).
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? n0 : n1, j = 8 * (z0 + half * NT + t) + 2 * fc + (e & 1);
      if (n < N && j < SC) Z[(size_t)n * SC + j] = acc[t][e];
    }
}
#endif  // FL_COMMON

#if FL_ANY_TYPED
// Forward, wide, the Y products [Y W | Y log mu^T] (NY = p.ny_pad tiles a
// column group) and A1 = sum_k psi_k (Y W)_k: grid (blocks of cells,
// p.n_ygroups column groups), one read of Y a group. As in
// fwd_wide_kernel, past 10 tiles two warps share 16 rows and each takes
// half the tiles (both form the A fragments from the staged Y). Where one
// warp holds every column of Y W (p.a1_parts == 0) it writes A1; else each
// warp writes its columns' share to row (group, half) of a1part, which the
// entry point adds up (reduce_chunks_kernel). Dynamic shared memory: two
// stage buffers of stage_f4 float4s, each 4 k-steps of the Y tiles
// ([k-step][tile][lane]), then each row group's 16 Y rows of 32 genes in
// the storage type.
template <int YT, int NY>
__global__ void __launch_bounds__(kFwdWarps * kWarp, 2)
fwd_wide_y_kernel(const typename YStore<YT>::Elem* __restrict__ Y, const float* __restrict__ psi,
                  const float4* __restrict__ table, float* __restrict__ A1,
                  float* __restrict__ A2, float* __restrict__ YW, float* __restrict__ a1part,
                  int N, int G, int Kf, int nA2, WidePlan p, int stage_f4, bool vec) {
  using Elem = typename YStore<YT>::Elem;
  constexpr int kRow = kFwdWideGenes + 16 / (int)sizeof(Elem);  // a staged Y row, padded 16 bytes
  constexpr bool kPair = NY > 10;
  constexpr int NT = kPair ? NY / 2 : NY;                      // tiles a warp
  constexpr int kGroups = kPair ? kFwdWarps / 2 : kFwdWarps;  // row groups a block
  extern __shared__ float4 s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int rg = warp % kGroups, half = warp / kGroups;
  const int fr = lane >> 2, fc = lane & 3;
  const int row0 = (blockIdx.x * kGroups + rg) * kFwdRows;
  const int n0 = row0 + fr, n1 = n0 + 8;
  const int n_tab = fwd_y_tile0(p) + p.n_ygroups * NY;
  const int y0 = fwd_y_tile0(p) + blockIdx.y * NY;  // the group's first tile

  // cp.async of stage s (genes [32 s, 32 s + 32)) into buffer buf: the
  // table's Y tiles, and the row group's 16 rows (by the first warp of the
  // group, whose lane copies the pieces pc = lane + 32 i: row pc / 8,
  // genes 4 (pc % 8) .. + 3).
  auto stage = [&](int s, int buf) {
    float4* dst = s_dyn + (size_t)buf * stage_f4;
    const int ks0 = s * kFwdWideSteps;
    for (int i = threadIdx.x; i < kFwdWideSteps * NY * kWarp; i += blockDim.x) {
      const int l = i % kWarp, r = (i / kWarp) % NY, ks = i / (kWarp * NY);
      cp_async_zfill<16>(dst + i, table + ((size_t)(ks0 + ks) * n_tab + y0 + r) * kWarp + l, 16);
    }
    if (half == 0) {
      Elem* sy = reinterpret_cast<Elem*>(dst + kFwdWideSteps * NY * kWarp) + rg * kFwdRows * kRow;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pc = lane + kWarp * i, r = pc >> 3, q = pc & 7, n = row0 + r;
        stage_y_piece<YT>(sy + r * kRow + 4 * q, Y + (size_t)(n < N ? n : 0) * G, n < N,
                          s * kFwdWideGenes + 4 * q, G, vec);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  const int n_stages = p.g_pad / kFwdWideGenes;
  stage(0, 0);
#pragma unroll 1
  for (int s = 0; s < n_stages; ++s) {
    const int buf = s & 1;
    cp_async_wait_all();
    __syncthreads();  // the stage has landed, and the other buffer is free
    if (s + 1 < n_stages) stage(s + 1, buf ^ 1);
    const float4* tab = s_dyn + (size_t)buf * stage_f4;
    const Elem* sy =
        reinterpret_cast<const Elem*>(tab + kFwdWideSteps * NY * kWarp) + rg * kFwdRows * kRow;
#pragma unroll 1
    for (int ks = 0; ks < kFwdWideSteps; ++ks) {
      // Y at the A positions (rows n0, n1; genes 2c, 2c + 1 of the k-step,
      // C-to-A order), exact, split into hi and lo; each n-tile's three
      // products in fresh accumulators.
      const float2 u = y_pair<YT>(sy + fr * kRow + 8 * ks + 2 * fc);
      const float2 v = y_pair<YT>(sy + (fr + 8) * kRow + 8 * ks + 2 * fc);
      const float c[4] = {u.x, u.y, v.x, v.y};
      uint32_t ah[4], al[4];
      c_to_a(c, ah, al);
      const float4* b = tab + (ks * NY + half * NT) * kWarp + lane;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(d, ah, al, b[t * kWarp]);
        add4(acc[t], d);
      }
    }
  }

  // D fragment order: (n0, 2c), (n0, 2c + 1), (n1, 2c), (n1, 2c + 1).
  float a1[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? n0 : n1, c = 8 * (blockIdx.y * NY + half * NT + t) + 2 * fc + (e & 1);
      if (n < N && c < Kf) {
        YW[(size_t)n * Kf + c] = acc[t][e];
        a1[e >> 1] = fmaf(psi[(size_t)n * Kf + c], acc[t][e], a1[e >> 1]);
      } else if (n < N && c < Kf + nA2) {
        A2[(size_t)n * nA2 + c - Kf] = acc[t][e];
      }
    }
  // A1: the 4 lanes of a row group hold disjoint columns.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a1[h] += __shfl_xor_sync(0xffffffffu, a1[h], 1);
    a1[h] += __shfl_xor_sync(0xffffffffu, a1[h], 2);
  }
  if (p.a1_parts == 0) {
    if (half == 0 && fc == 0 && n0 < N) A1[n0] = a1[0];
    if (half == 0 && fc == 0 && n1 < N) A1[n1] = a1[1];
  } else {
    float* row = a1part + (size_t)(blockIdx.y * (kPair ? 2 : 1) + half) * N;
    if (fc == 0 && n0 < N) row[n0] = a1[0];
    if (fc == 0 && n1 < N) row[n1] = a1[1];
  }
}
#endif  // FL_ANY_TYPED

#if FL_COMMON
// dpsi_wide_kernel's gene-side table, once a call: for each k-step of 8
// genes (g_pad / 8 of them), dk_pad + n_dgroups dz_group + dk_pad B
// fragments (hi0, hi1, lo0, lo1) of 32 lanes: W^T for log_rfe (K = columns
// of [psi, X], N = the k-step's genes in order), muL^T for drfe = dZ muL^T
// (K = dZ's columns, every group's tiles in turn; N = the genes in order),
// then W for dpsi += t W (K = the k-step's genes in C-to-A order: B's row c
// is gene 2c, row c + 4 gene 2c + 1; N = columns of [psi, X]). Zero past G
// and every width.
__global__ void dpsi_wide_pack_kernel(const float* __restrict__ W, const float* __restrict__ muL,
                                      float4* __restrict__ table, int G, int Kf, int SC,
                                      WidePlan p) {
  const int n_z = p.n_dgroups * p.dz_group, n_tab = p.dk_pad + n_z + p.dk_pad;
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)(p.g_pad / 8) * n_tab * kWarp) return;
  const int l = (int)(i % kWarp), r = (int)((i / kWarp) % n_tab), ks = (int)(i / kWarp / n_tab);
  float b0 = 0.f, b1 = 0.f;
  if (r < p.dk_pad) {
    const int g = 8 * ks + (l >> 2), k = 8 * r + (l & 3);
    if (g < G && k < Kf) b0 = W[(size_t)g * Kf + k];
    if (g < G && k + 4 < Kf) b1 = W[(size_t)g * Kf + k + 4];
  } else if (r < p.dk_pad + n_z) {
    const int g = 8 * ks + (l >> 2), j = 8 * (r - p.dk_pad) + (l & 3);
    if (g < G && j < SC) b0 = muL[(size_t)g * SC + j];
    if (g < G && j + 4 < SC) b1 = muL[(size_t)g * SC + j + 4];
  } else {
    const int g = 8 * ks + 2 * (l & 3), k = 8 * (r - p.dk_pad - n_z) + (l >> 2);
    if (g < G && k < Kf) b0 = W[(size_t)g * Kf + k];
    if (g + 1 < G && k < Kf) b1 = W[(size_t)(g + 1) * Kf + k];
  }
  const float2 h0 = tf32_pair(b0), h1 = tf32_pair(b1);
  table[i] = make_float4(h0.x, h1.x, h0.y, h1.y);
}

// Backward, wide, Y-free: dpsi[n,k] = dA1[n] YW[n,k] + sum_g t[n,g] W[g,k],
// t = rfe drfe, rfe = exp(psi W^T), drfe = dZ muL^T. Grid: blocks of
// kDpsiWarps x 16 cells; each warp owns 16 cell rows (the M of mma.sync
// m16n8k8) and walks the genes in k-steps of 8, p.dsteps k-steps a stage
// of the ring. NK tiles of [psi, X] (p.dk_pad) and NZ dZ tiles a column
// group (p.dz_group) are built counts, so that the tiles' chains of
// dependent MMAs interleave; the p.n_dgroups groups run one after another.
// Per k-step: log_rfe by MMA, drfe by NZ MMAs (each tile's products in
// fresh accumulators added on CUDA cores), one exp an element, t split into
// the A fragment of dpsi's MMA against W. Registers hold dZ's fragments,
// the stage's float32 sums and one k-step's work: with two k-steps
// unrolled, or the float64 sums or psi's split fragments in registers,
// ptxas spilled at 168 registers (the bound of three blocks an SM) from NZ
// = 8; three blocks an SM at NK = 1, two past it, where log_rfe's tiles
// are unrolled by two from NK = 4 (fully unrolled, NK = 8 spilled at 255).
// Dynamic shared memory: each warp's psi A fragments as floats
// ([warp][kc][lane]), each warp's float64 sums of dpsi
// ([warp][kc][element][lane]), then two stage buffers of stage_f4 float4s
// ([k-step][W^T tiles | the group's muL^T tiles | the output group's W
// tiles][lane]).
template <int NK, int NZ>
__global__ void __launch_bounds__(kDpsiWarps * kWarp, NK == 1 ? 3 : 2)
dpsi_wide_kernel(const float* __restrict__ psi, const float* __restrict__ dZ,
                 const float* __restrict__ dA1, const float* __restrict__ YW,
                 const float4* __restrict__ table, float* __restrict__ dpsi, int N, int Kf,
                 int SC, WidePlan p, int stage_f4) {
  const int RW = 2 * NK + NZ;  // table tiles a k-step of a stage
  constexpr int kLrUnroll = NK >= 4 ? 2 : NK;  // log_rfe's tiles unrolled
  extern __shared__ float4 s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  // MMA fragments: A rows (cells) n0 and n1, A columns c and c + 4; C
  // columns 2c and 2c + 1.
  const int fr = lane >> 2, fc = lane & 3;
  const int n0 = (blockIdx.x * kDpsiWarps + warp) * kFwdRows + fr, n1 = n0 + 8;
  const int n_tab = NK + p.n_dgroups * NZ + NK;
  float4* s_psi = s_dyn + warp * NK * kWarp;
  double* s_acc = reinterpret_cast<double*>(s_dyn + kDpsiWarps * NK * kWarp) + warp * NK * 4 * kWarp;
  float4* s_stage = s_dyn + kDpsiWarps * (NK + 2 * NK) * kWarp;

  // psi's A fragments (rows n0, n1; columns 8 kc + c, + 4), as floats,
  // split where they are used; and dpsi's float64 sums ([kc][element][lane]).
  // Each lane reads back only its own.
#pragma unroll
  for (int kc = 0; kc < NK; ++kc) {
    const int k0 = 8 * kc + fc, k1 = k0 + 4;
    s_psi[kc * kWarp + lane] = make_float4(n0 < N && k0 < Kf ? psi[(size_t)n0 * Kf + k0] : 0.f,
                                           n1 < N && k0 < Kf ? psi[(size_t)n1 * Kf + k0] : 0.f,
                                           n0 < N && k1 < Kf ? psi[(size_t)n0 * Kf + k1] : 0.f,
                                           n1 < N && k1 < Kf ? psi[(size_t)n1 * Kf + k1] : 0.f);
  }
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[(4 * kc + e) * kWarp + lane] = 0.0;

  const int n_stages = p.g_pad / (8 * p.dsteps);
  // No early exit: every warp takes part in the block's barriers; rows past
  // N compute on zeros and write nothing.
#pragma unroll 1
  for (int grp = 0; grp < p.n_dgroups; ++grp) {
    // dZ's A fragments of the group's tiles (rows n0, n1; columns 8 jt + c,
    // + 4; zero past N and S*C), split once a group.
    uint32_t zh[NZ][4], zl[NZ][4];
#pragma unroll
    for (int t = 0; t < NZ; ++t) {
      const int j0 = 8 * (grp * NZ + t) + fc, j1 = j0 + 4;
      const float v[4] = {n0 < N && j0 < SC ? dZ[(size_t)n0 * SC + j0] : 0.f,
                          n1 < N && j0 < SC ? dZ[(size_t)n1 * SC + j0] : 0.f,
                          n0 < N && j1 < SC ? dZ[(size_t)n0 * SC + j1] : 0.f,
                          n1 < N && j1 < SC ? dZ[(size_t)n1 * SC + j1] : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32_int(v[e], zh[t][e], zl[t][e]);
    }
    // cp.async of stage s (genes [8 dsteps s, 8 dsteps (s + 1))) into
    // buffer buf: the k-steps' W^T tiles, the group's muL^T tiles, W tiles.
    auto stage = [&](int s, int buf) {
      float4* dst = s_stage + (size_t)buf * stage_f4;
      const int ks0 = s * p.dsteps;
      for (int i = threadIdx.x; i < p.dsteps * RW * kWarp; i += blockDim.x) {
        const int l = i % kWarp, r = (i / kWarp) % RW, ks = i / (kWarp * RW);
        const int src = r < NK         ? r
                        : r < NK + NZ  ? r + grp * NZ
                                       : r + (p.n_dgroups - 1) * NZ;
        cp_async_zfill<16>(dst + i, table + ((size_t)(ks0 + ks) * n_tab + src) * kWarp + l, 16);
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
      const float4* tab = s_stage + (size_t)buf * stage_f4;
      float sacc[NK][4];  // the stage's dpsi, in float32
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[kc][e] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < p.dsteps; ++ks) {
        const float4* b = tab + ks * RW * kWarp + lane;
        // log_rfe and drfe at C positions (n0, 2c), (n0, 2c + 1), (n1, 2c),
        // (n1, 2c + 1) of the k-step's genes
        float lr[4] = {0.f, 0.f, 0.f, 0.f}, dr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll kLrUnroll
        for (int kc = 0; kc < NK; ++kc) {
          const float4 q = s_psi[kc * kWarp + lane];
          const float pv[4] = {q.x, q.y, q.z, q.w};
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32_int(pv[e], ph[e], pl[e]);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, ph, pl, b[kc * kWarp]);
          add4(lr, d);
        }
#pragma unroll
        for (int t = 0; t < NZ; ++t) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, zh[t], zl[t], b[(NK + t) * kWarp]);
          add4(dr, d);
        }
        float tv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[e] = __expf(lr[e]) * dr[e];
        uint32_t th[4], tl[4];
        c_to_a(tv, th, tl);
#pragma unroll
        for (int kc = 0; kc < NK; ++kc) {
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, th, tl, b[(NK + NZ + kc) * kWarp]);
          add4(sacc[kc], d);
        }
      }
#pragma unroll
      for (int kc = 0; kc < NK; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[(4 * kc + e) * kWarp + lane] += sacc[kc][e];
    }
  }

  // D fragment order: (n0, 2c), (n0, 2c + 1), (n1, 2c), (n1, 2c + 1) of
  // each tile of [psi, X]'s columns; dA1 YW added last, in float64.
#pragma unroll
  for (int kc = 0; kc < NK; ++kc)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = e < 2 ? n0 : n1, k = 8 * kc + 2 * fc + (e & 1);
      if (n < N && k < Kf)
        dpsi[(size_t)n * Kf + k] = (float)fma((double)dA1[n], (double)YW[(size_t)n * Kf + k],
                                              s_acc[(4 * kc + e) * kWarp + lane]);
    }
}
#endif  // FL_COMMON

#if FL_COMMON
// The gene part's cell side, once a call, as (hi, lo) TF32 pairs: dZ
// (n_pad x 8 mu_passes nj), psi (n_pad x 8 n_kc) and dA2 (n_pad x 8 n_st);
// and dA1 (n_pad floats). Zero past N and every width.
__global__ void gene_wide_pack_kernel(const float* __restrict__ psi, const float* __restrict__ dA1,
                                      const float* __restrict__ dA2, const float* __restrict__ dZ,
                                      float2* __restrict__ dz, float2* __restrict__ ps,
                                      float2* __restrict__ a2, float* __restrict__ a1, int N,
                                      int Kf, int nA2, int SC, WidePlan p) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const int dz_cols = 8 * p.mu_passes * p.nj;
  const long long nd = (long long)p.n_pad * dz_cols, np = (long long)p.n_pad * 8 * p.n_kc,
                  na = (long long)p.n_pad * 8 * p.n_st;
  if (i < nd) {
    const int n = (int)(i / dz_cols), j = (int)(i % dz_cols);
    dz[i] = tf32_pair(n < N && j < SC ? dZ[(size_t)n * SC + j] : 0.f);
  } else if (i < nd + np) {
    const long long e = i - nd;
    const int n = (int)(e / (8 * p.n_kc)), k = (int)(e % (8 * p.n_kc));
    ps[e] = tf32_pair(n < N && k < Kf ? psi[(size_t)n * Kf + k] : 0.f);
  } else if (i < nd + np + na) {
    const long long e = i - nd - np;
    const int n = (int)(e / (8 * p.n_st)), s = (int)(e % (8 * p.n_st));
    a2[e] = tf32_pair(n < N && s < nA2 ? dA2[(size_t)n * nA2 + s] : 0.f);
  } else if (i < nd + np + na + p.n_pad) {
    const int n = (int)(i - nd - np - na);
    a1[n] = n < N ? dA1[n] : 0.f;
  }
}
#endif  // FL_COMMON

// Row strides (in (hi, lo) pairs) of a gene-part stage's dZ, psi and dA2
// rows: 4 past a whole number of 8-column tiles, so that the 8 x 4 reads of
// a B fragment (cell l / 4, column l % 4) hit distinct banks.
__host__ __device__ inline int gene_dz_stride(const WidePlan& p) { return 8 * p.nj + 4; }
__host__ __device__ inline int gene_ps_stride(const WidePlan& p) { return 8 * p.n_kc + 4; }
__host__ __device__ inline int gene_a2_stride(const WidePlan& p) {
  return p.n_st ? 8 * p.n_st + 4 : 0;
}


#if FL_ANY_TYPED
// Backward, wide, gene part: part[chunk, f, g] for f in [dW^T (Kf rows) |
// d(muL)^T (SC rows) | dlog_mu (nA2 rows)] over one chunk of cells. Grid
// (blocks of kGeneWideGenes genes, p.n_chunks chunks). Accumulator tiles:
// [0, NJ) d(muL) of a pass's NJ = p.nj columns tiles (every loop over them
// runs NJ times, so their MMA chains interleave), then dW's n_kc tiles
// (summed over every pass) and, in the first pass, dlog mu's n_st. (In a
// pass of its own, first, where p.y_pass, dlog mu takes d(muL)'s tiles, so
// they stay apart from dW's.) Three blocks an SM up to NJ = 10, two past
// it. Dynamic shared memory: W's A fragments of each warp as floats ([warp][kc][lane])
// and the pass's muL A fragments split ([warp][tile][hi, lo][lane]), then
// two stage buffers of stage_f4
// float4s: 16 cells' dZ pairs of the pass's columns, psi pairs, dA2 pairs
// (the first pass), dA1, and Y's rows of the block's 64 genes in the
// storage type.
template <int YT, int NJ>
__global__ void __launch_bounds__(kGeneWideWarps * kWarp, NJ > 10 ? 2 : 3)
gene_wide_kernel(const typename YStore<YT>::Elem* __restrict__ Y, const float* __restrict__ W,
                 const float* __restrict__ muL, const float2* __restrict__ dzp,
                 const float2* __restrict__ psp, const float2* __restrict__ a2p,
                 const float* __restrict__ a1p, float* __restrict__ part, int N, int G, int Kf,
                 int nA2, int SC, WidePlan p, int stage_f4, bool vec) {
  using Elem = typename YStore<YT>::Elem;
  constexpr int kRow = kGeneWideGenes + 16 / (int)sizeof(Elem);  // a staged Y row, padded 16 bytes
  constexpr int kSteps2 = kGeneWideCells / 8;
  constexpr int NT = kWideTiles;
  extern __shared__ float4 s_dyn[];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  // MMA fragments: A rows (genes) g0 and g1, A columns c and c + 4 of a
  // k-step; C columns (cells of the k-step) 2c and 2c + 1.
  const int fr = lane >> 2, fc = lane & 3;
  const int gb = blockIdx.x * kGeneWideGenes, gl0 = warp * kFwdRows + fr;
  const int g0 = gb + gl0, g1 = g0 + 8;
  const int chunk = blockIdx.y;
  const int n_begin = chunk * p.rows;
  const int n_stages = (min(N, n_begin + p.rows) - n_begin + kGeneWideCells - 1) / kGeneWideCells;
  const int F = Kf + SC + nA2;
  const int dz_cols = 8 * p.mu_passes * NJ;  // packed dZ columns (pairs) a cell
  const int sdz = gene_dz_stride(p), sps = gene_ps_stride(p);
  const int sa2 = gene_a2_stride(p);
  float4* s_w = s_dyn + warp * p.n_kc * kWarp;
  float4* s_mu = s_dyn + kGeneWideWarps * p.n_kc * kWarp + warp * NJ * 2 * kWarp;
  float4* s_stage = s_dyn + kGeneWideWarps * (p.n_kc * kWarp + NJ * 2 * kWarp);

  // W's A fragments (genes g0, g1; columns 8 kc + c, + 4), as floats, split
  // where they are used (the fragment is a small share of the MMAs, and
  // unsplit it takes half the room); each lane reads back only its own.
#pragma unroll 1
  for (int kc = 0; kc < p.n_kc; ++kc) {
    const int k0 = 8 * kc + fc, k1 = k0 + 4;
    s_w[kc * kWarp + lane] = make_float4(g0 < G && k0 < Kf ? W[(size_t)g0 * Kf + k0] : 0.f,
                                         g1 < G && k0 < Kf ? W[(size_t)g1 * Kf + k0] : 0.f,
                                         g0 < G && k1 < Kf ? W[(size_t)g0 * Kf + k1] : 0.f,
                                         g1 < G && k1 < Kf ? W[(size_t)g1 * Kf + k1] : 0.f);
  }

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

#pragma unroll 1
  for (int pass = 0; pass < p.n_passes; ++pass) {
    const bool first = pass == 0;
    const bool with_mu = !(first && p.y_pass);
    const int jt_begin = (pass - p.y_pass) * NJ;
    const int ny = first ? p.n_st : 0;  // dlog mu's tiles in this pass
    const bool with_y = first;  // Y staged: Y dA1's term, and dlog mu
    // dlog mu's first accumulator tile: after dW's, or in a pass of its own
    // in place of d(muL)'s
    const int t_mu = p.y_pass ? 0 : NJ + p.n_kc;
    // muL's A fragments of the pass's columns (genes g0, g1; columns 8 jt +
    // c, + 4; zero past SC), split once a pass; each lane reads back only
    // its own. A pass without d(muL) has zero fragments: drfe = 0.
#pragma unroll 1
    for (int jj = 0; jj < NJ; ++jj) {
      const int j0 = 8 * (jt_begin + jj) + fc, j1 = j0 + 4;
      const bool in = with_mu;
      const float v[4] = {in && g0 < G && j0 < SC ? muL[(size_t)g0 * SC + j0] : 0.f,
                          in && g1 < G && j0 < SC ? muL[(size_t)g1 * SC + j0] : 0.f,
                          in && g0 < G && j1 < SC ? muL[(size_t)g0 * SC + j1] : 0.f,
                          in && g1 < G && j1 < SC ? muL[(size_t)g1 * SC + j1] : 0.f};
      store_a(s_mu + 2 * jj * kWarp + lane, v);
    }
#pragma unroll
    for (int t = 0; t < NJ; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

    // cp.async of stage s (cells [n_begin + 16 s, + 16)) into buffer buf.
    // The chunks' cells are whole stages, and the packed cell side runs to
    // n_pad, so no row is masked; Y's rows past N are zero-filled.
    auto stage = [&](int s, int buf) {
      float* base = reinterpret_cast<float*>(s_stage + (size_t)buf * stage_f4);
      const int c0 = n_begin + s * kGeneWideCells;
      if (with_mu) {
        constexpr int wdz = 4 * NJ;  // float4s a cell row
        for (int i = threadIdx.x; i < kGeneWideCells * wdz; i += blockDim.x) {
          const int c = i / wdz, w = i % wdz;
          cp_async_zfill<16>(base + 2 * c * sdz + 4 * w,
                             dzp + (size_t)(c0 + c) * dz_cols + 8 * jt_begin + 2 * w, 16);
        }
      }
      float* b_ps = base + 2 * kGeneWideCells * sdz;
      const int wps = 4 * p.n_kc;
      for (int i = threadIdx.x; i < kGeneWideCells * wps; i += blockDim.x) {
        const int c = i / wps, w = i % wps;
        cp_async_zfill<16>(b_ps + 2 * c * sps + 4 * w, psp + (size_t)(c0 + c) * 8 * p.n_kc + 2 * w, 16);
      }
      if (with_y) {
        float* b_a2 = b_ps + 2 * kGeneWideCells * sps;
        const int wa2 = 4 * p.n_st;
        for (int i = threadIdx.x; i < kGeneWideCells * wa2; i += blockDim.x) {
          const int c = i / wa2, w = i % wa2;
          cp_async_zfill<16>(b_a2 + 2 * c * sa2 + 4 * w,
                             a2p + (size_t)(c0 + c) * 8 * p.n_st + 2 * w, 16);
        }
        float* b_a1 = b_a2 + 2 * kGeneWideCells * sa2;
        if (threadIdx.x < kGeneWideCells / 4)
          cp_async_zfill<16>(b_a1 + 4 * threadIdx.x, a1p + c0 + 4 * threadIdx.x, 16);
        // Y: 16 rows of 16 pieces (the block's 64 genes); thread t copies
        // pieces t and t + 128
        Elem* sy = reinterpret_cast<Elem*>(b_a1 + kGeneWideCells);
        for (int i = threadIdx.x; i < kGeneWideCells * kGeneWideGenes / 4; i += blockDim.x) {
          const int r = i / (kGeneWideGenes / 4), q = i % (kGeneWideGenes / 4), n = c0 + r;
          stage_y_piece<YT>(sy + r * kRow + 4 * q, Y + (size_t)(n < N ? n : 0) * G, n < N,
                            gb + 4 * q, G, vec);
        }
      }
      cp_async_commit();
    };

    __syncthreads();  // the previous pass is done with the ring
    stage(0, 0);
#pragma unroll 1
    for (int s = 0; s < n_stages; ++s) {
      const int buf = s & 1;
      cp_async_wait_all();
      __syncthreads();  // the stage has landed, and the other buffer is free
      if (s + 1 < n_stages) stage(s + 1, buf ^ 1);
      const float* base = reinterpret_cast<const float*>(s_stage + (size_t)buf * stage_f4);
      const float2* s_dz = reinterpret_cast<const float2*>(base);
      const float2* s_ps = reinterpret_cast<const float2*>(base + 2 * kGeneWideCells * sdz);
      const float2* s_a2 = s_ps + kGeneWideCells * sps;
      const float* s_a1 = reinterpret_cast<const float*>(s_a2 + kGeneWideCells * sa2);
      const Elem* sy = reinterpret_cast<const Elem*>(s_a1 + kGeneWideCells);
      // The stage's k-steps unrolled, so that one k-step's chain (log_rfe,
      // exp, drfe, dlog_rfe, dW) runs beside the other's.
#pragma unroll
      for (int h2 = 0; h2 < kSteps2; ++h2) {
        const int cb = 8 * h2;  // the k-step's first cell in the stage
        // log_rfe^T (genes g0, g1; cells cb + 2c, + 1) = W psi^T: B = psi^T
        // at (k = 8 kc + c (+ 4), cell cb + l / 4).
        float lr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
        for (int kc = 0; kc < p.n_kc; ++kc) {
          const float4 w = s_w[kc * kWarp + lane];
          const float wv[4] = {w.x, w.y, w.z, w.w};
          uint32_t wh[4], wl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32_int(wv[e], wh[e], wl[e]);
          const float2* q = s_ps + (cb + fr) * sps + 8 * kc + fc;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, wh, wl, pair_b(q[0], q[4]));
          add4(lr, d);
        }
        float rfe[4], dl[4] = {0.f, 0.f, 0.f, 0.f}, y[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) rfe[e] = __expf(lr[e]);
        if (with_mu) {
          // drfe^T = muL dZ^T over the pass's columns: B = dZ^T at (j = 8 jj +
          // c (+ 4), cell cb + l / 4); each tile's products in fresh
          // accumulators. Then d(muL) += rfe^T dZ: B rows c and c + 4 are
          // cells cb + 2c and cb + 2c + 1 (C-to-A order), B column l / 4.
          const float2* q = s_dz + (cb + fr) * sdz + fc;
#pragma unroll 2
          for (int jj = 0; jj < NJ; ++jj) {
            uint32_t mh[4], ml[4];
            load_a(s_mu + 2 * jj * kWarp + lane, mh, ml);
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(d, mh, ml, pair_b(q[8 * jj], q[8 * jj + 4]));
            add4(dl, d);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dl[e] *= rfe[e];
          uint32_t ah[4], al[4];
          c_to_a(rfe, ah, al);
          const float2* q_dz = s_dz + (cb + 2 * fc) * sdz + fr;
#pragma unroll
          for (int t = 0; t < NJ; ++t) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(d, ah, al, pair_b(q_dz[8 * t], q_dz[sdz + 8 * t]));
            add4(acc[t], d);
          }
        }
        // dlog_rfe = rfe drfe (+ Y dA1 in the first pass), at C positions
        // (g0, cb + 2c), (g0, cb + 2c + 1), (g1, ...), (g1, ...).
        if (with_y) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = cb + 2 * fc + (e & 1);
            y[e] = y_one<YT>(sy[c * kRow + gl0 + 8 * (e >> 1)]);
            if (first) dl[e] = fmaf(y[e], s_a1[c], dl[e]);
          }
        }
        {  // dW += dlog_rfe^T psi
          uint32_t ah[4], al[4];
          c_to_a(dl, ah, al);
          const float2* q_ps = s_ps + (cb + 2 * fc) * sps + fr;
#pragma unroll
          for (int t = NJ; t < NT; ++t) {
            if (t - NJ < p.n_kc) {
              const int k8 = 8 * (t - NJ);
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(d, ah, al, pair_b(q_ps[k8], q_ps[sps + k8]));
              add4(acc[t], d);
            }
          }
        }
        if (ny > 0) {  // dlog mu += Y^T dA2
          uint32_t ah[4], al[4];
          c_to_a(y, ah, al);
          const float2* q_a2 = s_a2 + (cb + 2 * fc) * sa2 + fr;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const int u = t - t_mu;
            if (u >= 0 && u < ny) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_3xtf32(d, ah, al, pair_b(q_a2[8 * u], q_a2[sa2 + 8 * u]));
              add4(acc[t], d);
            }
          }
        }
      }
    }

    // The pass's d(muL) columns and, in the first pass, dlog mu. D fragment
    // order: (g0, 2c), (g0, 2c + 1), (g1, 2c), (g1, 2c + 1).
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = e < 2 ? g0 : g1, c = 2 * fc + (e & 1);
        if (g >= G) continue;
        const int s8 = 8 * (t - t_mu) + c;
        if (first && s8 >= 0 && s8 < 8 * p.n_st) {
          if (s8 < nA2) part[((size_t)chunk * F + Kf + SC + s8) * G + g] = acc[t][e];
        } else if (t < NJ && with_mu) {
          const int j = 8 * (jt_begin + t) + c;
          if (j < SC) part[((size_t)chunk * F + Kf + j) * G + g] = acc[t][e];
        }
      }
    }
  }
  // dW, summed over every pass.
#pragma unroll
  for (int t = NJ; t < NT; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int g = e < 2 ? g0 : g1, k = 8 * (t - NJ) + 2 * fc + (e & 1);
      if (g < G && k < Kf && t - NJ < p.n_kc) part[((size_t)chunk * F + k) * G + g] = acc[t][e];
    }
  }
}
#endif  // FL_ANY_TYPED

// ---------------------------------------------------------------------------
// The split backward, past the old bound (see the note at the top): tiled
// 3xTF32 products over row blocks of plan.rows cells. dlog_rfe_kernel
// writes a row block's rfe and dlog_rfe (or t = rfe drfe, without Y) to the
// workspace; gene_product_kernel takes dW^T = psi^T dlog_rfe, d(muL)^T =
// dZ^T rfe and dlog mu = dA2^T Y from them, summed over the row blocks in
// order into the output; dpsi_product_kernel takes t W over ranges of
// genes, which dpsi_sum_kernel adds beside dA1 YW. The copies, the ring and
// the epilogue's walk are split_tiles.cuh's.
// ---------------------------------------------------------------------------
constexpr int kSbM = 64, kSbN = 64, kSbK = 32;  // a block's tile of outputs, and K a stage
constexpr int kSbThreads = 8 * kWarp;  // two K groups of 2 x 2 warps of 32 x 32, two blocks an SM
constexpr int kSbGroup = 4 * kWarp;    // a group's threads
constexpr int kSbStages = 3;           // the cp.async ring
// Row pitches (floats) of a stage's tiles, whose rows hold K, M or N
// values, padded so that a fragment's 32 reads hit 32 banks.
constexpr int kSbPitchK = kSbK + 4, kSbPitchM = kSbM + 8, kSbPitchN = kSbN + 8;
// A stage's floats: dlog_rfe_kernel's cell and gene tiles (rows of K
// values), dpsi_product_kernel's cell tile and W's (rows of K, of N
// values), gene_product_kernel's cell side and workspace tile (rows of M, of
// N values) or Y's tile, rows of sb_y_pitch bytes.
constexpr int kSbStageDlog = (kSbM + kSbN) * kSbPitchK;
constexpr int kSbStageDpsi = kSbM * kSbPitchK + kSbK * kSbPitchN;
constexpr int kSbStageGene = kSbK * (kSbPitchM + kSbPitchN);
__host__ __device__ constexpr int sb_y_pitch(int y_bytes) {
  return y_bytes == 4 ? 4 * kSbPitchN : kSbN * y_bytes + 16;
}
__host__ __device__ constexpr int sb_stage_gene_y(int y_bytes) {
  return kSbK * (kSbPitchM + sb_y_pitch(y_bytes) / 4);
}
constexpr int sb_smem(int stage_floats) { return 4 * kSbStages * stage_floats; }
// The operands and jobs of split_tiles.cuh, in floats.
using SbMat = TileMat<float>;
using SbJob = TileJob<float>;
using SbJobs = TileJobs<float>;

// Rows [r0, r0 + kSbK) x genes [c0, c0 + kSbN) of Y (rows
// ldy apart; rows x cols) into s in the storage type, rows sb_y_pitch bytes
// apart, by the threads' own loads (zero past rows and cols; vec as
// load_y4's).
template <int YT>
__device__ __forceinline__ void sb_load_y(char* s, const typename YStore<YT>::Elem* __restrict__ Y,
                                          long long ldy, int rows, int cols, int r0, int c0,
                                          bool vec) {
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  constexpr int kPitch = sb_y_pitch(sizeof(Elem)), kT = kSbThreads;
#pragma unroll
  for (int u = 0; u < kSbK * kSbN / 4 / kT; ++u) {
    const int i = threadIdx.x + u * kT, r = i / (kSbN / 4), c = 4 * (i % (kSbN / 4));
    const int gr = r0 + r;
    const Piece v = gr < rows ? load_y4<YT>(Y + gr * ldy, c0 + c, cols, vec) : Piece{};
    *reinterpret_cast<Piece*>(s + r * kPitch + c * (int)sizeof(Elem)) = v;
  }
}

// acc += A B over the thread's group's half of one stage's kSbK values of
// K (a pair of k-steps; group g takes [16 g, 16 g + 16)) for the warp's 32
// x 32 part of the block's tile: A's (m, k) in sa (rows of PA values of K,
// or where A_KROWS of M), B's (k, n) from bval. The pair's three TF32
// products (lo.hi, hi.lo, hi.hi, split as cvt.rna does) go to fresh
// accumulators added on CUDA cores: a chain of 6 MMAs, and one float32 add
// an element for 16 of K. The groups' sums are added at the end
// (sb_reduce): twice the warps a tile of outputs, for grids of few tiles.
template <bool A_KROWS, int PA, class BVal>
__device__ __forceinline__ void sb_stage(const float* sa, BVal&& bval, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x % kSbGroup / kWarp;
  const int fr = lane >> 2, fc = lane & 3;
  const int wm = 32 * (warp / 2), wn = 32 * (warp % 2);
  const int k2 = 16 * (threadIdx.x / kSbGroup);
  auto a = [&](int m, int k) { return A_KROWS ? sa[k * PA + m] : sa[m * PA + k]; };
  float d[2][4][4] = {};
#pragma unroll
  for (int kk = k2; kk < k2 + 16; kk += 8) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = wm + 16 * i + fr, k = kk + fc;
      split_tf32_int(a(m, k), ah[i][0], al[i][0]);
      split_tf32_int(a(m + 8, k), ah[i][1], al[i][1]);
      split_tf32_int(a(m, k + 4), ah[i][2], al[i][2]);
      split_tf32_int(a(m + 8, k + 4), ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = wn + 8 * j + fr, k = kk + fc;
      split_tf32_int(bval(k, n), bh[j][0], bl[j][0]);
      split_tf32_int(bval(k + 4, n), bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_tf32(d[i][j], al[i], bh[j][0], bh[j][1]);
        mma_tf32(d[i][j], ah[i], bl[j][0], bl[j][1]);
        mma_tf32(d[i][j], ah[i], bh[j][0], bh[j][1]);
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) add4(acc[i][j], d[i][j]);
}

// acc of the first group's threads += the second group's (at the same
// fragment positions), through the ring's shared memory once the block is
// done with it; the first group then holds the sums over all of K.
__device__ __forceinline__ void sb_reduce(float (&acc)[2][4][4], float* smem) {
  const int t = threadIdx.x % kSbGroup;
  __syncthreads();  // the block is done with the ring
  if (threadIdx.x >= kSbGroup) {
#pragma unroll
    for (int e = 0; e < 32; ++e) smem[e * kSbGroup + t] = (&acc[0][0][0])[e];
  }
  __syncthreads();
  if (threadIdx.x < kSbGroup) {
#pragma unroll
    for (int e = 0; e < 32; ++e) (&acc[0][0][0])[e] += smem[e * kSbGroup + t];
  }
}

// What dlog_rfe_kernel writes beside rfe: t = rfe drfe (kOutT, for dpsi
// alone), dlog_rfe = rfe drfe + Y dA1 (kOutDlog, with Y), or nothing
// (kOutRfe, the split forward's rfe alone).
constexpr int kOutT = 0, kOutDlog = 1, kOutRfe = 2;

// A row block's rfe = exp(psi W^T) and, as OUT says, dlog_rfe = rfe drfe +
// Y dA1 or t = rfe drfe, drfe = dZ muL^T: grid (tiles of kSbN genes,
// tiles of kSbM cells). log_rfe is formed first,
// its exps stored to rfe at once (rfe may be dl: each thread reads back
// only what it wrote), then drfe in the same accumulators. Rows of psi, dZ
// and Y are the block's.
template <int YT, int OUT>
__global__ void __launch_bounds__(kSbThreads, 2)
dlog_rfe_kernel(const typename YStore<YT>::Elem* __restrict__ Y, const float* __restrict__ dA1,
                SbMat psi, SbMat W, SbMat dZ, SbMat muL, float* rfe, float* dl, long long ldw) {
  constexpr int BK = kSbK, P = kSbPitchK, BM = kSbM, kStage = kSbStageDlog;
  extern __shared__ float4 s_sb[];
  float* smem = reinterpret_cast<float*>(s_sb);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kSbN;  // the tile's first cell and gene
  const int rows = psi.rows, G = W.rows;
  float acc[2][4][4];
  auto product = [&](const SbMat& a, const SbMat& b) {  // acc = a b^T over a's columns
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    tile_mainloop<kSbStages>(
        (a.cols + BK - 1) / BK,
        [&](int kt, int buf) {
          float* s = smem + buf * kStage;
          tile_load<kSbThreads, BM, BK, P>(s, a, m0, kt * BK);
          tile_load<kSbThreads, kSbN, BK, P>(s + BM * P, b, n0, kt * BK);
        },
        [&](int buf) {
          const float* s = smem + buf * kStage;
          const float* sb = s + BM * P;
          sb_stage<false, P>(s, [&](int k, int n) { return sb[n * P + k]; }, acc);
        });
    sb_reduce(acc, smem);
  };
  product(psi, W);
  tile_each_pair<kSbGroup>([&](int r, int c, int i, int j, int h) {
    const int n = m0 + r, g = n0 + c;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (n < rows && g + u < G) rfe[n * ldw + g + u] = __expf(acc[i][j][2 * h + u]);
  });
  if constexpr (OUT != kOutRfe) {
    product(dZ, muL);
    tile_each_pair<kSbGroup>([&](int r, int c, int i, int j, int h) {
      const int n = m0 + r, g = n0 + c;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (n >= rows || g + u >= G) continue;
        float t = rfe[n * ldw + g + u] * acc[i][j][2 * h + u];
        if constexpr (OUT == kOutDlog)
          t = fmaf(y_one<YT>(Y[(long long)n * G + g + u]), dA1[n], t);
        dl[n * ldw + g + u] = t;
      }
    });
  }
}

// The gene-side products of a row block: grid (tiles of kSbN genes, the
// first job's m_tiles then the second's tiles of kSbM rows f, slices of
// zcells cells), K the slice's cells. YV: v is
// Y (the block's rows, in its storage type; y_vec as load_y4's), else the
// jobs' own v. Slice z writes out + z zstride, the first row block's
// (first) or adds to it, in order.
template <int YT, bool YV>
__global__ void __launch_bounds__(kSbThreads, 2)
gene_product_kernel(SbJobs jobs, const typename YStore<YT>::Elem* __restrict__ Y, bool y_vec,
                    int G, bool first, int zcells, long long zstride) {
  using Elem = typename YStore<YT>::Elem;
  constexpr int BK = kSbK;
  extern __shared__ float4 s_sb[];
  float* smem = reinterpret_cast<float*>(s_sb);
  constexpr int kA = BK * kSbPitchM;
  constexpr int kStage = YV ? sb_stage_gene_y(sizeof(Elem)) : kSbStageGene;
  const int second = (int)blockIdx.y >= jobs.job[0].m_tiles;
  const SbJob& job = jobs.job[second];
  const int m0 = ((int)blockIdx.y - (second ? jobs.job[0].m_tiles : 0)) * kSbM;
  const int n0 = blockIdx.x * kSbN;
  const int c0 = blockIdx.z * zcells;  // the slice's cells
  const int rows = min(zcells, job.x.rows - c0);
  SbMat x = job.x, v = job.v;
  x.p += c0 * x.ld;
  x.rows = rows;
  v.p += c0 * v.ld;
  v.rows = rows;
  float acc[2][4][4] = {};
  tile_mainloop<kSbStages>(
      (rows + BK - 1) / BK,
      [&](int kt, int buf) {
        float* s = smem + buf * kStage;
        tile_load<kSbThreads, BK, kSbM, kSbPitchM>(s, x, kt * BK, m0);
        if constexpr (YV)
          sb_load_y<YT>(reinterpret_cast<char*>(s + kA), Y + (long long)c0 * G, G, rows, G,
                        kt * BK, n0, y_vec);
        else
          tile_load<kSbThreads, BK, kSbN, kSbPitchN>(s + kA, v, kt * BK, n0);
      },
      [&](int buf) {
        const float* s = smem + buf * kStage;
        if constexpr (YV) {
          constexpr int kP = sb_y_pitch(sizeof(Elem)) / (int)sizeof(Elem);
          const Elem* sy = reinterpret_cast<const Elem*>(s + kA);
          sb_stage<true, kSbPitchM>(
              s, [&](int k, int n) { return y_one<YT>(sy[k * kP + n]); }, acc);
        } else {
          const float* sv = s + kA;
          sb_stage<true, kSbPitchM>(s, [&](int k, int n) { return sv[k * kSbPitchN + n]; },
                                        acc);
        }
      });
  sb_reduce(acc, smem);
  float* out = job.out + blockIdx.z * zstride;
  tile_each_pair<kSbGroup>([&](int r, int c, int i, int j, int h) {
    const int f = m0 + r, g = n0 + c;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (f >= x.cols || g + u >= G) continue;
      float* o = out + (long long)f * G + g + u;
      *o = first ? acc[i][j][2 * h + u] : *o + acc[i][j][2 * h + u];
    }
  });
}

#if FL_COMMON
// part[z][n][k] = sum over genes [z dgenes, (z + 1) dgenes) of t[n, g] w[g, k]
// for a row block's cells n: grid (tiles of kSbM cells, tiles of kSbN
// columns of w, ranges of genes): dpsi's t W (w = W, dsplit ranges) and
// the split forward's Z = rfe muL (w = muL, zsplit ranges; with one range
// part is Z's rows of the block).
__global__ void __launch_bounds__(kSbThreads, 2)
dpsi_product_kernel(SbMat t, SbMat w, float* __restrict__ part, long long zstride, int dgenes) {
  constexpr int BK = kSbK, P = kSbPitchK;
  extern __shared__ float4 s_sb[];
  float* smem = reinterpret_cast<float*>(s_sb);
  constexpr int kA = kSbM * P;
  const int z = blockIdx.z, g0 = z * dgenes;
  SbMat a = t, b = w;  // the range's genes (g0 a whole number of 4: the copies stay aligned)
  a.p += g0;
  a.cols = min(dgenes, t.cols - g0);
  b.p += g0 * w.ld;
  b.rows = min(dgenes, w.rows - g0);
  const int m0 = blockIdx.x * kSbM, n0 = blockIdx.y * kSbN;
  float acc[2][4][4] = {};
  tile_mainloop<kSbStages>(
      (a.cols + BK - 1) / BK,
      [&](int kt, int buf) {
        float* s = smem + buf * kSbStageDpsi;
        tile_load<kSbThreads, kSbM, BK, P>(s, a, m0, kt * BK);
        tile_load<kSbThreads, BK, kSbN, kSbPitchN>(s + kA, b, kt * BK, n0);
      },
      [&](int buf) {
        const float* s = smem + buf * kSbStageDpsi;
        const float* sw = s + kA;
        sb_stage<false, P>(s, [&](int k, int n) { return sw[k * kSbPitchN + n]; }, acc);
      });
  sb_reduce(acc, smem);
  const int Kf = w.cols;
  tile_each_pair<kSbGroup>([&](int r, int c, int i, int j, int h) {
    const int n = m0 + r, k = n0 + c;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (n < t.rows && k + u < Kf)
        part[z * zstride + (long long)n * Kf + k + u] = acc[i][j][2 * h + u];
  });
}

// dpsi = dA1 YW (none where YW is null: dlog_rfe had Y dA1; nor for the
// split forward's Z, whose rows x S*C values Kf then counts) + the
// ranges' sums of part (a row block's rows x Kf values), summed in float64
// in order.
__global__ void dpsi_sum_kernel(const float* __restrict__ part, const float* __restrict__ dA1,
                                const float* __restrict__ YW, float* __restrict__ dpsi, int rows,
                                int Kf, int dsplit, long long zstride) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)rows * Kf) return;
  double s = 0.0;
  for (int z = 0; z < dsplit; ++z) s += part[z * zstride + i];
  dpsi[i] = YW ? (float)fma((double)dA1[i / Kf], (double)YW[i], s) : (float)s;
}

// dst (rows x ldd) = src (rows x cols, rows lds apart), zero past cols: dZ
// and muL at an odd S*C copied to a row pitch of whole float4s, so that
// the split kernels copy them 16 bytes at a time (float by float the
// copy instructions set the time: at 2,100 x 200 the gene part took 0.21 ms at
// S*C 2,178 against 0.153 at 2,176; H100 80GB HBM3, 700 W).
// Grid (ldd / 4 columns over 128-thread blocks, rows, up to 65535); four
// columns a thread, one float4 store.
__global__ void pad_rows_kernel(const float* __restrict__ src, long long lds,
                                float* __restrict__ dst, long long ldd, int rows, int cols) {
  const int c = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (c >= ldd) return;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    const float* row = src + r * lds;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = c + u < cols ? row[c + u] : 0.f;
    *reinterpret_cast<float4*>(dst + r * ldd + c) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// pad_rows_kernel on the stream.
void pad_rows(const float* src, long long lds, float* dst, long long ldd, int rows, int cols,
              cudaStream_t stream) {
  const dim3 grid((unsigned)((ldd / 4 + 127) / 128), rows < 65535 ? rows : 65535);
  pad_rows_kernel<<<grid, 128, 0, stream>>>(src, lds, dst, ldd, rows, cols);
}
#endif  // FL_COMMON

// Floats of the gene products' slices' partial sums (none for one slice),
// a whole number of float4s.
inline size_t sb_gpart(const WidePlan& p, long long FG) {
  return p.gslices > 1 ? (size_t)((p.gslices * FG + 3) / 4 * 4) : 0;
}

// Floats of the split forward's gene ranges' sums (none for one range), a
// whole number of float4s.
inline size_t sb_zpart(const WidePlan& p, int SC) {
  return p.zsplit > 1 ? (size_t)(((long long)p.zsplit * p.rows * SC + 3) / 4 * 4) : 0;
}

// Cells of row block b.
inline int sb_block_rows(const WidePlan& p, int N, int b) {
  return N - b * p.rows < p.rows ? N - b * p.rows : p.rows;
}

// Row block b's dZ and muL as the split kernels read them: copied to a row
// pitch of plan.ldz where SC is no whole number of float4s.
inline SbMat sb_dz(const SplitArgs& a, int b) {
  const int rows = sb_block_rows(a.plan, a.N, b);
  return a.plan.ldz ? tile_mat(a.zpad, a.plan.ldz, rows, a.SC)
                    : tile_mat(a.dZ + (long long)b * a.plan.rows * a.SC, a.SC, rows, a.SC);
}
inline SbMat sb_mul(const SplitArgs& a) {
  return a.plan.ldz ? tile_mat(a.mupad, a.plan.ldz, a.G, a.SC) : tile_mat(a.muL, a.SC, a.G, a.SC);
}

// dlog_rfe_kernel<YT, OUT> on row block b: a.rfe and a.dl the block's
// workspace (rows ldw floats apart; one buffer without Y; a.dl unused, and
// dZ and muL unread, for kOutRfe).
template <int YT, int OUT>
void launch_dlog_rfe(const SplitArgs& a, int b) {
  using Elem = typename YStore<YT>::Elem;
  const WidePlan& p = a.plan;
  const int G = a.G, Kf = a.Kf;
  const long long n0 = (long long)b * p.rows;
  const int rows = sb_block_rows(p, a.N, b);
  constexpr int smem = sb_smem(kSbStageDlog);
  cudaFuncSetAttribute(dlog_rfe_kernel<YT, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((G + kSbN - 1) / kSbN, (rows + kSbM - 1) / kSbM);
  const bool drfe = OUT != kOutRfe;
  dlog_rfe_kernel<YT, OUT><<<grid, kSbThreads, smem, a.stream>>>(
      OUT == kOutDlog ? static_cast<const Elem*>(a.Y) + n0 * G : nullptr,
      OUT == kOutDlog ? a.dA1 + n0 : nullptr, tile_mat(a.psi + n0 * Kf, Kf, rows, Kf),
      tile_mat(a.W, Kf, G, Kf), drfe ? sb_dz(a, b) : SbMat{}, drfe ? sb_mul(a) : SbMat{}, a.rfe,
      a.dl, p.ldw);
}

// o[0], o[1] = a kernel's dynamic shared memory (smem bytes) and blocks an
// SM at that and `threads` threads (the occupancy query).
template <class K>
void sb_query(K kernel, int threads, int smem, int* o) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  o[0] = smem;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[1], kernel, threads, smem);
}

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

// The wide family's sizes (any width whose products' indices fit an int);
// rows_per_chunk (the gene part's) a whole number of 16-cell stages.
bool bad_wide_sizes(int N, int G, int Kf, int nA2, int SC, int rows_per_chunk, int y_type) {
  constexpr int kMaxWidth = 1 << 20;
  return N < 1 || G < 1 || Kf < 0 || Kf > kMaxWidth || nA2 < 0 || nA2 > kMaxWidth || SC < 1 ||
         SC > kMaxWidth || rows_per_chunk < 1 || rows_per_chunk % kGeneWideCells ||
         y_type < kYF32 || y_type > kYI8;
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

inline bool is_tile_count(long long t) {
  for (int c : kWideTileCounts)
    if (c == t) return true;
  return false;
}
inline bool is_y_tile_count(long long t) {
  for (int c : kWideYTileCounts)
    if (c == t) return true;
  return false;
}
inline bool is_dpsi_k_count(long long t) {
  for (int c : kDpsiKCounts)
    if (c == t) return true;
  return false;
}
inline bool is_dpsi_z_count(long long t) {
  for (int c : kDpsiZCounts)
    if (c == t) return true;
  return false;
}

// The plan ops/fused_likelihood.py's wide_plan made (its WIDE_PLAN_KEYS, in
// order), or false where a number does not fit these sizes. The forward's:
// every width's tiles, each group a built count that holds every tile,
// grid.y and the group counts within 65535, the table and A1's partial sums
// at least what the kernels address. Where the backward is the split one:
// row blocks that hold every cell once, each within grid.y's 65535 tiles,
// the workspace's row pitch a whole number of float4s of at least G,
// dpsi's ranges of genes (of 32) that hold every gene once, and the gene
// products' slices of cells (of 32) that hold every cell of the one row
// block once, or one slice a row block; the split forward's gene ranges
// (of 32) that hold every gene once, and no Z groups. Else (only
// within the old bound: the gene part's and dpsi's accumulators hold at
// most 8 tiles of [psi, X] and of dA2): each pass a built count and within
// kWideTiles beside the tiles it shares a warp with, dlog mu's tiles in one
// pass of its own within d(muL)'s (it takes them), every cell in a chunk of
// whole stages and within the packed rows, the chunks within 65535, dpsi's
// tiles of [psi, X] and dZ groups built counts that hold every tile, its
// stages whole k-steps of the padded genes, and every workspace region at
// least what the kernels address in it.
constexpr int kWidePlanKeys = 38;
bool wide_plan_of(const long long* v, int N, int G, int Kf, int nA2, int SC, WidePlan& p) {
  p.n_kc = (int)v[0], p.n_zt = (int)v[1], p.n_yt = (int)v[2], p.n_st = (int)v[3];
  p.g_pad = (int)v[4], p.zt_group = (int)v[5], p.n_zgroups = (int)v[6], p.ny_pad = (int)v[7];
  p.rows = (int)v[8], p.n_chunks = (int)v[9], p.n_pad = (int)v[10], p.nj = (int)v[11];
  p.mu_passes = (int)v[12], p.y_pass = (int)v[13], p.n_passes = (int)v[14];
  p.table = (size_t)v[15], p.part = (size_t)v[16], p.dz = (size_t)v[17];
  p.ps = (size_t)v[18], p.a2 = (size_t)v[19], p.a1 = (size_t)v[20];
  p.dk_pad = (int)v[21], p.dz_group = (int)v[22], p.n_dgroups = (int)v[23], p.dsteps = (int)v[24];
  p.dtable = (size_t)v[25];
  p.n_ygroups = (int)v[26], p.a1_parts = (int)v[27], p.a1part = (size_t)v[28];
  p.split = (int)v[29], p.ldw = (int)v[30], p.dsplit = (int)v[31], p.dgenes = (int)v[32];
  p.gslices = (int)v[33], p.gcells = (int)v[34], p.ldz = (int)v[35];
  p.zsplit = (int)v[36], p.zgenes = (int)v[37];
  for (int i = 0; i < kWidePlanKeys; ++i) {
    const bool size = (i >= 15 && i <= 20) || i == 25 || i == 28;
    if (v[i] < 0 || (!size && v[i] > 0x7fffffff)) return false;
  }
  const long long F = (long long)Kf + SC + nA2;
  const int ny_halves = p.ny_pad > 10 ? 2 : 1;
  const bool z_groups = p.split ? p.zt_group == 0 && p.n_zgroups == 0
                                 : is_tile_count(p.zt_group) && p.n_zgroups >= 1 &&
                                       p.n_zgroups <= 65535 &&
                                       (long long)p.n_zgroups * p.zt_group >= p.n_zt;
  const bool fwd = p.n_kc == cdiv(Kf, 8) && p.n_zt == cdiv(SC, 8) && p.n_yt == cdiv(Kf + nA2, 8) &&
                   p.n_st == cdiv(nA2, 8) && p.g_pad % kFwdWideGenes == 0 && p.g_pad >= G &&
                   z_groups && is_y_tile_count(p.ny_pad) &&
                   p.n_ygroups >= 1 && p.n_ygroups <= 65535 &&
                   (long long)p.n_ygroups * p.ny_pad >= p.n_yt &&
                   (p.a1_parts == 0 ? p.n_ygroups == 1 && Kf <= 8 * (p.ny_pad / ny_halves)
                                    : p.a1_parts == p.n_ygroups * ny_halves &&
                                          p.a1part >= (size_t)p.a1_parts * N) &&
                   p.table >= (size_t)(p.g_pad / 8) * (fwd_y_tile0(p) + p.n_ygroups * p.ny_pad) *
                                  kWarp * 4;
  if (!fwd) return false;
  if (p.split == 1)
    return p.rows >= 1 && p.n_chunks >= 1 && (long long)p.n_chunks * p.rows >= N &&
           (long long)(p.n_chunks - 1) * p.rows < N && cdiv(p.rows, kSbM) <= 65535 &&
           p.ldw >= G && p.ldw % 4 == 0 && p.dsplit >= 1 && p.dsplit <= 65535 &&
           p.dgenes >= 32 && p.dgenes % 32 == 0 && (long long)p.dsplit * p.dgenes >= G &&
           (long long)(p.dsplit - 1) * p.dgenes < G &&
           cdiv(Kf, kSbM) + cdiv(SC, kSbM) <= 65535 && cdiv(nA2, kSbM) <= 65535 &&
           cdiv(Kf, kSbN) <= 65535 && p.gslices >= 1 && p.gslices <= 65535 &&
           (p.gslices == 1 ? p.gcells == p.rows : p.n_chunks == 1) && p.gcells >= 32 &&
           p.gcells % 32 == 0 && (long long)p.gslices * p.gcells >= (N < p.rows ? N : p.rows) &&
           (long long)(p.gslices - 1) * p.gcells < N &&
           (p.ldz == 0 || (p.ldz >= SC && p.ldz % 4 == 0)) && cdiv(SC, kSbN) <= 65535 &&
           p.zsplit >= 1 && p.zsplit <= 65535 && p.zgenes >= 32 && p.zgenes % 32 == 0 &&
           (long long)p.zsplit * p.zgenes >= G && (long long)(p.zsplit - 1) * p.zgenes < G;
  return p.split == 0 && p.zsplit == 0 && p.zgenes == 0 && p.n_kc <= 8 && p.n_st <= 8 &&
         p.rows >= kGeneWideCells && p.rows % kGeneWideCells == 0 &&
         p.n_chunks >= 1 && p.n_chunks <= 65535 && (long long)p.n_chunks * p.rows >= N &&
         p.n_pad % kGeneWideCells == 0 && p.n_pad >= N && is_tile_count(p.nj) &&
         (long long)p.mu_passes * p.nj >= p.n_zt && p.y_pass >= 0 && p.y_pass <= 1 &&
         p.n_passes == p.mu_passes + p.y_pass &&
         p.nj + p.n_kc + (p.y_pass ? 0 : p.n_st) <= kWideTiles &&
         (!p.y_pass || p.nj >= p.n_st) &&
         p.part >= (size_t)p.n_chunks * F * G && p.part % 4 == 0 &&
         p.dz >= (size_t)p.n_pad * 16 * p.mu_passes * p.nj &&
         p.ps >= (size_t)p.n_pad * 16 * p.n_kc && p.ps % 4 == 0 &&
         p.a2 >= (size_t)p.n_pad * 16 * p.n_st && p.a2 % 4 == 0 && p.dz % 4 == 0 &&
         p.a1 >= (size_t)p.n_pad && is_dpsi_k_count(p.dk_pad) && p.dk_pad >= p.n_kc &&
         is_dpsi_z_count(p.dz_group) && p.n_dgroups >= 1 &&
         (long long)p.n_dgroups * p.dz_group >= p.n_zt && (p.dsteps == 2 || p.dsteps == 4) &&
         p.g_pad % (8 * p.dsteps) == 0 &&
         p.dtable >= (size_t)(p.g_pad / 8) * (2 * p.dk_pad + p.n_dgroups * p.dz_group) * kWarp * 4;
}
#endif  // FL_COMMON

// Float4s of a stage buffer and bytes of dynamic shared memory, at y_bytes
// a count of Y: fwd_wide_kernel's `steps` k-steps of W^T and Z tiles (after
// the row groups' psi fragments); fwd_wide_y_kernel's 4 k-steps of Y tiles
// and its warps' Y rows; gene_wide_kernel's 16 cells of dZ, psi and dA2
// pairs at their strides, dA1 and 16 Y rows of the block's genes (after the
// warps' W and muL fragments).
// Past 10 tiles two warps share a row group (fwd_wide_kernel's note).
inline int fwd_wide_groups(int tiles) { return tiles > 10 ? kFwdWarps / 2 : kFwdWarps; }
inline int fwd_wide_stage_f4(const WidePlan& p, int steps) {
  return steps * (p.n_kc + p.zt_group) * kWarp;
}
inline int fwd_wide_smem(const WidePlan& p, int steps) {
  const int groups = fwd_wide_groups(p.zt_group);
  const int a = p.zt_group > 10 ? groups * steps * 2 * kWarp : 0;
  return 16 * (groups * p.n_kc * 2 * kWarp + 2 * fwd_wide_stage_f4(p, steps) + a);
}
// fwd_wide_kernel's k-steps a stage: 4, unless their shared memory would
// leave room for one block an SM (the H100's 228 KB an SM less 1 KB a
// block, kTwoBlockSmem a block for two); then 2, which at every width
// fits two.
constexpr int kTwoBlockSmem = (228 - 2) / 2 * 1024;
inline int fwd_wide_steps(const WidePlan& p) {
  return fwd_wide_smem(p, kFwdWideSteps) <= kTwoBlockSmem ? kFwdWideSteps : kFwdWideSteps / 2;
}
inline int fwd_wide_y_stage_f4(const WidePlan& p, int y_bytes) {
  return kFwdWideSteps * p.ny_pad * kWarp +
         fwd_wide_groups(p.ny_pad) * kFwdRows * (kFwdWideGenes * y_bytes + 16) / 16;
}
inline int fwd_wide_y_smem(const WidePlan& p, int y_bytes) {
  return 16 * 2 * fwd_wide_y_stage_f4(p, y_bytes);
}
inline int gene_wide_stage_f4(const WidePlan& p, int y_bytes) {
  return (2 * kGeneWideCells * (gene_dz_stride(p) + gene_ps_stride(p) + gene_a2_stride(p)) +
          kGeneWideCells) / 4 +
         kGeneWideCells * (kGeneWideGenes * y_bytes + 16) / 16;
}
inline int gene_wide_smem(const WidePlan& p, int y_bytes) {
  return 16 * (kGeneWideWarps * (p.n_kc + 2 * p.nj) * kWarp + 2 * gene_wide_stage_f4(p, y_bytes));
}
// dpsi_wide_kernel's: p.dsteps k-steps of W^T, muL^T and W tiles a stage
// buffer, after the warps' psi fragments (a float4 a lane and tile) and
// float64 sums (2 a lane and tile; wide_plan takes 4 k-steps unless that
// would leave room for one block an SM).
inline int dpsi_wide_stage_f4(const WidePlan& p) {
  return p.dsteps * (2 * p.dk_pad + p.dz_group) * kWarp;
}
inline int dpsi_wide_smem(const WidePlan& p) {
  return 16 * (kDpsiWarps * 3 * p.dk_pad * kWarp + 2 * dpsi_wide_stage_f4(p));
}

// f(std::integral_constant<int, T>) for T the built tile count t
// (kWideTileCounts), or the built Y tile count (kWideYTileCounts).
template <class F>
inline void tile_dispatch(int t, F&& f) {
  switch (t) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 6: f(std::integral_constant<int, 6>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    case 10: f(std::integral_constant<int, 10>{}); break;
    case 12: f(std::integral_constant<int, 12>{}); break;
    default: f(std::integral_constant<int, 16>{});
  }
}
template <class F>
inline void y_tile_dispatch(int t, F&& f) {
  switch (t) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 8: f(std::integral_constant<int, 8>{}); break;
    default: f(std::integral_constant<int, 16>{});
  }
}

#if FL_COMMON
// f(fwd_wide_kernel<NZ, STEPS>) for NZ the built tile count t and STEPS
// the k-steps a stage, 4 or 2.
template <class F>
inline void fwd_wide_dispatch(int t, int steps, F&& f) {
  tile_dispatch(t, [&](auto nz) {
    constexpr int NZ = decltype(nz)::value;
    if (steps == kFwdWideSteps)
      f(fwd_wide_kernel<NZ, kFwdWideSteps>);
    else
      f(fwd_wide_kernel<NZ, kFwdWideSteps / 2>);
  });
}

// f(dpsi_wide_kernel<NK, NZ>) for the built counts nk (kDpsiKCounts) and
// nz (kDpsiZCounts).
template <class F>
inline void dpsi_wide_dispatch(int nk, int nz, F&& f) {
  auto at_nk = [&](auto k) {
    constexpr int NK = decltype(k)::value;
    switch (nz) {
      case 1: f(dpsi_wide_kernel<NK, 1>); break;
      case 2: f(dpsi_wide_kernel<NK, 2>); break;
      case 4: f(dpsi_wide_kernel<NK, 4>); break;
      case 6: f(dpsi_wide_kernel<NK, 6>); break;
      case 8: f(dpsi_wide_kernel<NK, 8>); break;
      default: f(dpsi_wide_kernel<NK, 10>);
    }
  };
  switch (nk) {
    case 1: at_nk(std::integral_constant<int, 1>{}); break;
    case 2: at_nk(std::integral_constant<int, 2>{}); break;
    case 4: at_nk(std::integral_constant<int, 4>{}); break;
    default: at_nk(std::integral_constant<int, 8>{});
  }
}
#endif  // FL_COMMON

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

// The wide kernels that read Y, at plan a.plan: shared memory set for each
// launch (the launch fails, and the entry point reports it, past the
// card's 227 KB).
template <int YT>
void forward_wide_typed(const FwdWideArgs& a) {
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  const WidePlan& p = a.plan;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const bool vec = a.G % 4 == 0 && reinterpret_cast<uintptr_t>(Y) % sizeof(Piece) == 0;
  const int smem = fwd_wide_y_smem(p, sizeof(Elem)), stage_f4 = fwd_wide_y_stage_f4(p, sizeof(Elem));
  y_tile_dispatch(p.ny_pad, [&](auto ny) {
    constexpr int NY = decltype(ny)::value;
    cudaFuncSetAttribute(fwd_wide_y_kernel<YT, NY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    const dim3 grid(blocks_for(a.N, fwd_wide_groups(NY) * kFwdRows), p.n_ygroups);
    fwd_wide_y_kernel<YT, NY><<<grid, kFwdWarps * kWarp, smem, a.stream>>>(
        Y, a.psi, a.table, a.A1, a.A2, a.YW, a.a1part, a.N, a.G, a.Kf, a.nA2, p, stage_f4, vec);
  });
}

template <int YT>
void gene_wide_typed(const GeneWideArgs& a) {
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  const WidePlan& p = a.plan;
  const Elem* Y = static_cast<const Elem*>(a.Y);
  const bool vec = a.G % 4 == 0 && reinterpret_cast<uintptr_t>(Y) % sizeof(Piece) == 0;
  const dim3 grid(blocks_for(a.G, kGeneWideGenes), p.n_chunks);
  const int smem = gene_wide_smem(p, sizeof(Elem)), stage_f4 = gene_wide_stage_f4(p, sizeof(Elem));
  tile_dispatch(p.nj, [&](auto nj) {
    constexpr int NJ = decltype(nj)::value;
    cudaFuncSetAttribute(gene_wide_kernel<YT, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    gene_wide_kernel<YT, NJ><<<grid, kGeneWideWarps * kWarp, smem, a.stream>>>(
        Y, a.W, a.muL, a.dz, a.ps, a.a2, a.a1, a.part, a.N, a.G, a.Kf, a.nA2, a.SC, p, stage_f4,
        vec);
  });
}

// The split backward's Y-reading launches on row block b: which 0,
// dlog_rfe_kernel<YT, kOutDlog> (rfe and dlog_rfe to the workspace); which 1,
// dlog mu = dA2^T Y by gene_product_kernel<YT, true> into the output's
// last nA2 rows.
template <int YT>
void split_typed(const SplitArgs& a, int b, int which) {
  using Elem = typename YStore<YT>::Elem;
  using Piece = typename YStore<YT>::Piece;
  const WidePlan& p = a.plan;
  if (which == 0) {
    launch_dlog_rfe<YT, kOutDlog>(a, b);
    return;
  }
  const long long n0 = (long long)b * p.rows;
  const int rows = sb_block_rows(p, a.N, b);
  const Elem* Y = static_cast<const Elem*>(a.Y) + n0 * a.G;
  const bool vec = a.G % 4 == 0 && reinterpret_cast<uintptr_t>(Y) % sizeof(Piece) == 0;
  const bool sliced = p.gslices > 1;
  const SbJob job{tile_mat(a.dA2 + n0 * a.nA2, a.nA2, rows, a.nA2), SbMat{},
                  (sliced ? a.gpart : a.dgene) + (long long)(a.Kf + a.SC) * a.G,
                  (a.nA2 + kSbM - 1) / kSbM};
  constexpr int smem = sb_smem(sb_stage_gene_y(sizeof(Elem)));
  cudaFuncSetAttribute(gene_product_kernel<YT, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  gene_product_kernel<YT, true>
      <<<dim3((a.G + kSbN - 1) / kSbN, job.m_tiles, p.gslices), kSbThreads, smem,
         a.stream>>>(SbJobs{{job, job}}, Y, vec, a.G, sliced || b == 0, p.gcells,
                     sliced ? (long long)(a.Kf + a.SC + a.nA2) * a.G : 0);
}

// out[0..4) = dlog_rfe_kernel<YT, kOutDlog>'s and gene_product_kernel<YT,
// true>'s dynamic shared memory and blocks an SM.
template <int YT>
void split_resources_typed(int* out) {
  using Elem = typename YStore<YT>::Elem;
  sb_query(dlog_rfe_kernel<YT, kOutDlog>, kSbThreads, sb_smem(kSbStageDlog), out);
  sb_query(gene_product_kernel<YT, true>, kSbThreads, sb_smem(sb_stage_gene_y(sizeof(Elem))),
           out + 2);
}

// Blocks an SM holds of fwd_wide_y_kernel (which 1) or gene_wide_kernel
// (which 2) at the built tile count t and smem bytes of dynamic shared
// memory (0 if it cannot run).
template <int YT>
int wide_blocks_per_sm(int which, int t, int smem) {
  int blocks = 0;
  if (which == 1) {
    y_tile_dispatch(t, [&](auto ny) {
      constexpr int NY = decltype(ny)::value;
      cudaFuncSetAttribute(fwd_wide_y_kernel<YT, NY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fwd_wide_y_kernel<YT, NY>,
                                                    kFwdWarps * kWarp, smem);
    });
  } else {
    tile_dispatch(t, [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
      cudaFuncSetAttribute(gene_wide_kernel<YT, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gene_wide_kernel<YT, NJ>,
                                                    kGeneWideWarps * kWarp, smem);
    });
  }
  return blocks;
}
#endif  // FL_ANY_TYPED

#if FL_TYPED(0)
template void forward_typed<kYF32>(const FwdArgs&);
template void gene_typed<kYF32>(const GeneArgs&);
template void forward_wide_typed<kYF32>(const FwdWideArgs&);
template void gene_wide_typed<kYF32>(const GeneWideArgs&);
template int wide_blocks_per_sm<kYF32>(int, int, int);
template void split_typed<kYF32>(const SplitArgs&, int, int);
template void split_resources_typed<kYF32>(int*);
#endif
#if FL_TYPED(1)
template void forward_typed<kYBF16>(const FwdArgs&);
template void gene_typed<kYBF16>(const GeneArgs&);
template void forward_wide_typed<kYBF16>(const FwdWideArgs&);
template void gene_wide_typed<kYBF16>(const GeneWideArgs&);
template int wide_blocks_per_sm<kYBF16>(int, int, int);
template void split_typed<kYBF16>(const SplitArgs&, int, int);
template void split_resources_typed<kYBF16>(int*);
#endif
#if FL_TYPED(2)
template void forward_typed<kYI16>(const FwdArgs&);
template void gene_typed<kYI16>(const GeneArgs&);
template void forward_wide_typed<kYI16>(const FwdWideArgs&);
template void gene_wide_typed<kYI16>(const GeneWideArgs&);
template int wide_blocks_per_sm<kYI16>(int, int, int);
template void split_typed<kYI16>(const SplitArgs&, int, int);
template void split_resources_typed<kYI16>(int*);
#endif
#if FL_TYPED(3)
template void forward_typed<kYI8>(const FwdArgs&);
template void gene_typed<kYI8>(const GeneArgs&);
template void forward_wide_typed<kYI8>(const FwdWideArgs&);
template void gene_wide_typed<kYI8>(const GeneWideArgs&);
template int wide_blocks_per_sm<kYI8>(int, int, int);
template void split_typed<kYI8>(const SplitArgs&, int, int);
template void split_resources_typed<kYI8>(int*);
#endif

}  // namespace fl

#if FL_COMMON
// The split backward over the plan's row blocks (see the note at the top).
// With a.dgene, the gene part: dlog_rfe_kernel with Y (a.rfe and a.dl the
// row block's rfe and dlog_rfe), dW^T = psi^T dlog_rfe and d(muL)^T = dZ^T
// rfe, and dlog mu = dA2^T Y where nA2 > 0, summed over the row blocks in
// order into a.dgene (or a single row block's slices' partial sums into
// a.gpart, which reduce_chunks_kernel adds in order). Without,
// dlog_rfe_kernel without Y (a.dl the row
// block's t = rfe drfe). With dpsi (and Kf > 0), dpsi = a.dl W by gene
// ranges into part, added with dA1 YW (where YW is given: t's rows) by
// dpsi_sum_kernel.
static void split_backward(const SplitArgs& a, int y_type, float* dpsi, const float* YW,
                           float* part) {
  const WidePlan& p = a.plan;
  const int N = a.N, G = a.G, Kf = a.Kf, SC = a.SC, FG = (Kf + SC + a.nA2) * G;
  const bool sliced = p.gslices > 1;
  float* out = sliced ? a.gpart : a.dgene;
  auto typed = [&](int b, int which) {
    switch (y_type) {
      case kYF32: split_typed<kYF32>(a, b, which); break;
      case kYBF16: split_typed<kYBF16>(a, b, which); break;
      case kYI16: split_typed<kYI16>(a, b, which); break;
      default: split_typed<kYI8>(a, b, which);
    }
  };
  constexpr int gsmem = sb_smem(kSbStageGene), dsmem = sb_smem(kSbStageDpsi);
  cudaFuncSetAttribute(gene_product_kernel<kYF32, false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, gsmem);
  cudaFuncSetAttribute(dpsi_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dsmem);
  const long long zstride = (long long)p.rows * Kf;
  if (p.ldz) pad_rows(a.muL, SC, a.mupad, p.ldz, G, SC, a.stream);
  for (int b = 0; b < p.n_chunks; ++b) {
    const long long n0 = (long long)b * p.rows;
    const int rows = sb_block_rows(p, N, b);
    if (p.ldz) pad_rows(a.dZ + n0 * SC, SC, a.zpad, p.ldz, rows, SC, a.stream);
    if (a.dgene) {
      typed(b, 0);  // rfe and dlog_rfe of the row block
      // dW^T = psi^T dlog_rfe and d(muL)^T = dZ^T rfe
      const SbJob dw{tile_mat(a.psi + n0 * Kf, Kf, rows, Kf), tile_mat(a.dl, p.ldw, rows, G), out,
                     (Kf + kSbM - 1) / kSbM};
      const SbJob dmu{sb_dz(a, b), tile_mat(a.rfe, p.ldw, rows, G), out + (long long)Kf * G,
                      (SC + kSbM - 1) / kSbM};
      gene_product_kernel<kYF32, false>
          <<<dim3((G + kSbN - 1) / kSbN, dw.m_tiles + dmu.m_tiles, p.gslices), kSbThreads,
             gsmem, a.stream>>>(SbJobs{{dw, dmu}}, nullptr, false, G, sliced || b == 0, p.gcells,
                                sliced ? FG : 0);
      if (a.nA2) typed(b, 1);  // dlog mu = dA2^T Y
      if (sliced)  // one row block: its slices' partial sums, added in order
        reduce_chunks_kernel<<<blocks_for(FG, 256), 256, 0, a.stream>>>(a.gpart, a.dgene,
                                                                       p.gslices, FG);
    } else {
      launch_dlog_rfe<kYF32, kOutT>(a, b);
    }
    if (dpsi && Kf) {
      dpsi_product_kernel<<<dim3((rows + kSbM - 1) / kSbM, (Kf + kSbN - 1) / kSbN, p.dsplit),
                            kSbThreads, dsmem, a.stream>>>(
          tile_mat(a.dl, p.ldw, rows, G), tile_mat(a.W, Kf, G, Kf), part, zstride, p.dgenes);
      dpsi_sum_kernel<<<blocks_for((long long)rows * Kf, 256), 256, 0, a.stream>>>(
          part, a.dA1 + n0, YW ? YW + n0 * Kf : nullptr, dpsi + n0 * Kf, rows, Kf, p.dsplit,
          zstride);
    }
  }
}

// The split forward over the plan's row blocks (see the note at the top):
// for each, rfe = exp(psi W^T) of the block by dlog_rfe_kernel<0, kOutRfe>
// into a.rfe (rows ldw floats apart), then Z = rfe muL by
// dpsi_product_kernel over zsplit gene ranges, into Z's rows of the block
// where one, else into zpart (zsplit x rows x SC), which dpsi_sum_kernel
// adds in order. muL is first copied to a row pitch of ldz where SC is no
// whole number of float4s (a.mupad).
static void split_forward(const SplitArgs& a, float* Z, float* zpart) {
  const WidePlan& p = a.plan;
  const int SC = a.SC;
  constexpr int dsmem = sb_smem(kSbStageDpsi);
  cudaFuncSetAttribute(dpsi_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dsmem);
  if (p.ldz) pad_rows(a.muL, SC, a.mupad, p.ldz, a.G, SC, a.stream);
  const SbMat mul = sb_mul(a);
  const long long zstride = (long long)p.rows * SC;
  for (int b = 0; b < p.n_chunks; ++b) {
    const long long n0 = (long long)b * p.rows;
    const int rows = sb_block_rows(p, a.N, b);
    launch_dlog_rfe<kYF32, kOutRfe>(a, b);
    float* out = p.zsplit > 1 ? zpart : Z + n0 * SC;
    dpsi_product_kernel<<<dim3((rows + kSbM - 1) / kSbM, (SC + kSbN - 1) / kSbN, p.zsplit),
                          kSbThreads, dsmem, a.stream>>>(tile_mat(a.rfe, p.ldw, rows, a.G), mul,
                                                         out, zstride, p.zgenes);
    if (p.zsplit > 1)
      dpsi_sum_kernel<<<blocks_for((long long)rows * SC, 256), 256, 0, a.stream>>>(
          zpart, nullptr, nullptr, Z + n0 * SC, rows, SC, p.zsplit, zstride);
  }
}

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
// fl_backward_dpsi and fl_backward_gene, at any width, with the plan that
// ops/fused_likelihood.py's wide_plan made for these sizes (its
// WIDE_PLAN_KEYS, in order; cudaErrorInvalidValue where it does not fit
// them, wide_plan_of; fl_backward_dpsi_wide takes the plan of nA2 = 0).
// fl_forward_wide's scratch (16-byte aligned) holds the plan's table floats
// and then its a1part floats (A1's partial sums), and where the plan is the
// split one rows x ldw floats (the row block's rfe), where zsplit > 1
// zsplit x rows x SC rounded up to whole float4s (the gene ranges' sums of
// Z) and where ldz > 0 G x ldz (muL at that pitch); fl_backward_dpsi_wide's
// its dtable floats (the packed gene side); fl_backward_gene_wide's its
// part + dz + ps + a2 + a1 floats: the (Kf+SC+nA2, G) partial sums of each
// chunk, then the packed cell side. Where the plan's backward is the split
// one, fl_backward_dpsi_wide's scratch holds rows x ldw floats (the row
// block's t = rfe drfe) and then dsplit x rows x Kf (the gene ranges'
// sums), and fl_backward_gene_wide's 2 x rows x ldw (the row block's rfe
// and dlog_rfe) and then, where gslices > 1, gslices x (Kf+SC+nA2) x G
// rounded up to whole float4s (the slices' partial sums); both then, where
// ldz > 0, (rows + G) x ldz (dZ's row block and muL at that pitch).
int fl_forward_wide(const void* Y, const float* psi, const float* W,
                    const float* logmu, const float* muL, float* A1, float* A2,
                    float* Z, float* YW, float* scratch, const long long* plan, int N, int G,
                    int Kf, int nA2, int SC, int y_type, cudaStream_t stream) {
  WidePlan p;
  if (bad_wide_sizes(N, G, Kf, nA2, SC, kGeneWideCells, y_type) ||
      !wide_plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  float4* table = reinterpret_cast<float4*>(scratch);
  fwd_wide_pack_kernel<<<blocks_for((long long)(p.table / 4), 256), 256, 0, stream>>>(
      W, logmu, muL, table, G, Kf, nA2, SC, p);
  if (p.split) {
    float* rfe = scratch + p.table + p.a1part;
    float* zpart = rfe + (size_t)p.rows * p.ldw;
    float* mupad = zpart + sb_zpart(p, SC);
    const SplitArgs a{nullptr, psi,     W,  muL, nullptr, nullptr, nullptr, rfe, rfe, nullptr,
                      nullptr, nullptr, mupad, N, G,       Kf,      0,       SC,  p,   stream};
    split_forward(a, Z, zpart);
  } else {
    const int steps = fwd_wide_steps(p);
    const int smem = fwd_wide_smem(p, steps), stage_f4 = fwd_wide_stage_f4(p, steps);
    const dim3 grid(blocks_for(N, fwd_wide_groups(p.zt_group) * kFwdRows), p.n_zgroups);
    fwd_wide_dispatch(p.zt_group, steps, [&](auto kernel) {
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      kernel<<<grid, kFwdWarps * kWarp, smem, stream>>>(psi, table, Z, N, Kf, SC, p, stage_f4);
    });
  }
  float* a1part = p.a1_parts ? scratch + p.table : nullptr;
  const FwdWideArgs a{Y, psi, table, A1, A2, Z, YW, a1part, N, G, Kf, nA2, SC, p, stream};
  switch (y_type) {
    case kYF32: forward_wide_typed<kYF32>(a); break;
    case kYBF16: forward_wide_typed<kYBF16>(a); break;
    case kYI16: forward_wide_typed<kYI16>(a); break;
    default: forward_wide_typed<kYI8>(a);
  }
  if (p.a1_parts)
    reduce_chunks_kernel<<<blocks_for(N, 256), 256, 0, stream>>>(a1part, A1, p.a1_parts, N);
  return (int)cudaGetLastError();
}

int fl_backward_dpsi_wide(const float* psi, const float* W, const float* muL,
                          const float* dA1, const float* dZ, const float* YW,
                          float* dpsi, float* scratch, const long long* plan, int N, int G,
                          int Kf, int SC, cudaStream_t stream) {
  WidePlan p;
  if (bad_wide_sizes(N, G, Kf, 0, SC, kGeneWideCells, kYF32) ||
      !wide_plan_of(plan, N, G, Kf, 0, SC, p))
    return (int)cudaErrorInvalidValue;
  if (Kf == 0) return (int)cudaSuccess;
  if (p.split) {
    float* t = scratch;
    float* part = t + (size_t)p.rows * p.ldw;
    float* zpad = part + (size_t)p.dsplit * p.rows * Kf;
    const SplitArgs a{nullptr, psi,     W,    muL, dA1, nullptr, dZ, t, t, nullptr, nullptr, zpad,
                      zpad + (size_t)p.rows * p.ldz, N, G, Kf, 0, SC, p, stream};
    split_backward(a, kYF32, dpsi, YW, part);
    return (int)cudaGetLastError();
  }
  float4* table = reinterpret_cast<float4*>(scratch);
  dpsi_wide_pack_kernel<<<blocks_for((long long)(p.dtable / 4), 256), 256, 0, stream>>>(
      W, muL, table, G, Kf, SC, p);
  const int smem = dpsi_wide_smem(p), stage_f4 = dpsi_wide_stage_f4(p);
  const dim3 grid(blocks_for(N, kDpsiWarps * kFwdRows));
  dpsi_wide_dispatch(p.dk_pad, p.dz_group, [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<grid, kDpsiWarps * kWarp, smem, stream>>>(psi, dZ, dA1, YW, table, dpsi, N, Kf, SC,
                                                        p, stage_f4);
  });
  return (int)cudaGetLastError();
}

// The wide gene part (dW, dlog mu, d(muL)); with dpsi (N,Kf) where the
// plan's backward is the split one, dpsi too, from the same dlog_rfe a row
// block (the autograd function's backward; dpsi must be null otherwise).
// Past the old bound scratch (16-byte aligned) holds 2 x rows x ldw floats
// (the row block's rfe and dlog_rfe), dsplit x rows x Kf (dpsi's gene
// ranges' sums), where gslices > 1 gslices x (Kf+SC+nA2) x G rounded up to
// whole float4s (the gene products' slices' partial sums), and where ldz
// > 0 (rows + G) x ldz; at the old widths the packed cell side and the
// chunks' partial sums.
int fl_backward_gene_wide(const void* Y, const float* psi, const float* W,
                          const float* muL, const float* dA1, const float* dA2,
                          const float* dZ, float* dpsi, float* scratch, float* dgene,
                          const long long* plan, int N, int G, int Kf, int nA2, int SC,
                          int y_type, cudaStream_t stream) {
  WidePlan p;
  if (bad_wide_sizes(N, G, Kf, nA2, SC, kGeneWideCells, y_type) ||
      !wide_plan_of(plan, N, G, Kf, nA2, SC, p) || (dpsi && !p.split))
    return (int)cudaErrorInvalidValue;
  if (p.split) {
    const size_t block = (size_t)p.rows * p.ldw, dpart = (size_t)p.dsplit * p.rows * Kf;
    float* gpart = scratch + 2 * block + dpart;
    float* zpad = gpart + sb_gpart(p, (Kf + SC + nA2) * G);
    const SplitArgs a{Y,    psi,  W,    muL, dA1, dA2, dZ, scratch, scratch + block, dgene, gpart,
                      zpad, zpad + (size_t)p.rows * p.ldz, N, G, Kf, nA2, SC, p, stream};
    split_backward(a, y_type, dpsi, nullptr, scratch + 2 * block);
    return (int)cudaGetLastError();
  }
  float2* dz = reinterpret_cast<float2*>(scratch + p.part);
  float2* ps = reinterpret_cast<float2*>(scratch + p.part + p.dz);
  float2* a2 = reinterpret_cast<float2*>(scratch + p.part + p.dz + p.ps);
  float* a1 = scratch + p.part + p.dz + p.ps + p.a2;
  gene_wide_pack_kernel<<<blocks_for((long long)((p.dz + p.ps + p.a2) / 2 + p.a1), 256), 256, 0,
                          stream>>>(psi, dA1, dA2, dZ, dz, ps, a2, a1, N, Kf, nA2, SC, p);
  const GeneWideArgs a{Y, W, muL, dz, ps, a2, a1, scratch, N, G, Kf, nA2, SC, p, stream};
  switch (y_type) {
    case kYF32: gene_wide_typed<kYF32>(a); break;
    case kYBF16: gene_wide_typed<kYBF16>(a); break;
    case kYI16: gene_wide_typed<kYI16>(a); break;
    default: gene_wide_typed<kYI8>(a);
  }
  const int FG = (Kf + SC + nA2) * G;
  reduce_chunks_kernel<<<blocks_for(FG, 256), 256, 0, stream>>>(scratch, dgene, p.n_chunks, FG);
  return (int)cudaGetLastError();
}

// What the wide kernels that the plan launches take on the card, for
// holding them to their blocks an SM: out[0..16) = fwd_wide_kernel's
// dynamic shared memory bytes and blocks an SM (the occupancy query), the
// same for fwd_wide_y_kernel at Y storage y_type, for the gene part's and
// dpsi's kernels, then fwd_wide_kernel's and dpsi_wide_kernel's k-steps a
// stage. The gene part's and dpsi's kernels: gene_wide_kernel (at y_type)
// and dpsi_wide_kernel; or where the plan's backward is the split one
// dlog_rfe_kernel<y_type, 1> and dpsi_product_kernel (dpsi's k-steps 0),
// and in out[10..16) gene_product_kernel<0, 0>, gene_product_kernel<y_type,
// 1> and dlog_rfe_kernel<0, 0> (zeros for the other plans); the forward is
// then the split one, whose rfe kernel dlog_rfe_kernel<0, 2> stands in
// out[0..2) (its k-steps 0; its Z product is dpsi_product_kernel). Returns
// cudaErrorInvalidValue where the plan does not fit the sizes.
int fl_wide_resources(const long long* plan, int N, int G, int Kf, int nA2, int SC, int y_type,
                      int* out) {
  WidePlan p;
  if (bad_wide_sizes(N, G, Kf, nA2, SC, kGeneWideCells, y_type) ||
      !wide_plan_of(plan, N, G, Kf, nA2, SC, p))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 16; ++i) out[i] = 0;
  const int steps = p.split ? 0 : fwd_wide_steps(p);
  const int yb = y_type == kYF32 ? 4 : y_type == kYI8 ? 1 : 2;
  if (p.split) {
    sb_query(dlog_rfe_kernel<kYF32, kOutRfe>, kSbThreads, sb_smem(kSbStageDlog), out);
  } else {
    fwd_wide_dispatch(p.zt_group, steps, [&](auto kernel) {
      sb_query(kernel, kFwdWarps * kWarp, fwd_wide_smem(p, steps), out);
    });
  }
  const int smem[3] = {0, fwd_wide_y_smem(p, yb), gene_wide_smem(p, yb)};
  for (int which = 1; which <= (p.split ? 1 : 2); ++which) {
    const int t = which == 1 ? p.ny_pad : p.nj;
    int blocks = 0;
    switch (y_type) {
      case kYF32: blocks = wide_blocks_per_sm<kYF32>(which, t, smem[which]); break;
      case kYBF16: blocks = wide_blocks_per_sm<kYBF16>(which, t, smem[which]); break;
      case kYI16: blocks = wide_blocks_per_sm<kYI16>(which, t, smem[which]); break;
      default: blocks = wide_blocks_per_sm<kYI8>(which, t, smem[which]);
    }
    out[2 * which] = smem[which];
    out[2 * which + 1] = blocks;
  }
  out[8] = steps;
  if (p.split) {
    int typed[4];
    switch (y_type) {
      case kYF32: split_resources_typed<kYF32>(typed); break;
      case kYBF16: split_resources_typed<kYBF16>(typed); break;
      case kYI16: split_resources_typed<kYI16>(typed); break;
      default: split_resources_typed<kYI8>(typed);
    }
    out[4] = typed[0], out[5] = typed[1], out[12] = typed[2], out[13] = typed[3];
    sb_query(dpsi_product_kernel, kSbThreads, sb_smem(kSbStageDpsi), out + 6);
    sb_query(gene_product_kernel<kYF32, false>, kSbThreads, sb_smem(kSbStageGene), out + 10);
    sb_query(dlog_rfe_kernel<kYF32, kOutT>, kSbThreads, sb_smem(kSbStageDlog), out + 14);
  } else {
    dpsi_wide_dispatch(p.dk_pad, p.dz_group, [&](auto kernel) {
      sb_query(kernel, kDpsiWarps * kWarp, dpsi_wide_smem(p), out + 6);
    });
    out[9] = p.dsteps;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // FL_COMMON

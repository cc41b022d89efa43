"""Fused multinomial-likelihood contractions: the CUDA kernels, their plain
PyTorch versions and the autograd function that joins them.

Per ELBO evaluation the likelihood needs (counterpart of
``clonealign_tpu/ops/fused_likelihood.py``)::

    A1[n]     = sum_g Y[n,g] * log_rfe[n,g]        log_rfe = psi_ext @ W_ext^T
    A2[n,s]   = sum_g Y[n,g] * log_mu[s,g]
    Z[n,s*C+c] = sum_g exp(log_rfe[n,g]) * muL[g,s*C+c]

On CUDA tensors :func:`fused_likelihood_terms` launches the kernels of
``csrc/fused_likelihood.cu``, which never store the N x G ``exp(log_rfe)``.
The forward kernel also writes ``YW = Y @ W_ext`` (N x Kf), which the
autograd function keeps, so that the backward's dpsi kernel
(:func:`reference_dpsi` is its plain version) reads no Y: the backward reads
Y once, in the gene-major kernel for dW, d(muL) and dlog mu
(:func:`reference_gene` is its plain version). On CPU tensors it runs
:func:`reference_likelihood_terms` and :func:`reference_likelihood_vjp`, the
plain versions of the whole contract, which need no YW. There is no fallback
between the two: a CUDA tensor the kernels do not take raises.

The kernels above are built for at most ``MAX_KF`` columns of ``[psi, X]``,
``MAX_A2`` A2 columns and ``MAX_SC`` Z columns. Past any of those limits
(:func:`wide_route`) each wrapper launches the wide family instead, with
runtime widths (the counterparts of the Pallas kernels' ``jnp.dot``
branches, which take any width), counted apart in ``*_wide_launches``: the
forward (Z, and Y's products), the Y-free dpsi kernel and the gene part,
all on tensor cores (the contract as unnormalized attention). Widths past
what a block's accumulators hold go in column groups or passes, each
recomputing the exps it needs, up to the old bound of Kf 64, 64 A2 columns
and S*C 2,048. Past it (:func:`split_route`) the backward is the split one,
which forms rfe and dlog_rfe once a row block of cells into a workspace
(``dlog_rfe_kernel``) and takes dpsi, dW, d(muL) and dlog mu from it as
tiled products (``dpsi_product_kernel``, ``gene_product_kernel``);
:func:`kernel_backward` forms dlog_rfe once for both parts there, in one
call of the gene part's entry point with dpsi, counted in
``split_launches``. The forward is the split one there too: rfe once a row
block (``dlog_rfe_kernel``'s rfe-only form), Z = rfe muL as a tiled
product over gene ranges (``dpsi_product_kernel``, ``dpsi_sum_kernel``)
and Y's products by ``fwd_wide_y_kernel``, counted in ``fwd_wide_launches``.
:func:`wide_plan` gives the launch geometry and workspace, which the C
launchers take and check; it raises a ValueError where a width's shared
memory would pass the card's (``MAX_SMEM`` a block), which no width
reaches: within the old bound Kf is at most 64, and past it every kernel's
tiles are fixed. The plain versions take any width and are the wide
family's too.

Float64 operands (``dtype="float64"`` fits, the oracle configuration) go
to a family of their own, ``csrc/fused_likelihood_f64.cu``: the forward
(``fwd_f64_pack_kernel`` + ``fwd_f64_kernel``), the Y-free dpsi kernel
(``dpsi_f64_pack_kernel`` + ``dpsi_f64_kernel``) and the gene part
(``gene_f64_pack_kernel`` + ``gene_f64_kernel`` +
``reduce_chunks_f64_kernel``), float64 throughout: every product on the
FP64 tensor cores, the exps on the CUDA cores; one family for every width
(no narrow/wide split), counted apart in
``*_f64_launches``. Past the old bound its forward, dpsi and gene part are
the split ones (``dlog_rfe_f64_kernel``: rfe, t = rfe drfe or dlog_rfe once
a row block into a float64 workspace; Z = rfe muL and dpsi = t W by
``dpsi_product_f64_kernel`` over gene ranges, added by
``dpsi_sum_f64_kernel``; dW, d(muL) and dlog mu by
``gene_product_f64_kernel``; Y's products by ``fwd_f64_kernel`` in groups
of Y tiles only), and :func:`kernel_backward` takes dpsi from the gene
part's dlog_rfe in one call, counted in ``split_f64_launches``.
:func:`f64_plan` gives their launch geometry and workspace, which the C
entry points take and check (it takes every width: past the old bound no
kernel's shared memory grows with one). Nothing on that path runs in
float32.

Y may be stored narrow (``Y_DTYPES``: float32, bfloat16, int16 or int8;
``api.py``'s ``y_storage``; under float64 ``Y_DTYPES_F64``: float64,
bfloat16, int16 or int8). The kernels load it in that type and convert it
in registers; the plain versions convert it to the compute dtype (the other
operands' dtype) first. Every other operand is in the compute dtype, and a
mix of float32 and float64 operands raises.

``log_mu=None`` skips A2 (the ELBO step replaces it with a precomputed
column-sum dot, see ``models/multinomial.elbo``); A2 is then returned as None.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

MAX_KF = 4   # psi_ext columns the narrow kernels take
MAX_A2 = 4   # A2 columns (Monte Carlo samples) the narrow kernels take
MAX_SC = 32  # Z columns (samples x clones) the narrow kernels take
# The wide forward's and gene part's tiles (the .cu's kWideTiles,
# kWideTileCounts, kWideYTileCounts, kFwdWideGenes and kGeneWideCells):
# accumulator tiles of 8 columns a warp holds at most, the tile counts the
# kernels are built for (Z tiles a forward group, d(muL) tiles a gene pass;
# Y tiles), the genes the forward's table is padded to, cells a gene-part
# stage.
WIDE_TILES = 16
WIDE_TILE_COUNTS = (1, 2, 4, 6, 8, 10, 12, 16)
WIDE_Y_TILE_COUNTS = (1, 2, 4, 8, 16)
_FWD_WIDE_GENES = 32
_GENE_WIDE_CELLS = 16
# dpsi_wide_kernel's built counts (the .cu's kDpsiKCounts, kDpsiZCounts):
# tiles of [psi, X], and dZ tiles a column group (held in registers); its
# blocks' warps (kDpsiWarps), and the shared memory a block may take for two
# blocks an SM (the .cu's kTwoBlockSmem: 228 KB an SM, 1 KB a block kept).
WIDE_DPSI_K_COUNTS = (1, 2, 4, 8)
WIDE_DPSI_Z_COUNTS = (1, 2, 4, 6, 8, 10)
_DPSI_WIDE_WARPS = 4
_TWO_BLOCK_SMEM = (228 - 2) // 2 * 1024
# The old bound: past Kf = K + P 64, 64 A2 columns or S*C 2,048 the
# backward is the split one (:func:`split_route`), whose kernels (the .cu's
# kSb*) take blocks of 64 x 64 outputs, two an SM, and stages of 32 values
# of K in a ring of 3, over row blocks of cells whose workspace buffer
# holds at most _SPLIT_ELEMENTS floats (past one tile of cells).
SPLIT_KF, SPLIT_A2, SPLIT_SC = 64, 64, 2048
_SPLIT_M, _SPLIT_N, _SPLIT_K, _SPLIT_STAGES, _SPLIT_BLOCKS = 64, 64, 32, 3, 2
_SPLIT_ELEMENTS = 1 << 23
# The share of its last wave a split product over gene ranges fills at
# least (:func:`_gene_ranges`).
_WAVE_FILL = 0.9
_ROWS_PER_CHUNK = 1024  # cells per partial sum of the gene-major backward
# Y storage types the kernels load, with the code the C entry points take
Y_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2, torch.int8: 3}
# ... and those the float64 family loads. ``y_storage="float32"`` (or None)
# means the compute dtype (api._Y_STORAGE), so a float64 fit stores Y as
# float64 there; code 0 is that compute dtype.
Y_DTYPES_F64 = {torch.float64: 0, torch.bfloat16: 1, torch.int16: 2, torch.int8: 3}
# The float64 family's geometry. dpsi_f64_kernel (the .cu's kDpsiWarps,
# kDpsiKCounts, kDpsiZCounts): warps of 16 cells a block, which walk the
# genes in k-steps of 8; the tile counts of [psi, X] (log_rfe's and dpsi's)
# and of dZ a column group (drfe's) it is built for. fwd_f64_kernel and
# gene_f64_kernel (kFwdWarps, kFwdGenes, kGeneWarps, kGeneCells): warps of
# 16 cell (gene) rows a block, genes (cells) a stage; their columns count
# in tiles of 8, and the tile counts they are built for (kFwdTileCounts;
# kGeneKCounts, dW's tiles a pass, and beside each the counts of
# kGeneTileCounts); the bytes of Y a stage takes at the widest storage
# (float64); the most dynamic shared memory a block may take on the card.
F64_DPSI_WARPS = 4
F64_DPSI_K_COUNTS = (1, 2, 4, 8)
F64_DPSI_Z_COUNTS = (1, 2, 4, 6, 8, 10)
F64_FWD_WARPS = 4
F64_FWD_GENES = 32
F64_GENE_WARPS = 4
F64_GENE_CELLS = 32
F64_FWD_TILE_COUNTS = (1, 2, 3, 4, 6, 8, 12)
F64_GENE_K_COUNTS = (1, 2, 8)
F64_GENE_TILE_COUNTS = {1: (1, 2, 3, 4, 5), 2: (1, 2, 4), 8: (1, 2)}
F64_FWD_Y_STAGE_BYTES = 20_480
F64_GENE_Y_STAGE_BYTES = 16_896
F64_MAX_SMEM = 232_448
# The float64 split kernels' blocks an SM (the f64 .cu's __launch_bounds__
# of dlog_rfe_f64_kernel, gene_product_f64_kernel and
# dpsi_product_f64_kernel).
_F64_SPLIT_BLOCKS = 3

# Kernel launches, each counted by the wrapper that launches the kernel:
# the narrow kernels' and the wide family's apart.
fwd_launches = 0
dpsi_launches = 0
gene_launches = 0  # the gene-major backward kernel with its packing and chunk reduction
fwd_wide_launches = 0
dpsi_wide_launches = 0
gene_wide_launches = 0  # the wide gene-part kernel with its chunk reduction
split_launches = 0  # kernel_backward past the old bound: dpsi and the gene part in one call
fwd_f64_launches = 0
dpsi_f64_launches = 0
gene_f64_launches = 0  # the float64 gene-part kernel with its chunk reduction
split_f64_launches = 0  # the same one call in float64


def reset_launch_counts() -> None:
    global fwd_launches, dpsi_launches, gene_launches
    global fwd_wide_launches, dpsi_wide_launches, gene_wide_launches, split_launches
    global fwd_f64_launches, dpsi_f64_launches, gene_f64_launches, split_f64_launches
    fwd_launches = 0
    dpsi_launches = 0
    gene_launches = 0
    fwd_wide_launches = 0
    dpsi_wide_launches = 0
    gene_wide_launches = 0
    split_launches = 0
    fwd_f64_launches = 0
    dpsi_f64_launches = 0
    gene_f64_launches = 0
    split_f64_launches = 0


def wide_route(Kf: int, n_a2: int, SC: int) -> bool:
    """Whether a call with Kf columns of ``[psi, X]``, n_a2 A2 columns (0
    without A2; the dpsi kernel has none) and SC sample x clone columns goes
    to the wide family: exactly when a width is past a narrow limit."""
    return Kf > MAX_KF or n_a2 > MAX_A2 or SC > MAX_SC


def split_route(Kf: int, n_a2: int, SC: int) -> bool:
    """Whether the wide family's forward and backward at these widths are the
    split ones (``dlog_rfe_kernel`` and the tiled products, :func:`wide_plan`'s
    ``split``; in float64 the split gene part, :func:`f64_plan`'s):
    exactly past the old bound, Kf 64, n_a2 64 or SC 2,048. The old widths
    keep ``fwd_wide_kernel``'s Z groups and the ungrouped
    ``dpsi_wide_kernel`` and ``gene_wide_kernel`` (``gene_f64_kernel``)."""
    return Kf > SPLIT_KF or n_a2 > SPLIT_A2 or SC > SPLIT_SC


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def reference_likelihood_terms(Y, psi_ext, W_ext, log_mu, muL):
    """Plain PyTorch version of the forward contract (materializes the
    N x G ``exp(log_rfe)``). ``log_mu=None`` returns None for A2."""
    Y = Y.to(psi_ext.dtype)
    log_rfe = psi_ext @ W_ext.T
    A1 = torch.sum(Y * log_rfe, dim=1)
    A2 = None if log_mu is None else Y @ log_mu.T
    Z = torch.exp(log_rfe) @ muL
    return A1, A2, Z


def reference_likelihood_vjp(Y, psi_ext, W_ext, muL, dA1, dA2, dZ):
    """Plain PyTorch version of the backward contract: with
    ``rfe = exp(psi_ext W_ext^T)``, ``drfe = dZ muL^T`` and
    ``dlog_rfe = Y dA1 + rfe drfe``, returns ``dpsi = dlog_rfe W_ext``,
    ``dW = dlog_rfe^T psi_ext``, ``dlog_mu = dA2^T Y`` (None when ``dA2`` is
    None) and ``dmuL = rfe^T dZ``. The narrow gene-major CUDA kernel
    computes dW in another association (:func:`reference_gene`); the wide
    gene kernel in this one."""
    Y = Y.to(psi_ext.dtype)
    rfe = torch.exp(psi_ext @ W_ext.T)
    dlog_rfe = Y * dA1[:, None] + rfe * (dZ @ muL.T)
    dpsi = dlog_rfe @ W_ext
    dW = dlog_rfe.T @ psi_ext
    dlog_mu = None if dA2 is None else dA2.T @ Y
    dmuL = rfe.T @ dZ
    return dpsi, dW, dlog_mu, dmuL


def reference_dpsi(YW, psi_ext, W_ext, muL, dA1, dZ):
    """Plain PyTorch version of the dpsi kernel, which reads no Y: with
    ``YW = Y @ W_ext`` from the forward and
    ``T[n,k,j] = sum_g rfe[n,g] W_ext[g,k] muL[g,j]``,
    ``dpsi = dA1 * YW + sum_j dZ[:, j] T[:, :, j]``, which equals
    ``dlog_rfe @ W_ext`` exactly. Materializes ``rfe * W_ext[:, k]``."""
    rfe_w = torch.exp(psi_ext @ W_ext.T)[:, None, :] * W_ext.T[None]  # (N, Kf, G)
    T = rfe_w @ muL                                                    # (N, Kf, SC)
    return dA1[:, None] * YW + (T @ dZ[:, :, None])[:, :, 0]


def reference_gene(Y, psi_ext, W_ext, muL, dA1, dA2, dZ):
    """Plain PyTorch version of the gene-major kernel, in its re-associated
    form: with ``rfe = exp(psi_ext W_ext^T)`` and
    ``E[g,j,k] = sum_n rfe[n,g] dZ[n,j] psi_ext[n,k]``, returns
    ``dW = Y^T (dA1 psi_ext) + sum_j muL[:, j] E[:, j, :]``, ``dlog_mu =
    dA2^T Y`` (None when ``dA2`` is None) and ``dmuL = rfe^T dZ``, which equal
    :func:`reference_likelihood_vjp`'s exactly; ``dZ muL^T`` is never
    formed."""
    (N, SC), G, Kf = dZ.shape, W_ext.shape[0], psi_ext.shape[1]
    Y = Y.to(psi_ext.dtype)
    rfe = torch.exp(psi_ext @ W_ext.T)
    dmuL = rfe.T @ dZ
    E = (rfe.T @ (dZ[:, :, None] * psi_ext[:, None, :]).reshape(N, SC * Kf)).reshape(G, SC, Kf)
    dW = Y.T @ (dA1[:, None] * psi_ext) + (muL[:, :, None] * E).sum(1)
    dlog_mu = None if dA2 is None else dA2.T @ Y
    return dW, dlog_mu, dmuL


def _plain_forward(Y, psi_ext, W_ext, log_mu, muL):
    return (*reference_likelihood_terms(Y, psi_ext, W_ext, log_mu, muL), None)


def _plain_backward(Y, psi_ext, W_ext, muL, dA1, dA2, dZ, _YW):
    return reference_likelihood_vjp(Y, psi_ext, W_ext, muL, dA1, dA2, dZ)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _check(name, t, shape, dtypes):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {', '.join(map(str, dtypes))} for the "
                         f"CUDA kernels, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_sizes(N, G, SC):
    if N < 1 or G < 1 or SC < 1:
        raise ValueError(f"the CUDA kernels need N, G, S*C >= 1, got N={N}, G={G}, S*C={SC}")


def _chunk_rows(N: int) -> int:
    """Cells a partial sum of the gene-major backward (narrow or wide) takes:
    grid.y is at most 65535 chunks, and a chunk is a whole number of 64-cell
    tiles (and so of the wide gene part's 16-cell stages)."""
    return -(-max(_ROWS_PER_CHUNK, -(-N // 65535)) // 64) * 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _at_least(counts, t: int) -> int:
    """The least of the built tile counts that is >= t (else the largest)."""
    return next((c for c in counts if c >= t), counts[-1])


# The plan's numbers, in the order the C entry points take them.
WIDE_PLAN_KEYS = ("n_kc", "n_zt", "n_yt", "n_st", "g_pad", "zt_group", "n_zgroups", "ny_pad",
                  "rows", "n_chunks", "n_pad", "nj", "mu_passes", "y_pass", "n_passes",
                  "table", "part", "dz", "ps", "a2", "a1",
                  "dk_pad", "dz_group", "n_dgroups", "dsteps", "dtable",
                  "n_ygroups", "a1_parts", "a1part", "split", "ldw", "dsplit", "dgenes",
                  "gslices", "gcells", "ldz", "zsplit", "zgenes")
# The most dynamic shared memory a block may take on the card (227 KB).
MAX_SMEM = 232_448


def split_smem(y_itemsize: int = 4) -> dict:
    """The split backward's kernels' dynamic shared memory in bytes (the
    .cu's sb_smem): three stages of their tiles, rows padded so that the
    fragments' reads hit 32 banks; ``gene_y`` is dlog mu's product at Y's
    itemsize."""
    m, n, k = _SPLIT_M, _SPLIT_N, _SPLIT_K
    y_pitch = 4 * (n + 8) if y_itemsize == 4 else n * y_itemsize + 16
    stages = {"dlog": (m + n) * (k + 4), "dpsi": m * (k + 4) + k * (n + 8),
              "gene": k * (m + 8) + k * (n + 8), "gene_y": k * (m + 8) + k * y_pitch // 4}
    return {name: 4 * _SPLIT_STAGES * floats for name, floats in stages.items()}


def _wide_smem(p: dict) -> dict:
    """Each wide kernel's dynamic shared memory in bytes under plan p (the
    .cu's fwd_wide_smem, fwd_wide_y_smem and gene_wide_smem at float32 Y,
    the widest storage, and dpsi_wide_smem; where the plan is the split one,
    the forward's and the gene part's dlog_rfe_kernel, dpsi_product_kernel,
    and gene_product_kernel's, :func:`split_smem`), and the forward's k-steps
    a stage (0 for the split forward)."""
    n_kc, nz, ny, nj = p["n_kc"], p["zt_group"], p["ny_pad"], p["nj"]

    def groups(tiles):  # past 10 tiles two warps share a row group
        return 4 if tiles > 10 else 8

    def fwd(steps):
        a = groups(nz) * steps * 2 * 32 if nz > 10 else 0
        return 16 * (groups(nz) * n_kc * 2 * 32 + 2 * steps * (n_kc + nz) * 32 + a)

    y_stage = 4 * ny * 32 + groups(ny) * 16 * (32 * 4 + 16) // 16
    if p["split"]:  # the split forward's rfe kernel, and its Z product dpsi's
        sb = split_smem()
        return dict(fwd=sb["dlog"], fwd_steps=0, fwd_y=16 * 2 * y_stage, gene=sb["dlog"],
                    dpsi=sb["dpsi"], gene_products=sb["gene"], gene_y=sb["gene_y"])
    steps = 4 if fwd(4) <= _TWO_BLOCK_SMEM else 2
    out = dict(fwd=fwd(steps), fwd_steps=steps, fwd_y=16 * 2 * y_stage)
    strides = (8 * nj + 4) + (8 * n_kc + 4) + (8 * p["n_st"] + 4 if p["n_st"] else 0)
    g_stage = (2 * _GENE_WIDE_CELLS * strides + _GENE_WIDE_CELLS) // 4 + _GENE_WIDE_CELLS * (64 * 4 + 16) // 16
    dpsi = 16 * (_DPSI_WIDE_WARPS * 3 * p["dk_pad"] * 32
                 + 2 * p["dsteps"] * (2 * p["dk_pad"] + p["dz_group"]) * 32)
    return dict(out, gene=16 * (4 * (n_kc + 2 * nj) * 32 + 2 * g_stage), dpsi=dpsi)


def _split_rows(N: int, G: int, elements: int = _SPLIT_ELEMENTS, align: int = 4) -> tuple:
    """The split kernels' row blocks: (cells a block, blocks, the
    workspace's row pitch, a whole number of ``align`` values). A block
    holds at most ``elements`` values of rfe (or dlog_rfe) past one tile of
    64 cells, and the blocks are as even as whole tiles make them."""
    ldw = _cdiv(G, align) * align
    most = max(_SPLIT_M, elements // ldw // _SPLIT_M * _SPLIT_M)
    n_blocks = _cdiv(N, most)
    rows = _cdiv(_cdiv(N, n_blocks), _SPLIT_M) * _SPLIT_M
    return rows, _cdiv(N, rows), ldw


def _cell_slices(N: int, rows: int, n_chunks: int, products: int, slots: int) -> tuple:
    """(gslices, gcells): one row block's gene products (``products``
    blocks) in slices of cells where their blocks would not fill the
    card's ``slots`` (blocks an SM x 132) twice over, slices of 256 cells at
    least and whole stages of 32; one slice of ``rows`` otherwise."""
    if n_chunks > 1 or products >= 2 * slots:
        return 1, rows
    gslices = max(1, min(_cdiv(2 * slots, products), _cdiv(N, 256)))
    gcells = _cdiv(_cdiv(N, gslices), 32) * 32
    gslices = _cdiv(N, gcells)
    return (gslices, gcells) if gslices > 1 else (1, rows)


def _gene_ranges(tiles: int, G: int, slots: int = _SPLIT_BLOCKS * 132) -> tuple:
    """(ranges, genes a range): a tiled product over genes, ``tiles`` blocks
    of 64 x 64 outputs a row block (the split forward's Z = rfe muL; in
    float64 also dpsi = t W), in gene ranges of whole stages of 32 (256
    genes at least), the fewest whose blocks fill their last wave of
    ``slots`` (blocks an SM x 132 SMs; float32's two an SM by default) to
    _WAVE_FILL (else the best fill): the blocks of one range run in whole
    waves only where the tiles happen to."""

    def fill(z):
        return tiles * z / (_cdiv(tiles * z, slots) * slots)

    most = max(1, _cdiv(G, 256))
    return _even_ranges(G, next((z for z in range(1, most + 1) if fill(z) >= _WAVE_FILL),
                                max(range(1, most + 1), key=fill)))


def _even_ranges(G: int, n: int) -> tuple:
    """(ranges, genes a range): G genes in about ``n`` even ranges of whole
    stages of 32 genes."""
    genes = _cdiv(_cdiv(G, n), 32) * 32
    return _cdiv(G, genes), genes


def _split_fwd_workspace(plan: dict, G: int, SC: int) -> int:
    """The split forward's workspace in floats, as ``fl_forward_wide`` lays
    it out: the packed table, ``a1part``, the row block's rfe (``rows`` x
    ``ldw``), the gene ranges' sums of Z (``zsplit`` x ``rows`` x SC in
    whole float4s, where more than one) and muL at a pitch of ``ldz`` (G x
    ``ldz``)."""
    zpart = _cdiv(plan["zsplit"] * plan["rows"] * SC, 4) * 4 if plan["zsplit"] > 1 else 0
    return plan["table"] + plan["a1part"] + plan["rows"] * plan["ldw"] + zpart + G * plan["ldz"]


def wide_plan(N: int, G: int, Kf: int, n_a2: int, SC: int) -> dict:
    """The wide family's launch plan for N cells, G genes,
    Kf columns of ``[psi, X]``, n_a2 A2 columns and SC Z columns: the one
    place it is decided. The C entry points take its ``WIDE_PLAN_KEYS``
    (:func:`_plan_arg`), check that they fit the sizes, and lay out each
    kernel's shared memory from them.

    Widths count in tiles of 8 columns: ``n_kc`` of ``[psi, X]``, ``n_zt`` of
    Z, ``n_yt`` of the Y products ``[Y W | Y log mu^T]``, ``n_st`` of dA2.
    A kernel's loop over tiles runs a built count of them
    (``WIDE_TILE_COUNTS``, ``WIDE_Y_TILE_COUNTS``), the tiles zero-padded.

    Forward: Z's tiles split evenly into ``n_zgroups`` column groups of at
    most ``WIDE_TILES`` (grid.y of ``fwd_wide_kernel``; each recomputes the
    exps), each padded to ``zt_group`` (past the old bound none: the split
    forward forms rfe a row block, below, and Z = rfe muL in ``zsplit``
    ranges of ``zgenes`` genes, :func:`_gene_ranges`); the Y products' tiles split evenly
    into ``n_ygroups`` groups of at most 16 (grid.y of ``fwd_wide_y_kernel``,
    each a read of Y), each padded to ``ny_pad``. Where one warp holds
    every column of Y W, it writes A1; else (``a1_parts`` > 0) each warp
    writes its columns' share to a row of ``a1part`` and the entry point
    adds the rows.

    Backward, where ``split`` (:func:`split_route`: past the old bound):
    ``n_chunks`` row blocks of ``rows`` cells (:func:`_split_rows`), whose
    rfe and dlog_rfe ``dlog_rfe_kernel`` writes to a workspace of ``rows``
    rows ``ldw`` floats apart, and the tiled products take from it;
    dpsi's product over ``dsplit`` ranges of ``dgenes`` genes (whole stages
    of 32), enough blocks for two an SM on 132 SMs where the genes allow
    (ranges of 256 genes at least); the gene part's products in ``gslices``
    slices of ``gcells`` cells where a single row block's would not fill
    the card twice over (slices of 256 cells at least; one slice of
    ``rows`` otherwise); where SC is no multiple of 4, dZ's row block and
    muL copied to a row pitch of ``ldz`` floats, a multiple of 4 (else 0).
    The keys of the gene part's and dpsi's other kernels are then 0, and
    the forward's Z groups' (``n_zgroups``, ``zt_group``).

    Else, gene part: chunks of ``rows`` cells (:func:`_chunk_rows`), each a
    block row of partial sums; dW's ``n_kc`` tiles, at most 8, beside
    ``mu_passes`` passes over dZ's tiles, ``nj`` tiles each (and dlog mu's
    ``n_st``, at most 8, in the first pass, unless they leave no room: then
    dlog mu takes ``y_pass`` = 1 pass of its own first, in d(muL)'s tiles),
    ``n_passes`` in all. dpsi: ``[psi, X]``'s tiles padded to ``dk_pad``
    (``WIDE_DPSI_K_COUNTS``); dZ's tiles split evenly into ``n_dgroups``
    column groups of at most 10 (one after another in a block, each
    recomputing the exps), each padded to ``dz_group``
    (``WIDE_DPSI_Z_COUNTS``); ``dsteps`` k-steps of 8 genes a stage, 4
    unless that leaves room for one block an SM (``dpsi_smem`` bytes of
    shared memory a block).

    Workspace, in float32 values: ``table``, the forward's packed gene-side
    B fragments (past the old bound only the Y products'), and ``a1part``;
    ``part`` (the partial sums), ``dz``,
    ``ps``, ``a2`` and ``a1`` (the packed cell side), the gene part's
    scratch; ``dtable``, dpsi's packed gene side. ``fwd_workspace``,
    ``dpsi_workspace`` and ``gene_workspace`` are what :func:`kernel_forward`,
    :func:`kernel_dpsi` and :func:`kernel_gene` allocate for the kernels,
    the last with its (Kf + SC + n_a2, G) output; where ``split``, the
    forward's is the table and ``a1part``, the row block's rfe (``rows`` x
    ``ldw``), the ranges' sums of Z (``zsplit`` x ``rows`` x SC, where more
    than one) and muL at a pitch of ``ldz`` (G x ``ldz``); dpsi's is
    the row block's t = rfe drfe and the ranges' sums (``dsplit`` x ``rows``
    x Kf), the gene part's the row block's rfe and dlog_rfe, the ranges'
    sums (which only :func:`kernel_backward`'s call, with dpsi, fills) and
    the slices' partial sums (``gslices`` x (Kf + SC + n_a2) x G, where
    more than one), each with (``rows`` + G) x ``ldz`` for the padded
    copies. ``bwd_workspace`` is what :func:`kernel_backward` allocates
    beside dpsi: where ``split``, the gene part's (one call forms both
    parts); else the two parts' workspaces.

    A width whose kernels' shared memory (``smem``) passes the card's
    ``MAX_SMEM`` a block raises a ValueError, and none does: within the old
    bound (Kf up to 64) every kernel fits two blocks an SM, and past it
    every kernel's tiles are fixed, so Kf takes any width."""
    n_kc, n_zt, n_yt, n_st = _cdiv(Kf, 8), _cdiv(SC, 8), _cdiv(Kf + n_a2, 8), _cdiv(n_a2, 8)
    g_pad = _cdiv(G, _FWD_WIDE_GENES) * _FWD_WIDE_GENES
    split = split_route(Kf, n_a2, SC)
    n_zgroups = 0 if split else _cdiv(n_zt, WIDE_TILES)
    zt_group = 0 if split else _at_least(WIDE_TILE_COUNTS, _cdiv(n_zt, n_zgroups))
    n_ygroups = _cdiv(max(n_yt, 1), WIDE_Y_TILE_COUNTS[-1])
    ny_pad = _at_least(WIDE_Y_TILE_COUNTS, _cdiv(max(n_yt, 1), n_ygroups))
    halves = 2 if ny_pad > 10 else 1
    a1_parts = 0 if n_ygroups == 1 and Kf <= 8 * (ny_pad // halves) else n_ygroups * halves
    a1part = _cdiv(a1_parts * N, 4) * 4
    # the table's tiles a k-step: W^T's and the Z groups' (none for the
    # split forward), then the Y products'
    table = g_pad // 8 * ((0 if split else n_kc) + n_zgroups * zt_group
                          + n_ygroups * ny_pad) * 32 * 4
    F = Kf + SC + n_a2
    if split:
        rows, n_chunks, ldw = _split_rows(N, G)
        base = _cdiv(rows, _SPLIT_M) * _cdiv(max(Kf, 1), _SPLIT_N)
        dsplit, dgenes = _even_ranges(G, max(1, min(_cdiv(_SPLIT_BLOCKS * 132, base),
                                                      _cdiv(G, 256))))
        products = _cdiv(G, _SPLIT_N) * (_cdiv(Kf, _SPLIT_M) + _cdiv(SC, _SPLIT_M))
        gslices, gcells = _cell_slices(N, rows, n_chunks, products, _SPLIT_BLOCKS * 132)
        zsplit, zgenes = _gene_ranges(_cdiv(rows, _SPLIT_M) * _cdiv(SC, _SPLIT_N), G)
        gene = dict.fromkeys(("n_pad", "nj", "mu_passes", "y_pass", "n_passes", "part", "dz",
                              "ps", "a2", "a1", "dk_pad", "dz_group", "n_dgroups", "dsteps",
                              "dtable"), 0)
        # dZ and muL copied to a row pitch of whole float4s where S*C is
        # none (the kernels' copies of them are then 16 bytes)
        ldz = _cdiv(SC, 4) * 4 if SC % 4 else 0
        gene.update(rows=rows, n_chunks=n_chunks, split=1, ldw=ldw, dsplit=dsplit, dgenes=dgenes,
                    gslices=gslices, gcells=gcells, ldz=ldz, zsplit=zsplit, zgenes=zgenes)
    else:
        rows = _chunk_rows(N)
        n_chunks = _cdiv(N, rows)
        n_pad = _cdiv(N, _GENE_WIDE_CELLS) * _GENE_WIDE_CELLS
        # dlog mu takes a pass of its own where it leaves d(muL) no room
        # beside dW's tiles
        y_pass = 1 if n_kc + n_st >= WIDE_TILES else 0
        room = WIDE_TILES - n_kc - (0 if y_pass else n_st)
        nj = _at_least(WIDE_TILE_COUNTS, max(_cdiv(n_zt, _cdiv(n_zt, room)),
                                             min(n_st, room) if y_pass else 1))
        if nj > room:
            nj = max(c for c in WIDE_TILE_COUNTS if c <= room)
        mu_passes = _cdiv(n_zt, nj)
        dk_pad = _at_least(WIDE_DPSI_K_COUNTS, max(n_kc, 1))
        n_dgroups = _cdiv(n_zt, WIDE_DPSI_Z_COUNTS[-1])
        dz_group = _at_least(WIDE_DPSI_Z_COUNTS, _cdiv(n_zt, n_dgroups))

        def dpsi_smem(steps):  # the warps' psi fragments and float64 sums, two stage buffers
            return 16 * 32 * (_DPSI_WIDE_WARPS * 3 * dk_pad
                              + 2 * steps * (2 * dk_pad + dz_group))

        dsteps = 4 if dpsi_smem(4) <= _TWO_BLOCK_SMEM else 2
        gene = dict(rows=rows, n_chunks=n_chunks, n_pad=n_pad, nj=nj, mu_passes=mu_passes,
                    y_pass=y_pass, n_passes=mu_passes + y_pass,
                    part=_cdiv(n_chunks * F * G, 4) * 4, dz=n_pad * 16 * mu_passes * nj,
                    ps=n_pad * 16 * n_kc, a2=n_pad * 16 * n_st, a1=n_pad, dk_pad=dk_pad,
                    dz_group=dz_group, n_dgroups=n_dgroups, dsteps=dsteps,
                    dtable=g_pad // 8 * (2 * dk_pad + n_dgroups * dz_group) * 32 * 4,
                    split=0, ldw=0, dsplit=0, dgenes=0, gslices=0, gcells=0, ldz=0, zsplit=0,
                    zgenes=0)
    plan = dict(n_kc=n_kc, n_zt=n_zt, n_yt=n_yt, n_st=n_st, g_pad=g_pad, zt_group=zt_group,
                n_zgroups=n_zgroups, ny_pad=ny_pad, table=table, n_ygroups=n_ygroups,
                a1_parts=a1_parts, a1part=a1part, **gene)
    plan = {k: plan[k] for k in WIDE_PLAN_KEYS}
    plan["dpsi_smem"] = None if split else dpsi_smem(plan["dsteps"])
    plan["smem"] = _wide_smem(plan)
    worst = max(v for k, v in plan["smem"].items() if k != "fwd_steps")
    if worst > MAX_SMEM:
        raise ValueError(
            f"the wide CUDA kernels at Kf={Kf}, S={n_a2}, S*C={SC} need {worst} bytes of shared "
            f"memory a block, past the card's {MAX_SMEM} (227 KB)")
    plan["fwd_workspace"] = table + a1part
    if split:
        block, dpart = plan["rows"] * plan["ldw"], plan["dsplit"] * plan["rows"] * Kf
        gpart = _cdiv(plan["gslices"] * F * G, 4) * 4 if plan["gslices"] > 1 else 0
        pad = (plan["rows"] + G) * plan["ldz"]
        plan["fwd_workspace"] = _split_fwd_workspace(plan, G, SC)
        plan["dpsi_workspace"] = block + dpart + pad
        plan["gene_workspace"] = 2 * block + dpart + gpart + pad + F * G
        plan["bwd_workspace"] = plan["gene_workspace"]
    else:
        plan["dpsi_workspace"] = plan["dtable"]
        plan["gene_workspace"] = (plan["part"] + plan["dz"] + plan["ps"] + plan["a2"]
                                  + plan["a1"] + F * G)
        plan["bwd_workspace"] = plan["gene_workspace"] + (plan["dpsi_workspace"] if Kf else 0)
    return plan


def _plan_arg(plan: dict, keys=WIDE_PLAN_KEYS):
    """:func:`wide_plan`'s numbers (or with ``keys=F64_PLAN_KEYS``
    :func:`f64_plan`'s) as the C entry points take them."""
    return (ctypes.c_longlong * len(keys))(*(plan[k] for k in keys))


# f64_plan's numbers, in the order the C entry points take them.
F64_PLAN_KEYS = ("f_yt", "f_tiles", "f_count", "f_nt", "f_groups", "f_blocks", "f_smem",
                 "d_nk", "d_nz", "d_groups", "d_steps", "d_blocks", "d_smem",
                 "g_st", "g_tiles", "g_nk", "g_count", "g_nt", "g_passes", "g_blocks", "rows",
                 "n_chunks", "g_smem", "part", "f_table", "g_table", "d_table", "split", "ldw",
                 "gslices", "gcells", "dsplit", "dgenes", "zsplit", "zgenes")


def f64_fwd_smem(klr: int, nt: int) -> int:
    """fwd_f64_kernel's dynamic shared memory in bytes: its warps' psi rows,
    and two stages, each the B fragments of nt tiles and W for 32 genes and
    the warps' Y rows (float64's room); klr columns of psi and W, those of
    log_rfe (Kf, or none past the old bound, where it forms none)."""
    return (8 * (F64_FWD_WARPS * 16 * klr + 2 * (F64_FWD_GENES * (8 * nt + klr)))
            + 2 * F64_FWD_Y_STAGE_BYTES)


def f64_dpsi_smem(nk: int, nz: int, steps: int) -> int:
    """dpsi_f64_kernel's dynamic shared memory in bytes: its warps' psi (2
    nk tiles of 32 pairs each), and two stages of ``steps`` k-steps, each
    the B fragments (32 pairs a tile) of nz muL^T tiles, nk W tiles and,
    past nk = 1, nk W^T tiles (log_rfe's)."""
    return 16 * 32 * (F64_DPSI_WARPS * 2 * nk + 2 * steps * (nz + nk + (nk if nk > 1 else 0)))


def f64_gene_smem(Kf: int, nt: int, nk: int) -> int:
    """gene_f64_kernel's dynamic shared memory in bytes: its warps' W rows,
    and two stages, each for 32 cells the B fragments of drfe's and the
    pass's nt tiles (64 doubles each), of dW's nk tiles, psi for log_rfe and
    dA1, and the block's Y (float64's room)."""
    return (8 * (F64_GENE_WARPS * 16 * Kf
                 + 2 * (F64_GENE_CELLS * (16 * nt + 8 * nk + Kf) + F64_GENE_CELLS))
            + 2 * F64_GENE_Y_STAGE_BYTES)


def f64_plan(N: int, G: int, Kf: int, n_a2: int, SC: int) -> dict:
    """The float64 family's launch plan for N cells, G genes, Kf columns of
    ``[psi, X]``, n_a2 A2 columns and SC Z columns: the one place it is
    decided. The C entry points take its ``F64_PLAN_KEYS``
    (``_plan_arg(plan, F64_PLAN_KEYS)``) and check that they fit the sizes.

    Columns count in tiles of 8 (the FP64 MMA's n). Forward: ``f_yt`` tiles of
    the Y products ``[Y W | Y log mu^T]`` then Z's, ``f_tiles`` in all, split
    evenly into ``f_groups`` column groups (grid.y) of ``f_count`` tiles, each
    group's accumulators the built count ``f_nt`` (``F64_FWD_TILE_COUNTS``, at
    most 12) and each group recomputing the exps it needs; ``f_blocks`` blocks
    of ``F64_FWD_WARPS`` x 16 cells. dpsi: ``[psi, X]``'s tiles in the built
    count ``d_nk`` (``F64_DPSI_K_COUNTS``; 1 up to Kf 8, where log_rfe takes Kf
    FMAs, else MMAs), dZ's tiles split evenly into ``d_groups`` groups (one
    after another in a block, each recomputing the exps) of the built count
    ``d_nz`` (``F64_DPSI_Z_COUNTS``, at most 10), ``d_steps`` k-steps of 8
    genes a stage (4 unless that leaves room for one block an SM), ``d_blocks``
    blocks of ``F64_DPSI_WARPS`` x 16 cells. Gene part: ``g_st`` tiles of dlog
    mu then d(muL)'s, ``g_tiles`` in all, split evenly into ``g_passes`` passes
    of ``g_count`` tiles (the built count ``g_nt``), beside dW's ``g_nk`` tiles
    (``F64_GENE_K_COUNTS``; ``F64_GENE_TILE_COUNTS[g_nk]`` the pass's counts,
    so that the registers hold them); ``g_blocks`` blocks of ``F64_GENE_WARPS``
    x 16 genes by ``n_chunks`` chunks (grid.y) of ``rows`` cells
    (:func:`_chunk_rows`). ``f_smem``, ``d_smem`` and ``g_smem`` are each
    kernel's dynamic shared memory in bytes (:func:`f64_fwd_smem`,
    :func:`f64_dpsi_smem`, :func:`f64_gene_smem`).

    Workspace, in float64 values: ``f_table``, the forward's gene side packed
    once a call in the order its stages take it (``fwd_f64_pack_kernel``: each
    stage's B fragments of every tile and W for log_rfe), which is
    ``fwd_workspace``; ``d_table``, dpsi's gene side likewise
    (``dpsi_f64_pack_kernel``: for each k-step of 8 genes, G padded to whole
    stages, the B fragments of every group's muL^T tiles, of W in C-to-A order
    and, past ``d_nk`` 1, of W^T), which is ``dpsi_workspace``; ``part``, the
    gene part's partial sums (n_chunks x (Kf + SC + n_a2) x G, rounded up to
    even so that the table after them is 16-byte aligned), and ``g_table``, its
    cell side packed likewise (``gene_f64_pack_kernel``: each 32-cell stage's B
    fragments of drfe, of every tile and of dW, psi for log_rfe and dA1);
    ``gene_workspace``, what :func:`kernel_gene` allocates: the partial sums,
    the table and its (Kf + SC + n_a2, G) output; ``bwd_workspace``, what
    :func:`kernel_backward` allocates beside dpsi: the gene part's and dpsi's.

    Past the old bound (:func:`split_route`: ``split``) the forward, dpsi and
    the gene part are the split ones, over ``n_chunks`` row blocks of ``rows``
    cells (:func:`_split_rows` at 2^22 doubles a buffer, half the float32
    one's cells) whose rfe (and t or dlog_rfe) ``dlog_rfe_f64_kernel`` writes
    to a workspace of ``rows`` rows ``ldw`` doubles apart (an even count):
    the forward's Z = rfe muL by ``dpsi_product_f64_kernel`` over ``zsplit``
    gene ranges of ``zgenes`` genes and A1 from the rfe kernel's log_rfe,
    its Y products' ``f_yt`` tiles (at least one) alone in
    ``fwd_f64_kernel``'s groups (``f_tiles`` = ``f_yt``), which form no
    log_rfe and no exp and hold no psi or W (``f_smem`` and ``f_table``
    without them); dpsi = t W (or in :func:`kernel_backward`'s one call dlog_rfe
    W) over ``dsplit`` ranges of ``dgenes`` (each product's ranges
    :func:`_gene_ranges`' at three blocks an SM, ``_F64_SPLIT_BLOCKS``); the
    gene part's dW, d(muL) and dlog mu by ``gene_product_f64_kernel``, a
    single row block's cells in ``gslices`` slices of ``gcells`` where its
    blocks would not fill three an SM twice over (:func:`_cell_slices`;
    ``part`` their partial sums). The grouped dpsi's and gene part's keys
    are then 0. ``fwd_workspace`` is the table, the row block's rfe, the
    ranges' sums of Z (``zsplit`` x ``rows`` x SC where more than one) and
    A1's partial sums (``rows`` x 2 ceil(G / 64): a row's over each 32 genes);
    ``dpsi_workspace`` the row block's t and the ranges' sums of dpsi
    (``dsplit`` x ``rows`` x Kf); ``gene_workspace`` ``part``, the row block's
    rfe and dlog_rfe, dpsi's ranges' sums (which only the one call with dpsi
    fills) and the output, and ``bwd_workspace`` the same. A width whose
    shared memory passes the card's ``F64_MAX_SMEM`` a block raises a
    ValueError, and none does: within the old bound (Kf up to 64) every
    kernel fits, and past it no kernel's shared memory grows with a width."""
    F = Kf + n_a2 + SC
    split = split_route(Kf, n_a2, SC)
    f_yt = max(_cdiv(Kf + n_a2, 8), int(split))
    f_tiles = f_yt if split else f_yt + _cdiv(SC, 8)
    f_groups = _cdiv(f_tiles, F64_FWD_TILE_COUNTS[-1])
    f_count = _cdiv(f_tiles, f_groups)
    f_nt = _at_least(F64_FWD_TILE_COUNTS, f_count)
    kc = max(1, _cdiv(Kf, 8))
    klr = 0 if split else Kf  # log_rfe's columns in fwd_f64_kernel
    plan = dict(f_yt=f_yt, f_tiles=f_tiles, f_count=f_count, f_nt=f_nt, f_groups=f_groups,
                f_blocks=_cdiv(N, 16 * F64_FWD_WARPS), f_smem=f64_fwd_smem(klr, f_nt),
                f_table=2 * _cdiv(G, F64_FWD_GENES) * 4 * (32 * f_tiles + 4 * klr))
    if split:
        rows, n_chunks, ldw = _split_rows(N, G, _SPLIT_ELEMENTS // 2, 2)
        slots = _F64_SPLIT_BLOCKS * 132
        products = _cdiv(G, _SPLIT_N) * (_cdiv(Kf, _SPLIT_M) + _cdiv(SC, _SPLIT_M))
        gslices, gcells = _cell_slices(N, rows, n_chunks, products, slots)
        m_tiles = _cdiv(rows, _SPLIT_M)
        dsplit, dgenes = _gene_ranges(m_tiles * _cdiv(max(Kf, 1), _SPLIT_N), G, slots)
        zsplit, zgenes = _gene_ranges(m_tiles * _cdiv(SC, _SPLIT_N), G, slots)
        plan.update(dict.fromkeys(("d_nk", "d_nz", "d_groups", "d_steps", "d_blocks", "d_smem",
                                   "d_table", "g_st", "g_tiles", "g_nk", "g_count", "g_nt",
                                   "g_passes", "g_blocks", "g_smem", "g_table"), 0),
                    rows=rows, n_chunks=n_chunks, split=1, ldw=ldw, gslices=gslices,
                    gcells=gcells, part=2 * _cdiv(gslices * F * G, 2) if gslices > 1 else 0,
                    dsplit=dsplit, dgenes=dgenes, zsplit=zsplit, zgenes=zgenes)
    else:
        d_nk = _at_least(F64_DPSI_K_COUNTS, kc)
        d_groups = _cdiv(_cdiv(SC, 8), F64_DPSI_Z_COUNTS[-1])
        d_nz = _at_least(F64_DPSI_Z_COUNTS, _cdiv(_cdiv(SC, 8), d_groups))
        d_steps = 4 if f64_dpsi_smem(d_nk, d_nz, 4) <= _TWO_BLOCK_SMEM else 2
        d_tiles = d_groups * d_nz + d_nk + (d_nk if d_nk > 1 else 0)
        g_st = _cdiv(n_a2, 8)
        g_tiles = g_st + _cdiv(SC, 8)
        g_nk = _at_least(F64_GENE_K_COUNTS, kc)
        counts = F64_GENE_TILE_COUNTS[g_nk]
        g_passes = _cdiv(g_tiles, counts[-1])
        g_count = _cdiv(g_tiles, g_passes)
        g_nt = _at_least(counts, g_count)
        rows = _chunk_rows(N)
        n_chunks = _cdiv(N, rows)
        plan.update(d_nk=d_nk, d_nz=d_nz, d_groups=d_groups, d_steps=d_steps,
                    d_blocks=_cdiv(N, 16 * F64_DPSI_WARPS),
                    d_smem=f64_dpsi_smem(d_nk, d_nz, d_steps),
                    d_table=2 * _cdiv(G, 8 * d_steps) * d_steps * 32 * d_tiles,
                    g_st=g_st, g_tiles=g_tiles, g_nk=g_nk, g_count=g_count, g_nt=g_nt,
                    g_passes=g_passes, g_blocks=_cdiv(G, 16 * F64_GENE_WARPS), rows=rows,
                    n_chunks=n_chunks, g_smem=f64_gene_smem(Kf, g_nt, g_nk),
                    part=2 * _cdiv(n_chunks * F * G, 2),
                    g_table=2 * _cdiv(N, F64_GENE_CELLS) * (4 * (32 * (2 * g_tiles + g_nk) + 4 * Kf)
                                                            + F64_GENE_CELLS // 2),
                    split=0, ldw=0, gslices=0, gcells=0, dsplit=0, dgenes=0, zsplit=0, zgenes=0)
    plan = {k: plan[k] for k in F64_PLAN_KEYS}
    worst = max(plan["f_smem"], plan["d_smem"], plan["g_smem"])
    if worst > F64_MAX_SMEM:
        raise ValueError(
            f"the float64 CUDA kernels at Kf={Kf}, S={n_a2}, S*C={SC} need {worst} bytes of "
            f"shared memory a block, past the card's {F64_MAX_SMEM} (227 KB): Kf = K + P is "
            "too wide")
    if split:
        block = plan["rows"] * plan["ldw"]
        zpart = 2 * _cdiv(plan["zsplit"] * plan["rows"] * SC, 2) if plan["zsplit"] > 1 else 0
        dpart = plan["dsplit"] * plan["rows"] * Kf
        a1part = plan["rows"] * 2 * _cdiv(G, _SPLIT_N)
        plan["fwd_workspace"] = plan["f_table"] + block + zpart + a1part
        plan["dpsi_workspace"] = block + dpart
        plan["gene_workspace"] = plan["part"] + 2 * block + dpart + F * G
        plan["bwd_workspace"] = plan["gene_workspace"]
    else:
        plan["fwd_workspace"] = plan["f_table"]
        plan["dpsi_workspace"] = plan["d_table"]
        plan["gene_workspace"] = plan["part"] + plan["g_table"] + F * G
        plan["bwd_workspace"] = plan["gene_workspace"] + (plan["dpsi_workspace"] if Kf else 0)
    return plan


def _compute_dtype(psi_ext) -> torch.dtype:
    """The call's compute dtype, psi_ext's: float32 (the float32 kernels) or
    float64 (the float64 family). Every other float operand must match it."""
    if psi_ext.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"psi_ext must be float32 or float64 for the CUDA kernels, got "
                         f"{psi_ext.dtype}")
    return psi_ext.dtype


def gene_scratch(N: int, G: int, Kf: int, n_a2: int, SC: int) -> int:
    """Floats of scratch the narrow gene-major backward takes in a call (the
    .cu's gene_plan, which ``fl_backward_gene_scratch`` reports): the (Kf +
    SC + n_a2, G) partial sums of each chunk of :func:`_chunk_rows` cells,
    B = [dZ | dZ psi_1 | ...]'s n-tiles packed as (hi, lo) fragments for
    every 64-cell tile, in passes of at most 4, 3 or 2 n-tiles (Kf 1, 2,
    more), and the per-cell table (psi, dA1 psi, dA2)."""
    KF = max(Kf, 1)
    tiles = _cdiv((Kf + 1) * SC, 8)
    n_pass = _cdiv(tiles, 4 if KF == 1 else 3 if KF == 2 else 2)
    NT = _cdiv(tiles, n_pass)
    n_pass = _cdiv(tiles, NT)
    n_pad = _cdiv(N, 64) * 64
    part = _cdiv(_cdiv(N, _chunk_rows(N)) * (Kf + SC + n_a2) * G, 4) * 4
    return part + n_pass * (n_pad // 8) * NT * 32 * 4 + n_pad * (2 * KF + (MAX_A2 if n_a2 else 0))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def kernel_forward(Y, psi_ext, W_ext, log_mu, muL):
    """Launch the forward kernel, or the wide one past a narrow limit
    (:func:`wide_route`; past the old bound the split forward, by row blocks:
    :func:`wide_plan`'s ``fwd_workspace``), or for float64 operands ``fwd_f64_pack_kernel``
    and ``fwd_f64_kernel`` (past the old bound with the split forward's Z by
    row blocks; :func:`f64_plan`, its ``fwd_workspace``). Returns (A1, A2 or
    None, Z, YW) in the compute dtype, with ``YW = Y @ W_ext`` (N, Kf) for
    the backward's dpsi kernel."""
    global fwd_launches, fwd_wide_launches, fwd_f64_launches
    from . import _build

    n_a2 = 0 if log_mu is None else log_mu.shape[0]
    dt = _compute_dtype(psi_ext)
    y_codes = Y_DTYPES_F64 if dt == torch.float64 else Y_DTYPES
    _check("Y", Y, Y.shape, tuple(y_codes))
    (N, G), Kf, SC = Y.shape, psi_ext.shape[1], muL.shape[1]
    _check_sizes(N, G, SC)
    _check("psi_ext", psi_ext, (N, Kf), (dt,))
    _check("W_ext", W_ext, (G, Kf), (dt,))
    _check("muL", muL, (G, SC), (dt,))
    if log_mu is not None:
        _check("log_mu", log_mu, (n_a2, G), (dt,))
    lib = _build.load()
    A1 = torch.empty(N, device=Y.device, dtype=dt)
    A2 = None if log_mu is None else torch.empty(N, n_a2, device=Y.device, dtype=dt)
    Z = torch.empty(N, SC, device=Y.device, dtype=dt)
    YW = torch.empty(N, Kf, device=Y.device, dtype=dt)
    stream = ctypes.c_void_p(torch.cuda.current_stream(Y.device).cuda_stream)
    args = (_ptr(Y), _ptr(psi_ext), _ptr(W_ext), _ptr(log_mu), _ptr(muL),
            _ptr(A1), _ptr(A2), _ptr(Z), _ptr(YW))
    sizes = (N, G, Kf, n_a2, SC, y_codes[Y.dtype], stream)
    if dt == torch.float64:
        plan = f64_plan(N, G, Kf, n_a2, SC)
        table = torch.empty(plan["fwd_workspace"], device=Y.device, dtype=dt)
        _raise_on(lib.fl64_forward(*args, _ptr(table), _plan_arg(plan, F64_PLAN_KEYS), *sizes),
                  "fused likelihood forward (float64)")
        fwd_f64_launches += 1
        return A1, A2, Z, YW
    wide = wide_route(Kf, n_a2, SC)
    if wide:
        plan = wide_plan(N, G, Kf, n_a2, SC)
        table = torch.empty(plan["fwd_workspace"], device=Y.device, dtype=torch.float32)
        err = lib.fl_forward_wide(*args, _ptr(table), _plan_arg(plan), *sizes)
    else:
        err = lib.fl_forward(*args, *sizes)
    _raise_on(err, f"fused likelihood forward{' (wide)' if wide else ''}")
    if wide:
        fwd_wide_launches += 1
    else:
        fwd_launches += 1
    return A1, A2, Z, YW


def kernel_dpsi(psi_ext, W_ext, muL, dA1, dZ, YW):
    """Launch the Y-free dpsi kernel (the first part of
    :func:`kernel_backward`), or past a narrow limit the wide one with its
    packing of the gene side (past the old bound the split one's
    dlog_rfe_kernel without Y, dpsi_product_kernel and dpsi_sum_kernel by row
    blocks; :func:`wide_plan`'s ``dpsi_workspace``), or
    for float64 operands ``dpsi_f64_pack_kernel`` and ``dpsi_f64_kernel``
    (past the old bound ``dlog_rfe_f64_kernel`` without Y,
    ``dpsi_product_f64_kernel`` and ``dpsi_sum_f64_kernel`` by row blocks;
    :func:`f64_plan`'s ``dpsi_workspace``); ``YW`` is
    :func:`kernel_forward`'s. Returns dpsi (N, Kf). With Kf = 0 there is
    nothing to compute or launch."""
    global dpsi_launches, dpsi_wide_launches, dpsi_f64_launches
    from . import _build

    (N, Kf), G, SC = psi_ext.shape, W_ext.shape[0], muL.shape[1]
    dt = _compute_dtype(psi_ext)
    _check_sizes(N, G, SC)
    _check("psi_ext", psi_ext, (N, Kf), (dt,))
    _check("W_ext", W_ext, (G, Kf), (dt,))
    _check("muL", muL, (G, SC), (dt,))
    _check("dA1", dA1, (N,), (dt,))
    _check("dZ", dZ, (N, SC), (dt,))
    _check("YW", YW, (N, Kf), (dt,))
    dpsi = torch.empty(N, Kf, device=psi_ext.device, dtype=dt)
    if Kf == 0:
        return dpsi
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(psi_ext.device).cuda_stream)
    args = (_ptr(psi_ext), _ptr(W_ext), _ptr(muL), _ptr(dA1), _ptr(dZ), _ptr(YW), _ptr(dpsi))
    if dt == torch.float64:
        plan = f64_plan(N, G, Kf, 0, SC)
        table = torch.empty(plan["dpsi_workspace"], device=psi_ext.device, dtype=dt)
        _raise_on(lib.fl64_backward_dpsi(*args, _ptr(table), _plan_arg(plan, F64_PLAN_KEYS), N, G,
                                         Kf, SC, stream),
                  "fused likelihood backward (dpsi, float64)")
        dpsi_f64_launches += 1
        return dpsi
    wide = wide_route(Kf, 0, SC)
    if wide:
        plan = wide_plan(N, G, Kf, 0, SC)
        table = torch.empty(plan["dpsi_workspace"], device=psi_ext.device, dtype=torch.float32)
        err = lib.fl_backward_dpsi_wide(*args, _ptr(table), _plan_arg(plan), N, G, Kf, SC, stream)
    else:
        err = lib.fl_backward_dpsi(*args, N, G, Kf, SC, stream)
    _raise_on(err, f"fused likelihood backward (dpsi{', wide' if wide else ''})")
    if wide:
        dpsi_wide_launches += 1
    else:
        dpsi_launches += 1
    return dpsi


def kernel_gene(Y, psi_ext, W_ext, muL, dA1, dA2, dZ):
    """Launch the gene-major backward kernel with its packing of the cell
    operands and its chunk reduction (the second part of
    :func:`kernel_backward`; :func:`reference_gene` is its plain version),
    or past a narrow limit the wide gene kernel with its chunk reduction
    (past the old bound the split one's dlog_rfe_kernel and
    gene_product_kernel by row blocks, :func:`kernel_backward`'s call
    without dpsi; the plain version of both is
    :func:`reference_likelihood_vjp`'s), or for
    float64 operands ``gene_f64_pack_kernel``, ``gene_f64_kernel`` and
    ``reduce_chunks_f64_kernel``, past the old bound ``dlog_rfe_f64_kernel``
    and ``gene_product_f64_kernel`` by row blocks (the same plain version;
    :func:`f64_plan`'s ``gene_workspace``).
    Returns (dW, dlog_mu or None, dmuL)."""
    global gene_launches, gene_wide_launches, gene_f64_launches
    from . import _build

    n_a2 = 0 if dA2 is None else dA2.shape[1]
    dt = _compute_dtype(psi_ext)
    y_codes = Y_DTYPES_F64 if dt == torch.float64 else Y_DTYPES
    _check("Y", Y, Y.shape, tuple(y_codes))
    (N, G), Kf, SC = Y.shape, psi_ext.shape[1], muL.shape[1]
    _check_sizes(N, G, SC)
    _check("psi_ext", psi_ext, (N, Kf), (dt,))
    _check("W_ext", W_ext, (G, Kf), (dt,))
    _check("muL", muL, (G, SC), (dt,))
    _check("dA1", dA1, (N,), (dt,))
    _check("dZ", dZ, (N, SC), (dt,))
    if dA2 is not None:
        _check("dA2", dA2, (N, n_a2), (dt,))
    lib = _build.load()
    F = Kf + SC + n_a2
    if dt == torch.float64:
        plan = f64_plan(N, G, Kf, n_a2, SC)
        scratch = torch.empty(plan["gene_workspace"] - F * G, device=Y.device, dtype=dt)
        dgene = torch.empty(F, G, device=Y.device, dtype=dt)
        stream = ctypes.c_void_p(torch.cuda.current_stream(Y.device).cuda_stream)
        _raise_on(lib.fl64_backward_gene(
            _ptr(Y), _ptr(psi_ext), _ptr(W_ext), _ptr(muL), _ptr(dA1), _ptr(dA2), _ptr(dZ), None,
            _ptr(scratch), _ptr(dgene), _plan_arg(plan, F64_PLAN_KEYS), N, G, Kf, n_a2, SC,
            y_codes[Y.dtype], stream), "fused likelihood backward (gene, float64)")
        gene_f64_launches += 1
        return dgene[:Kf].T, None if dA2 is None else dgene[Kf + SC:], dgene[Kf:Kf + SC].T
    wide = wide_route(Kf, n_a2, SC)
    plan = wide_plan(N, G, Kf, n_a2, SC) if wide else None
    size = (plan["gene_workspace"] - F * G if wide
            else lib.fl_backward_gene_scratch(N, G, Kf, n_a2, SC, _chunk_rows(N)))
    scratch = torch.empty(size, device=Y.device, dtype=torch.float32)
    dgene = torch.empty(F, G, device=Y.device, dtype=torch.float32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(Y.device).cuda_stream)
    args = (_ptr(Y), _ptr(psi_ext), _ptr(W_ext), _ptr(muL), _ptr(dA1), _ptr(dA2), _ptr(dZ))
    if wide:
        err = lib.fl_backward_gene_wide(*args, None, _ptr(scratch), _ptr(dgene), _plan_arg(plan),
                                        N, G, Kf, n_a2, SC, Y_DTYPES[Y.dtype], stream)
    else:
        err = lib.fl_backward_gene(*args, _ptr(scratch), _ptr(dgene), N, G, Kf, n_a2, SC,
                                   _chunk_rows(N), Y_DTYPES[Y.dtype], stream)
    _raise_on(err, f"fused likelihood backward (gene{', wide' if wide else ''})")
    if wide:
        gene_wide_launches += 1
    else:
        gene_launches += 1
    dW = dgene[:Kf].T
    dmuL = dgene[Kf:Kf + SC].T
    dlog_mu = None if dA2 is None else dgene[Kf + SC:]
    return dW, dlog_mu, dmuL


def kernel_backward(Y, psi_ext, W_ext, muL, dA1, dA2, dZ, YW):
    """Launch the backward kernels, dpsi from the forward's ``YW = Y @ W_ext``
    and then the gene-major part; or, where the plan's backward is the split
    one (:func:`split_route`), both from one dlog_rfe a row block
    (``fl_backward_gene_wide`` with dpsi, or for float64 operands
    ``fl64_backward_gene`` with dpsi: dpsi = dlog_rfe W_ext, YW unused; the
    plan's ``bwd_workspace``), counted in ``split_launches`` (float64:
    ``split_f64_launches``). Returns (dpsi, dW, dlog_mu or None, dmuL)."""
    global split_launches, split_f64_launches
    from . import _build

    n_a2 = 0 if dA2 is None else dA2.shape[1]
    (N, G), Kf, SC = Y.shape, psi_ext.shape[1], muL.shape[1]
    dt = _compute_dtype(psi_ext)
    if not split_route(Kf, n_a2, SC):
        dpsi = kernel_dpsi(psi_ext, W_ext, muL, dA1, dZ, YW)
        return (dpsi, *kernel_gene(Y, psi_ext, W_ext, muL, dA1, dA2, dZ))
    f64 = dt == torch.float64
    _check("Y", Y, Y.shape, tuple(Y_DTYPES_F64 if f64 else Y_DTYPES))
    _check_sizes(N, G, SC)
    for name, t, shape in (("psi_ext", psi_ext, (N, Kf)), ("W_ext", W_ext, (G, Kf)),
                           ("muL", muL, (G, SC)), ("dA1", dA1, (N,)), ("dZ", dZ, (N, SC)),
                           ("YW", YW, (N, Kf)), ("dA2", dA2, (N, n_a2))):
        if t is not None:
            _check(name, t, shape, (dt,))
    lib = _build.load()
    plan = f64_plan(N, G, Kf, n_a2, SC) if f64 else wide_plan(N, G, Kf, n_a2, SC)
    F = Kf + SC + n_a2
    dpsi = torch.empty(N, Kf, device=Y.device, dtype=dt)
    scratch = torch.empty(plan["bwd_workspace"] - F * G, device=Y.device, dtype=dt)
    dgene = torch.empty(F, G, device=Y.device, dtype=dt)
    stream = ctypes.c_void_p(torch.cuda.current_stream(Y.device).cuda_stream)
    args = (_ptr(Y), _ptr(psi_ext), _ptr(W_ext), _ptr(muL), _ptr(dA1), _ptr(dA2), _ptr(dZ),
            _ptr(dpsi), _ptr(scratch), _ptr(dgene))
    if f64:
        _raise_on(lib.fl64_backward_gene(*args, _plan_arg(plan, F64_PLAN_KEYS), N, G, Kf, n_a2, SC,
                                         Y_DTYPES_F64[Y.dtype], stream),
                  "fused likelihood backward (split, float64)")
        split_f64_launches += 1
    else:
        _raise_on(lib.fl_backward_gene_wide(*args, _plan_arg(plan), N, G, Kf, n_a2, SC,
                                            Y_DTYPES[Y.dtype], stream),
                  "fused likelihood backward (split)")
        split_launches += 1
    return dpsi, dgene[:Kf].T, None if dA2 is None else dgene[Kf + SC:], dgene[Kf:Kf + SC].T


# ---------------------------------------------------------------------------
# Autograd function
# ---------------------------------------------------------------------------

def _on(device: torch.device, cpu_fn, cuda_fn, *args):
    if device.type == "cuda":
        return cuda_fn(*args)
    if device.type == "cpu":
        return cpu_fn(*args)
    raise ValueError(f"no fused-likelihood implementation for device {device}")


class _FusedLikelihood(torch.autograd.Function):
    @staticmethod
    def forward(ctx, Y, psi_ext, W_ext, log_mu, muL):
        A1, A2, Z, YW = _on(Y.device, _plain_forward, kernel_forward,
                            Y, psi_ext, W_ext, log_mu, muL)
        ctx.save_for_backward(Y, psi_ext, W_ext, muL, YW)
        ctx.with_a2 = log_mu is not None
        return A1, A2, Z

    @staticmethod
    def backward(ctx, dA1, dA2, dZ):
        # Unused tensor outputs arrive as zeros (autograd materializes them);
        # only the skipped A2 arrives as None.
        Y, psi_ext, W_ext, muL, YW = ctx.saved_tensors
        dA2 = dA2.contiguous() if ctx.with_a2 else None
        dpsi, dW, dlog_mu, dmuL = _on(
            Y.device, _plain_backward, kernel_backward,
            Y, psi_ext, W_ext, muL, dA1.contiguous(), dA2, dZ.contiguous(), YW,
        )
        return None, dpsi, dW, dlog_mu, dmuL


def fused_likelihood_terms(Y, psi_ext, W_ext, log_mu, muL):
    """Compute (A1, A2, Z) — see the module docstring — differentiably in
    psi_ext, W_ext, log_mu and muL (Y is data and gets no gradient).

    Args:
      Y:       (N, G) counts, in the compute dtype or a narrow storage type
               (``Y_DTYPES`` on CUDA).
      psi_ext: (N, Kf) cell factors.
      W_ext:   (G, Kf) gene loadings.
      log_mu:  (S, G) log of the sampled mu, or None to skip A2.
      muL:     (G, S*C) mu[s,g] * L[g,c], column s*C+c.

    Returns:
      A1 (N,), A2 (N, S) or None, Z (N, S*C).
    """
    return _FusedLikelihood.apply(Y, psi_ext, W_ext, log_mu, muL)

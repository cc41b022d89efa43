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
runtime widths up to ``WIDE_MAX_KF``, ``WIDE_MAX_A2`` and ``WIDE_MAX_SC`` (the
counterparts of the Pallas kernels' ``jnp.dot`` branches), counted apart in
``*_wide_launches``: the forward (Z, and Y's products), the Y-free dpsi
kernel and the gene part, all on tensor cores (the contract as unnormalized
attention).
:func:`wide_plan` gives their launch geometry and workspace, which the C
launchers take and check. The plain versions take any width and
are the wide family's too.

Float64 operands (``dtype="float64"`` fits, the oracle configuration) go
to a family of their own, ``csrc/fused_likelihood_f64.cu``: the forward
(``fwd_f64_pack_kernel`` + ``fwd_f64_kernel``), the Y-free dpsi kernel
(``dpsi_f64_kernel``) and the gene part (``gene_f64_pack_kernel`` +
``gene_f64_kernel`` + ``reduce_chunks_f64_kernel``), float64 throughout:
the forward's and the gene part's products on the FP64 tensor cores, the
exps and dpsi on the CUDA cores; one family for every width up to the
wide bound (no narrow/wide split), counted apart in ``*_f64_launches``.
:func:`f64_plan` gives their launch geometry and workspace, which the C
entry points take and check. Nothing on that path runs in float32.

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
# ... and the wide family (fwd_wide_kernel, dpsi_wide_kernel,
# gene_wide_kernel), which takes the widths past any narrow limit
WIDE_MAX_KF = 64
WIDE_MAX_A2 = 64
WIDE_MAX_SC = 2048
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
_ROWS_PER_CHUNK = 1024  # cells per partial sum of the gene-major backward
# Y storage types the kernels load, with the code the C entry points take
Y_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2, torch.int8: 3}
# ... and those the float64 family loads. ``y_storage="float32"`` (or None)
# means the compute dtype (api._Y_STORAGE), so a float64 fit stores Y as
# float64 there; code 0 is that compute dtype.
Y_DTYPES_F64 = {torch.float64: 0, torch.bfloat16: 1, torch.int16: 2, torch.int8: 3}
# The float64 family's geometry. dpsi_f64_kernel (the .cu's kCells,
# kGenes, kDpsiCols): cells (lanes) a block, genes a stage, the most dZ
# columns a group. fwd_f64_kernel and gene_f64_kernel (kFwdWarps,
# kFwdGenes, kGeneWarps, kGeneCells): warps of 16 cell (gene) rows a block,
# genes (cells) a stage; their columns count in tiles of 8, and the tile
# counts they are built for (kFwdTileCounts; kGeneKCounts, dW's tiles a
# pass, and beside each the counts of kGeneTileCounts); the bytes of Y a
# stage takes at the widest storage (float64); the most dynamic shared
# memory a block may take on the card.
F64_CELLS = 128
F64_GENES = 32
F64_DPSI_COLS = 64
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

# Kernel launches, each counted by the wrapper that launches the kernel:
# the narrow kernels' and the wide family's apart.
fwd_launches = 0
dpsi_launches = 0
gene_launches = 0  # the gene-major backward kernel with its packing and chunk reduction
fwd_wide_launches = 0
dpsi_wide_launches = 0
gene_wide_launches = 0  # the wide gene-part kernel with its chunk reduction
fwd_f64_launches = 0
dpsi_f64_launches = 0
gene_f64_launches = 0  # the float64 gene-part kernel with its chunk reduction


def reset_launch_counts() -> None:
    global fwd_launches, dpsi_launches, gene_launches
    global fwd_wide_launches, dpsi_wide_launches, gene_wide_launches
    global fwd_f64_launches, dpsi_f64_launches, gene_f64_launches
    fwd_launches = 0
    dpsi_launches = 0
    gene_launches = 0
    fwd_wide_launches = 0
    dpsi_wide_launches = 0
    gene_wide_launches = 0
    fwd_f64_launches = 0
    dpsi_f64_launches = 0
    gene_f64_launches = 0


def wide_route(Kf: int, n_a2: int, SC: int) -> bool:
    """Whether a call with Kf columns of ``[psi, X]``, n_a2 A2 columns (0
    without A2; the dpsi kernel has none) and SC sample x clone columns goes
    to the wide family: exactly when a width is past a narrow limit."""
    return Kf > MAX_KF or n_a2 > MAX_A2 or SC > MAX_SC


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


def _check_sizes(N, G, Kf, SC, n_a2):
    if N < 1 or G < 1:
        raise ValueError(f"the CUDA kernels need N, G >= 1, got N={N}, G={G}")
    if Kf > WIDE_MAX_KF or n_a2 > WIDE_MAX_A2 or not 1 <= SC <= WIDE_MAX_SC:
        raise ValueError(
            f"the CUDA kernels (the wide family past {MAX_KF}, {MAX_A2} and {MAX_SC}) "
            f"take at most {WIDE_MAX_KF} latent columns, {WIDE_MAX_A2} samples and "
            f"{WIDE_MAX_SC} sample x clone columns; got Kf={Kf}, S={n_a2}, S*C={SC}"
        )


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
                  "dk_pad", "dz_group", "n_dgroups", "dsteps", "dtable")


def wide_plan(N: int, G: int, Kf: int, n_a2: int, SC: int, rows: Optional[int] = None) -> dict:
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
    exps), each padded to ``zt_group``; the Y products' tiles, padded to
    ``ny_pad``, in ``fwd_wide_y_kernel``'s one read of Y. Gene part: chunks
    of ``rows`` cells (:func:`_chunk_rows`), each a block row of partial
    sums; ``mu_passes`` passes over dZ's tiles, ``nj`` tiles each beside
    dW's ``n_kc`` (and dlog mu's ``n_st`` in the first pass, unless they
    leave no room: then Y's products take a first pass of their own,
    ``y_pass``, where dlog mu takes d(muL)'s first ``n_st`` tiles, so ``nj``
    is at least ``n_st``), ``n_passes`` in all. dpsi: ``[psi, X]``'s tiles
    padded to ``dk_pad`` (``WIDE_DPSI_K_COUNTS``), dZ's tiles split evenly
    into ``n_dgroups`` column groups of at most 10 (one after another in a
    block, each recomputing the exps), each padded to ``dz_group``
    (``WIDE_DPSI_Z_COUNTS``); ``dsteps`` k-steps of 8 genes a stage, 4
    unless that leaves room for one block an SM (``dpsi_smem`` bytes of
    shared memory a block).

    Workspace, in float32 values: ``table``, the forward's packed gene-side
    B fragments; ``part`` (the partial sums), ``dz``, ``ps``, ``a2`` and
    ``a1`` (the packed cell side), the gene part's scratch; ``dtable``,
    dpsi's packed gene side. ``fwd_workspace``, ``dpsi_workspace`` and
    ``gene_workspace`` are what :func:`kernel_forward`, :func:`kernel_dpsi`
    and :func:`kernel_gene` allocate for the kernels, the last with its (Kf
    + SC + n_a2, G) output."""
    n_kc, n_zt, n_yt, n_st = _cdiv(Kf, 8), _cdiv(SC, 8), _cdiv(Kf + n_a2, 8), _cdiv(n_a2, 8)
    g_pad = _cdiv(G, _FWD_WIDE_GENES) * _FWD_WIDE_GENES
    n_zgroups = _cdiv(n_zt, WIDE_TILES)
    zt_group = _at_least(WIDE_TILE_COUNTS, _cdiv(n_zt, n_zgroups))
    ny_pad = _at_least(WIDE_Y_TILE_COUNTS, max(n_yt, 1))
    rows = _chunk_rows(N) if rows is None else rows
    n_chunks = _cdiv(N, rows)
    n_pad = _cdiv(N, _GENE_WIDE_CELLS) * _GENE_WIDE_CELLS
    y_pass = int(n_kc + n_st >= WIDE_TILES)
    room = WIDE_TILES - n_kc - (0 if y_pass else n_st)
    nj = _at_least(WIDE_TILE_COUNTS, max(_cdiv(n_zt, _cdiv(n_zt, room)), n_st if y_pass else 1))
    if nj > room:
        nj = max(c for c in WIDE_TILE_COUNTS if c <= room)
    mu_passes = _cdiv(n_zt, nj)
    table = g_pad // 8 * (n_kc + n_zgroups * zt_group + ny_pad) * 32 * 4
    F = Kf + SC + n_a2
    part = _cdiv(n_chunks * F * G, 4) * 4
    dz, ps, a2, a1 = n_pad * 16 * mu_passes * nj, n_pad * 16 * n_kc, n_pad * 16 * n_st, n_pad
    dk_pad = _at_least(WIDE_DPSI_K_COUNTS, max(n_kc, 1))
    n_dgroups = _cdiv(n_zt, WIDE_DPSI_Z_COUNTS[-1])
    dz_group = _at_least(WIDE_DPSI_Z_COUNTS, _cdiv(n_zt, n_dgroups))

    def dpsi_smem(steps):  # the warps' psi fragments and float64 sums, two stage buffers
        return 16 * 32 * (_DPSI_WIDE_WARPS * dk_pad * 3 + 2 * steps * (2 * dk_pad + dz_group))

    dsteps = 4 if dpsi_smem(4) <= _TWO_BLOCK_SMEM else 2
    dtable = g_pad // 8 * (2 * dk_pad + n_dgroups * dz_group) * 32 * 4
    plan = dict(zip(WIDE_PLAN_KEYS, (
        n_kc, n_zt, n_yt, n_st, g_pad, zt_group, n_zgroups, ny_pad, rows, n_chunks, n_pad, nj,
        mu_passes, y_pass, mu_passes + y_pass, table, part, dz, ps, a2, a1,
        dk_pad, dz_group, n_dgroups, dsteps, dtable)))
    plan["dpsi_smem"] = dpsi_smem(dsteps)
    plan["fwd_workspace"] = table
    plan["dpsi_workspace"] = dtable
    plan["gene_workspace"] = part + dz + ps + a2 + a1 + F * G
    return plan


def _plan_arg(plan: dict, keys=WIDE_PLAN_KEYS):
    """:func:`wide_plan`'s numbers (or with ``keys=F64_PLAN_KEYS``
    :func:`f64_plan`'s) as the C entry points take them."""
    return (ctypes.c_longlong * len(keys))(*(plan[k] for k in keys))


# f64_plan's numbers, in the order the C entry points take them.
F64_PLAN_KEYS = ("f_yt", "f_tiles", "f_count", "f_nt", "f_groups", "f_blocks", "f_smem",
                 "d_cols", "d_groups", "d_blocks", "d_smem",
                 "g_st", "g_tiles", "g_nk", "g_count", "g_nt", "g_passes", "g_blocks", "rows",
                 "n_chunks", "g_smem", "part", "f_table", "g_table")


def f64_fwd_smem(Kf: int, nt: int) -> int:
    """fwd_f64_kernel's dynamic shared memory in bytes: its warps' psi rows,
    and two stages, each the B fragments of nt tiles and W for 32 genes and
    the warps' Y rows (float64's room)."""
    return (8 * (F64_FWD_WARPS * 16 * Kf + 2 * (F64_FWD_GENES * (8 * nt + Kf)))
            + 2 * F64_FWD_Y_STAGE_BYTES)


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

    Columns count in tiles of 8 (the FP64 MMA's n). Forward: ``f_yt`` tiles
    of the Y products ``[Y W | Y log mu^T]`` then Z's, ``f_tiles`` in all,
    split evenly into ``f_groups`` column groups (grid.y) of ``f_count``
    tiles, each group's accumulators the built count ``f_nt``
    (``F64_FWD_TILE_COUNTS``, at most 12) and each group recomputing the
    exps it needs; ``f_blocks`` blocks of ``F64_FWD_WARPS`` x 16 cells. dpsi:
    dZ's SC columns in ``d_groups`` groups of ``d_cols`` <= ``F64_DPSI_COLS``,
    one after another in a block. Gene part: ``g_st`` tiles of dlog mu then
    d(muL)'s, ``g_tiles`` in all, split evenly into ``g_passes`` passes of
    ``g_count`` tiles (the built count ``g_nt``), beside dW's ``g_nk`` tiles
    (``F64_GENE_K_COUNTS``; ``F64_GENE_TILE_COUNTS[g_nk]`` the pass's counts,
    so that the registers hold them); ``g_blocks`` blocks of
    ``F64_GENE_WARPS`` x 16 genes by ``n_chunks`` chunks (grid.y) of ``rows``
    cells (:func:`_chunk_rows`). ``f_smem``, ``d_smem`` and ``g_smem`` are
    each kernel's dynamic shared memory in bytes (:func:`f64_fwd_smem`,
    :func:`f64_gene_smem`).

    Workspace, in float64 values (dpsi takes none): ``f_table``, the
    forward's gene side packed once a call in the order its stages take it
    (``fwd_f64_pack_kernel``: each stage's B fragments of every tile and W
    for log_rfe), which is ``fwd_workspace``; ``part``, the gene part's
    partial sums (n_chunks x (Kf + SC + n_a2) x G, rounded up to even so
    that the table after them is 16-byte aligned), and ``g_table``, its
    cell side packed likewise (``gene_f64_pack_kernel``: each 32-cell
    stage's B fragments of drfe, of every tile and of dW, psi for log_rfe
    and dA1); ``gene_workspace``, what :func:`kernel_gene` allocates: the
    partial sums, the table and its (Kf + SC + n_a2, G) output."""
    F = Kf + n_a2 + SC
    f_yt = _cdiv(Kf + n_a2, 8)
    f_tiles = f_yt + _cdiv(SC, 8)
    f_groups = _cdiv(f_tiles, F64_FWD_TILE_COUNTS[-1])
    f_count = _cdiv(f_tiles, f_groups)
    f_nt = _at_least(F64_FWD_TILE_COUNTS, f_count)
    d_groups = _cdiv(SC, F64_DPSI_COLS)
    d_cols = _cdiv(SC, d_groups)
    g_st = _cdiv(n_a2, 8)
    g_tiles = g_st + _cdiv(SC, 8)
    g_nk = _at_least(F64_GENE_K_COUNTS, max(1, _cdiv(Kf, 8)))
    counts = F64_GENE_TILE_COUNTS[g_nk]
    g_passes = _cdiv(g_tiles, counts[-1])
    g_count = _cdiv(g_tiles, g_passes)
    g_nt = _at_least(counts, g_count)
    rows = _chunk_rows(N)
    n_chunks = _cdiv(N, rows)
    plan = dict(zip(F64_PLAN_KEYS, (
        f_yt, f_tiles, f_count, f_nt, f_groups, _cdiv(N, 16 * F64_FWD_WARPS),
        f64_fwd_smem(Kf, f_nt),
        d_cols, d_groups, _cdiv(N, F64_CELLS),
        8 * ((2 * Kf + d_cols) * F64_CELLS + (Kf + d_cols) * F64_GENES),
        g_st, g_tiles, g_nk, g_count, g_nt, g_passes, _cdiv(G, 16 * F64_GENE_WARPS), rows,
        n_chunks, f64_gene_smem(Kf, g_nt, g_nk), 2 * _cdiv(n_chunks * F * G, 2),
        2 * _cdiv(G, F64_FWD_GENES) * 4 * (32 * f_tiles + 4 * Kf),
        2 * _cdiv(N, F64_GENE_CELLS) * (4 * (32 * (2 * g_tiles + g_nk) + 4 * Kf)
                                        + F64_GENE_CELLS // 2))))
    plan["fwd_workspace"] = plan["f_table"]
    plan["gene_workspace"] = plan["part"] + plan["g_table"] + F * G
    return plan


def _compute_dtype(psi_ext) -> torch.dtype:
    """The call's compute dtype, psi_ext's: float32 (the float32 kernels) or
    float64 (the float64 family). Every other float operand must match it."""
    if psi_ext.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"psi_ext must be float32 or float64 for the CUDA kernels, got "
                         f"{psi_ext.dtype}")
    return psi_ext.dtype


def gene_wide_workspace(N: int, G: int, Kf: int, n_a2: int, SC: int) -> int:
    """Floats the wide gene part allocates in a call (:func:`wide_plan`'s
    ``gene_workspace``): the (Kf + SC + n_a2, G) partial sums of each chunk
    of :func:`_chunk_rows` cells, the packed cell side, and their sum."""
    return wide_plan(N, G, Kf, n_a2, SC)["gene_workspace"]


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
    (:func:`wide_route`), or for float64 operands ``fwd_f64_pack_kernel``
    and ``fwd_f64_kernel`` (:func:`f64_plan`, its ``fwd_workspace``). Returns (A1, A2 or None, Z, YW) in the compute
    dtype, with ``YW = Y @ W_ext`` (N, Kf) for the backward's dpsi kernel."""
    global fwd_launches, fwd_wide_launches, fwd_f64_launches
    from . import _build

    n_a2 = 0 if log_mu is None else log_mu.shape[0]
    dt = _compute_dtype(psi_ext)
    y_codes = Y_DTYPES_F64 if dt == torch.float64 else Y_DTYPES
    _check("Y", Y, Y.shape, tuple(y_codes))
    (N, G), Kf, SC = Y.shape, psi_ext.shape[1], muL.shape[1]
    _check_sizes(N, G, Kf, SC, n_a2)
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
    packing of the gene side (:func:`wide_plan`'s ``dpsi_workspace``), or
    for float64 operands ``dpsi_f64_kernel``; ``YW`` is
    :func:`kernel_forward`'s. Returns dpsi (N, Kf). With Kf = 0 there is
    nothing to compute or launch."""
    global dpsi_launches, dpsi_wide_launches, dpsi_f64_launches
    from . import _build

    (N, Kf), G, SC = psi_ext.shape, W_ext.shape[0], muL.shape[1]
    dt = _compute_dtype(psi_ext)
    _check_sizes(N, G, Kf, SC, 0)
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
        plan = _plan_arg(f64_plan(N, G, Kf, 0, SC), F64_PLAN_KEYS)
        _raise_on(lib.fl64_backward_dpsi(*args, plan, N, G, Kf, SC, stream),
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
    (whose plain version is :func:`reference_likelihood_vjp`'s), or for
    float64 operands ``gene_f64_pack_kernel``, ``gene_f64_kernel`` and
    ``reduce_chunks_f64_kernel`` (the same plain version; :func:`f64_plan`'s
    ``gene_workspace``).
    Returns (dW, dlog_mu or None, dmuL)."""
    global gene_launches, gene_wide_launches, gene_f64_launches
    from . import _build

    n_a2 = 0 if dA2 is None else dA2.shape[1]
    dt = _compute_dtype(psi_ext)
    y_codes = Y_DTYPES_F64 if dt == torch.float64 else Y_DTYPES
    _check("Y", Y, Y.shape, tuple(y_codes))
    (N, G), Kf, SC = Y.shape, psi_ext.shape[1], muL.shape[1]
    _check_sizes(N, G, Kf, SC, n_a2)
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
        scratch = torch.empty(plan["part"] + plan["g_table"], device=Y.device, dtype=dt)
        dgene = torch.empty(F, G, device=Y.device, dtype=dt)
        stream = ctypes.c_void_p(torch.cuda.current_stream(Y.device).cuda_stream)
        _raise_on(lib.fl64_backward_gene(
            _ptr(Y), _ptr(psi_ext), _ptr(W_ext), _ptr(muL), _ptr(dA1), _ptr(dA2), _ptr(dZ),
            _ptr(scratch), _ptr(dgene), _plan_arg(plan, F64_PLAN_KEYS), N, G, Kf, n_a2, SC,
            y_codes[Y.dtype], stream), "fused likelihood backward (gene, float64)")
        gene_f64_launches += 1
        return dgene[:Kf].T, None if dA2 is None else dgene[Kf + SC:], dgene[Kf:Kf + SC].T
    rows = _chunk_rows(N)
    wide = wide_route(Kf, n_a2, SC)
    plan = wide_plan(N, G, Kf, n_a2, SC, rows=rows) if wide else None
    size = (plan["gene_workspace"] - F * G if wide
            else lib.fl_backward_gene_scratch(N, G, Kf, n_a2, SC, rows))
    scratch = torch.empty(size, device=Y.device, dtype=torch.float32)
    dgene = torch.empty(F, G, device=Y.device, dtype=torch.float32)
    stream = ctypes.c_void_p(torch.cuda.current_stream(Y.device).cuda_stream)
    args = (_ptr(Y), _ptr(psi_ext), _ptr(W_ext), _ptr(muL), _ptr(dA1), _ptr(dA2),
            _ptr(dZ), _ptr(scratch), _ptr(dgene))
    if wide:
        err = lib.fl_backward_gene_wide(*args, _plan_arg(plan), N, G, Kf, n_a2, SC,
                                        Y_DTYPES[Y.dtype], stream)
    else:
        err = lib.fl_backward_gene(*args, N, G, Kf, n_a2, SC, rows, Y_DTYPES[Y.dtype], stream)
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
    and then the gene-major part. Returns (dpsi, dW, dlog_mu or None, dmuL)."""
    dpsi = kernel_dpsi(psi_ext, W_ext, muL, dA1, dZ, YW)
    return (dpsi, *kernel_gene(Y, psi_ext, W_ext, muL, dA1, dA2, dZ))


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

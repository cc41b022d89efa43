"""The clonealign probabilistic model as functions on tensors (counterpart of
``clonealign_tpu/models/multinomial.py``).

The multinomial log-likelihood of cell n under clone c and mu sample s is
decomposed so that no (S, C, N, G) tensor exists:

    log p(y_n | c) = log_binom[n] + A2[n,s] + A1[n] + YlogL[n,c] - t_n log Z[s,c,n]

with ``A1[n] = sum_g y_ng (psi W^T)[n,g]``, ``A2[n,s] = sum_g y_ng log mu[s,g]``
and ``Z[s,c,n] = sum_g mu[s,g] L[g,c] exp(psi W^T)[n,g]``. A1, A2 and Z are
the contract of the fused-likelihood op (``ops/fused_likelihood.py``): on
CUDA tensors its hand-written kernels, on CPU tensors its plain versions.
With ``likelihood_impl="z_cheb"`` (K = 1) log Z comes from a Chebyshev
expansion in psi instead (:func:`_compute_logZ_cheb`) and A1, A2 from thin
products with Y; the fused op is not called.

Parameters may carry a leading lane axis R (one lane per restart): every
function here then returns one value per lane, and the fused op runs once
per lane (:func:`_likelihood_terms`).

Y is kept on the device in its storage type (``ModelData.Y``: the compute
dtype, or int8, int16 or bfloat16, ``api.py``'s ``y_storage``). The fused
op's kernels load it as it is; every other pass over Y here (the data
statistics, the PCA and mu initialization, z_cheb's A terms) converts it in
row blocks of ``_CHUNK_ELEMENTS``, so no second full-precision N x G tensor
is made above that size.

Covariates fold in by concatenation, as in the reference: with X (N, P)
and beta (G, P), ``log_rfe = [psi, X] [W, beta]^T``, so the fused op takes
``psi_ext = [psi, X]`` and ``W_ext = [W, beta]`` (Kf = K + P columns) and
its A1 carries ``sum_g y_ng (X beta^T)[n,g]``.

A scipy sparse count matrix is densified on the device, one block of rows
at a time (:func:`prepare_data_sparse`): the kernels read Y dense.

On a mesh (``ModelData.cells`` and ``ModelData.genes``) the data holds one
rank's tile: its cell block's rows, and of them its gene block's columns.
Every sum over cells reduces over the cells group and every sum over genes
over the genes group (``parallel/collectives.py``): the statistics' row
sums once at setup, the fused op's A1, A2 and Z once an evaluation, z_cheb's
products with Y and its node table, the global ELBO terms' per-gene sums.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.fused_likelihood import fused_likelihood_terms
from ..parallel.collectives import (CELL_AXIS, GENE_AXIS, Cells, Genes, all_max, all_min,
                                    all_sum, gather_cols, gather_rows, grad_sum_over_genes,
                                    sum_over_genes, world_max)
from ..utils.device import full_fp32_matmul
from ..utils.sparsity import is_scipy_sparse

LOG_2PI = math.log(2.0 * math.pi)


# ---------------------------------------------------------------------------
# Numerics helpers (reference R/inference-tflow.R:2-15)
# ---------------------------------------------------------------------------

def softplus(x):
    """log(1 + exp(x)), exact for every x (``torch.nn.functional.softplus``
    switches to the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def safe_inverse_softplus(x):
    """log(exp(x)-1) computed stably for positive x
    (reference R/inference-tflow.R:6-11)."""
    return torch.log(-torch.expm1(-torch.abs(x))) + torch.clamp_min(x, 0.0)


def _normal_log_prob(x, loc=0.0, scale=1.0):
    z = (x - loc) / scale
    log_scale = torch.log(scale) if torch.is_tensor(scale) else math.log(scale)
    return -0.5 * z * z - log_scale - 0.5 * LOG_2PI


# ---------------------------------------------------------------------------
# Parameters, data, configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CloneAlignParams:
    """Free variables optimized jointly by Adam
    (reference R/inference-tflow.R:240-273)."""

    W: torch.Tensor              # (G, K) gene loadings, init 0
    chi_unconstr: torch.Tensor   # (K,) prior precision of W (chi = exp), init 0
    psi: torch.Tensor            # (N, K) cell latent factors, init PCA
    alpha_unconstr: torch.Tensor  # (C,) clone mixing logits, init 0
    qmu_loc: torch.Tensor        # (G,) variational loc of inv-softplus(mu)
    qmu_log_scale: torch.Tensor  # (G,) log scale, init log(1)=0
    gamma_logits: torch.Tensor   # (N, C) variational clone responsibilities
    beta: torch.Tensor           # (G, P) covariate coefficients, init 0 (P may be 0)

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def replace(self, **changes) -> "CloneAlignParams":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class ModelData:
    """Per-fit tensors, computed once and kept on the device."""

    Y: torch.Tensor          # (N, G) counts in the storage dtype (compute dtype, int8, int16, bfloat16)
    L: torch.Tensor          # (G, C) copy numbers (saturated)
    s: torch.Tensor          # (N,) per-cell totals (multinomial total_count)
    log_binom: torch.Tensor  # (N,) lgamma(s+1) - sum_g lgamma(y+1)
    YlogL: torch.Tensor      # (N, C) sum_g xlogy(y_ng, L_gc)
    colsum_Y: torch.Tensor   # (G,) per-gene count totals (see elbo())
    X: Optional[torch.Tensor] = None  # (N, P) covariates in the compute dtype, or None
    # on a mesh, which block of the fit's cells the per-cell fields hold
    # (then colsum_Y is the whole fit's); None in one process
    cells: Optional[Cells] = None
    # on a mesh with a genes axis, which block of the genes Y, L and
    # colsum_Y hold (the per-cell statistics are every gene's); else None
    genes: Optional[Genes] = None


def param_specs(batched: bool = False) -> CloneAlignParams:
    """For each field of ``CloneAlignParams``, the axes it is split along on
    a mesh: a tuple with ``CELL_AXIS`` at the cells' dimension,
    ``GENE_AXIS`` at the genes' and None elsewhere
    (clonealign_tpu/parallel/sharding.py:81-96); ``batched`` adds a leading
    restart (lane) axis, on every rank whole."""
    lead = (None,) if batched else ()
    return CloneAlignParams(
        W=lead + (GENE_AXIS, None),
        chi_unconstr=lead + (None,),
        psi=lead + (CELL_AXIS, None),
        alpha_unconstr=lead + (None,),
        qmu_loc=lead + (GENE_AXIS,),
        qmu_log_scale=lead + (GENE_AXIS,),
        gamma_logits=lead + (CELL_AXIS, None),
        beta=lead + (GENE_AXIS, None),
    )


class ModelConfig(NamedTuple):
    K: int = 1
    P: int = 0  # covariate columns
    mc_samples: int = 1
    fix_alpha: bool = False
    # "xla" (and "auto", at this layer) -> the exact normalizer through the
    # fused-likelihood op; "z_cheb" -> the Chebyshev log-normalizer (K = 1).
    # The public API resolves "auto" before the config reaches the model
    # (api._resolve_auto_impl).
    likelihood_impl: str = "auto"
    z_degree: int = 16  # Chebyshev degree for likelihood_impl="z_cheb"


# ---------------------------------------------------------------------------
# Data preparation
# ---------------------------------------------------------------------------

# Above this many elements the passes over Y outside the likelihood kernels
# (the data statistics, the PCA and the mu guess, z_cheb's A terms) go in
# row blocks, so that the device holds Y in its storage type and O(block x
# G) in the compute dtype, never a second full-precision N x G tensor
# (reference models/multinomial.py:287-299). 2^28 elements = 1 GB at
# float32; the 100,000 x 5,000 fit takes two blocks.
_CHUNK_ELEMENTS = 1 << 28

# numpy counterparts of the storage and compute dtypes, and back
_NUMPY = {torch.int8: np.int8, torch.int16: np.int16, torch.float32: np.float32,
          torch.float64: np.float64}
_TORCH = {np.dtype(v): k for k, v in _NUMPY.items()}


def _row_chunk_size(N: int, G: int) -> int:
    rows = max(1, _CHUNK_ELEMENTS // max(G, 1))
    rows = min(rows, N)
    if rows >= 8:
        rows -= rows % 8
    return rows


def _row_blocks(N: int, G: int):
    """(start, stop) of each row block; one empty block when N = 0."""
    chunk = max(1, _row_chunk_size(N, G))
    return [(i, min(i + chunk, N)) for i in range(0, max(N, 1), chunk)]


def _storage_name(store) -> str:
    return str(store).removeprefix("torch.")


def _wire_np(y_np, dtype, store):
    """The dtype a host count array is shipped to the device in: the fewest
    bytes an element that keep the values the statistics would see, or None
    (ship it as it is) (reference models/multinomial.py:373-397).

    Integer storage is lossless by contract, so counts ship as the narrower
    of the host integer type and the storage type, checked against the
    storage's range on the host before any narrowing
    (:func:`_host_check_lossless`). Other storage ships at the compute dtype
    when the host dtype is wider; bfloat16 is rounded on the device from the
    compute dtype, after the statistics, so its wire is never bfloat16."""
    y_np = np.dtype(y_np)
    if not store.is_floating_point:
        if np.issubdtype(y_np, np.integer) and y_np.itemsize <= store.itemsize:
            return None
        return np.dtype(_NUMPY[store])
    if y_np.itemsize > dtype.itemsize and store != torch.bfloat16:
        return np.dtype(_NUMPY[dtype])
    if y_np.itemsize > 4 and store == torch.bfloat16:
        return np.dtype(_NUMPY[dtype])
    return None


def _host_check_lossless(c, store):
    """Before a host count chunk (a CPU tensor) is narrowed to the integer
    storage type: raise on a count above the storage's range, a negative
    count (it would wrap positive) or a fractional one, with the device
    check's messages (reference models/multinomial.py:400-424)."""
    if not c.numel():
        return
    if c.dtype in (torch.uint16, torch.uint32, torch.uint64):  # PyTorch reduces none of them
        cmin, cmax = float(c.numpy().min()), float(c.numpy().max())
    else:
        cmin, cmax = (float(v) for v in torch.aminmax(c))
    info = torch.iinfo(store)
    if cmax > info.max:
        raise ValueError(
            f"y_storage={_storage_name(store)} cannot hold the largest count "
            f"({cmax:.0f} > {info.max}); use int16/bfloat16/float32"
        )
    if cmin < 0:
        raise ValueError("gene_expression_data must be non-negative raw counts")
    if c.is_floating_point() and bool(torch.any(c != torch.trunc(c))):
        raise ValueError("integer y_storage requires integer counts; found fractional values")


def _check_integer_storage(ymax, ymin, nonint, store):
    """The device check behind integer storage, on the largest count, the
    smallest and the largest distance to an integer the statistics saw
    (reference models/multinomial.py:749-770)."""
    if ymin < 0:
        raise ValueError("gene_expression_data must be non-negative raw counts")
    if store.is_floating_point:
        return
    info = torch.iinfo(store)
    if ymax > info.max:
        raise ValueError(
            f"y_storage={_storage_name(store)} cannot hold the largest count "
            f"({ymax:.0f} > {info.max}); use int16/bfloat16/float32"
        )
    if nonint != 0.0:
        raise ValueError("integer y_storage requires integer counts; found fractional values")


def _chunk_stats(yf, log_L_safe, zero_cols):
    """A row chunk's statistics in the compute dtype, products in full
    float32 (the YlogL constant feeds every ELBO evaluation): totals, the
    sums of lgamma(y + 1) (the log binomials' second term), YlogL with
    xlogy semantics, and the column sums. Each row's is a sum over the
    chunk's genes."""
    s = torch.sum(yf, dim=1)
    with full_fp32_matmul():
        B = yf @ log_L_safe
        hits_zero = (yf @ zero_cols) > 0
    B = torch.where(hits_zero, -math.inf, B)
    lgam = yf + 1.0
    lgam.lgamma_()
    return s, torch.sum(lgam, dim=1), B, torch.sum(yf, dim=0)


def prepare_data(Y, L, x=None, *, device, dtype=torch.float32, y_storage=None,
                 check_feasible=True, cells: Optional[Cells] = None,
                 genes: Optional[Genes] = None) -> ModelData:
    """The device data of a fit from a count matrix (a numpy array, a tensor,
    or a scipy sparse matrix, which goes to :func:`prepare_data_sparse`): Y
    stored as ``y_storage`` (None: the compute ``dtype``; or torch.int8,
    torch.int16, torch.bfloat16), its statistics and the covariates ``x``
    (N, P) or None in ``dtype`` (reference models/multinomial.py:219-284,
    564-746).

    The rows go to the device in chunks of ``_CHUNK_ELEMENTS``, each in its
    narrowest exact wire type (:func:`_wire_np`; checked and narrowed on the
    host by PyTorch's CPU kernels, which use every core); each chunk's statistics
    are taken in the compute dtype before it is written into one buffer
    preallocated in the storage type, so bfloat16 is rounded after them and
    no second full copy of Y is made. A tensor already on ``device`` in the
    storage type is kept as it is. Integer storage is exact: a count it
    cannot hold, a negative or a fractional count raises, and so does a
    negative count under any storage.

    ``YlogL`` uses xlogy semantics: a gene with zero copy number in clone c
    contributes -inf to that clone's log-likelihood only for cells
    expressing it. ``check_feasible=False`` leaves out
    :func:`_check_cells_feasible`, for a caller that filters genes first.

    On a mesh (``cells``) Y and ``x`` are this rank's rows: the column sums
    and the counts' range behind the storage check are every rank's, so
    every rank keeps the same genes and raises or not alike. With ``genes``
    Y and L are this rank's gene block: the row statistics (totals, log
    binomials, YlogL) are sums over every gene block.
    """
    kw = dict(device=device, dtype=dtype, y_storage=y_storage, check_feasible=check_feasible,
              cells=cells, genes=genes)
    if is_scipy_sparse(Y):
        return prepare_data_sparse(Y, L, x, **kw)
    if torch.is_tensor(Y):
        return _prepare_rows(Y, L, x, lambda i, j: Y[i:j], **kw)
    Y = np.asarray(Y)
    return _prepare_rows(Y, L, x, lambda i, j: torch.from_numpy(np.ascontiguousarray(Y[i:j])),
                         **kw)


def prepare_data_sparse(Y, L, x=None, *, device, dtype=torch.float32, y_storage=None,
                        check_feasible=True, cells: Optional[Cells] = None,
                        genes: Optional[Genes] = None) -> ModelData:
    """:func:`prepare_data` of a scipy sparse count matrix without a dense
    N x G host copy (reference models/multinomial.py:800-855). CSC and COO
    are converted to CSR once; the row-chunked loop then densifies one block
    of CSR rows at a time (``Y[i:j].toarray()``, in the input's dtype, then
    its narrowest exact wire type), so the host holds O(nnz + block x G).
    Each block's statistics are taken on the device as for dense input and
    it lands in the same preallocated storage buffer: a sparse fit equals
    the dense fit of the same counts. (The JAX package takes the statistics
    on the host in float64 from the sparse structure; in float64 the two
    agree to rounding.)"""
    Y = Y.tocsr()
    return _prepare_rows(Y, L, x, lambda i, j: torch.from_numpy(Y[i:j].toarray()),
                         device=device, dtype=dtype, y_storage=y_storage,
                         check_feasible=check_feasible, cells=cells, genes=genes)


def _prepare_rows(Y, L, x, rows, *, device, dtype, y_storage, check_feasible, blocks=None,
                  with_y=True, cells: Optional[Cells] = None,
                  genes: Optional[Genes] = None) -> ModelData:
    """The loop of :func:`prepare_data` over the row blocks of Y (N x G, a
    tensor or a host matrix with a numpy ``dtype``), ``rows(i, j)`` giving
    rows i:j as a tensor. ``blocks`` are the (start, stop) rows of each
    block, by default :func:`_row_blocks`; with ``with_y=False`` only the
    statistics stay on the device (a streaming fit's: ``Y`` is None).
    ``cells`` and ``genes``: see :func:`prepare_data`."""
    device = torch.device(device)
    store = dtype if y_storage is None else y_storage
    N, G = Y.shape
    Ld = torch.as_tensor(np.asarray(L), dtype=dtype, device=device)
    log_L_safe = torch.where(Ld > 0, torch.log(torch.where(Ld > 0, Ld, 1.0)), 0.0)
    zero_cols = (Ld <= 0).to(dtype)
    wire = None if torch.is_tensor(Y) else _wire_np(Y.dtype, dtype, store)
    wire = None if wire is None else _TORCH[wire]

    keep = not with_y or (torch.is_tensor(Y) and Y.device == device and Y.dtype == store)
    Yd = (Y if with_y else None) if keep else torch.empty((N, G), dtype=store, device=device)
    parts = []
    colsum = torch.zeros(G, dtype=dtype, device=device)
    ymax = torch.full((), -math.inf, dtype=dtype, device=device)
    ymin = torch.full((), math.inf, dtype=dtype, device=device)
    nonint = torch.zeros((), dtype=dtype, device=device)
    error = None  # on a mesh, a host check's error waits for the ranks' collectives
    for i, j in _row_blocks(N, G) if blocks is None else blocks:
        c = rows(i, j)
        if wire is not None and c.dtype != wire:
            if not store.is_floating_point:
                try:
                    _host_check_lossless(c, store)
                except ValueError as e:
                    if cells is None:
                        raise
                    error = e
                    break
            c = c.to(wire)
        yc = c.to(device)
        yf = yc.to(dtype)
        if yf.numel():
            ymax = torch.maximum(ymax, yf.max())
            ymin = torch.minimum(ymin, yf.min())
            if yc.is_floating_point() and not store.is_floating_point:
                nonint = torch.maximum(nonint, (yf - torch.round(yf)).abs().max())
        if not keep:
            Yd[i:j].copy_(yc if yc.dtype == store else yf)
        s, log_binom, B, cs = _chunk_stats(yf, log_L_safe, zero_cols)
        parts.append((s, log_binom, B))
        colsum += cs
        del yc, yf
    colsum = all_sum(colsum, cells)
    failed = torch.full((), float(error is not None), dtype=dtype, device=device)
    ymax, neg_ymin, nonint, failed = world_max(torch.stack([ymax, -ymin, nonint, failed]),
                                               cells, genes).unbind()
    if float(failed):
        raise error or ValueError("the counts failed a check on another rank of the mesh")
    if (N if cells is None else cells.n) * G:
        _check_integer_storage(float(ymax), float(-neg_ymin), float(nonint), store)
    s, lgam_sum, B = (torch.cat(p) for p in zip(*parts))
    if genes is not None:  # the row sums over every gene block, in one all_reduce
        s, lgam_sum, B = all_sum(torch.cat([s[:, None], lgam_sum[:, None], B], dim=1),
                                 genes).split([1, 1, B.shape[1]], dim=1)
        s, lgam_sum = s[:, 0], lgam_sum[:, 0]
    log_binom = torch.lgamma(s + 1.0) - lgam_sum
    if check_feasible:
        _check_cells_feasible(B, cells)
    X = None if x is None else torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                                               dtype=dtype, device=device)
    return ModelData(Y=Yd, L=Ld, s=s, log_binom=log_binom, YlogL=B, colsum_Y=colsum, X=X,
                     cells=cells, genes=genes)


def _check_cells_feasible(B, cells: Optional[Cells] = None):
    """Every cell needs >= 1 clone with finite YlogL. A cell with nonzero
    counts at a zero-copy-number gene in EVERY clone has zero likelihood
    under the whole model; it is a typed input error instead of a NaN fit.
    On a mesh (``cells``) the count and the first such cell are every
    rank's, so every rank raises alike."""
    bad = ~torch.any(torch.isfinite(B), dim=1)
    n_bad = bad.sum()
    first = torch.argmax(bad.to(torch.int8)) if B.shape[0] else n_bad
    if cells is not None:
        first = torch.where(n_bad > 0, first + cells.start, cells.n)
        n_bad, first = all_sum(n_bad, cells), all_min(first, cells)
    n_bad = int(n_bad)
    if n_bad:
        first = int(first)
        raise ValueError(
            f"{n_bad} cell(s) have nonzero counts at genes whose copy "
            f"number is 0 in every clone (first: cell {first}) — no clone "
            "can explain them. Remove these cells, or fix the copy-number "
            "matrix (genes with copy number 0 across all clones are "
            "removed by preprocess_for_clonealign)."
        )


# ---------------------------------------------------------------------------
# Initialization (reference R/inference-tflow.R:204-273)
# ---------------------------------------------------------------------------

def _standardize(x, dim=0, ddof=1, cells: Optional[Cells] = None):
    """``x`` less its mean over ``dim``, over its sd. On a mesh (``cells``,
    ``dim`` 0, x this rank's rows of a thin matrix such as the PCA scores)
    the rows are gathered, so that the mean and sd are the one-process
    fit's to the bit, and this rank's rows come back."""
    if cells is not None:
        return _standardize(gather_rows(x, cells), dim, ddof)[cells.start : cells.stop]
    mu = torch.mean(x, dim=dim, keepdim=True)
    sd = torch.std(x, dim=dim, keepdim=True, correction=ddof)
    return (x - mu) / torch.where(sd == 0, 1.0, sd)


def randomized_pca(X, k: int, noise, oversample: int = 8, power_iters: int = 4):
    """Top-k PCA scores of the column-standardized X via randomized subspace
    iteration; the Gaussian test matrix is ``noise``'s ``"pca_omega"`` draw.
    Signs of the scores are arbitrary, as with any SVD."""
    n, g = X.shape
    k_eff = min(k + oversample, min(n, g))
    Xc = _standardize(X, dim=0)
    omega = noise.normal("pca_omega", (g, k_eff), X.dtype, X.device)
    with full_fp32_matmul():
        Q = Xc @ omega
        for _ in range(power_iters):
            Q, _ = torch.linalg.qr(Q)
            Q, _ = torch.linalg.qr(Xc @ (Xc.T @ Q))
        B = Q.T @ Xc  # (k_eff, g)
        _, _, Vt = torch.linalg.svd(B, full_matrices=False)
        return Xc @ Vt[:k].T  # (n, k)


def _pca_scores_blocked(Y, k: int, noise, dtype, oversample: int = 8, power_iters: int = 4,
                        blocks=None, cells: Optional[Cells] = None,
                        genes: Optional[Genes] = None):
    """:func:`randomized_pca` of log2(Y+1) without the standardized N x G
    matrix (reference models/multinomial.py:891-937): every product
    recomputes each row block's ``(log2(y+1) - mean) / sd`` from the stored
    Y. Same algorithm and draws; the column sd comes from sums of squares.

    ``Y`` is the device tensor, or a row source that holds Y on the host
    (``stream._DeviceRows``: ``shape``, ``device``, and ``Y[i:j]`` uploading
    rows i:j), as the reference reads its ``_RowSource``. ``blocks`` are the
    (start, stop) rows of each block, by default :func:`_row_blocks`.

    On a mesh (``cells``) Y is this rank's rows. The column mean and sd and
    ``Xc.T @ Q`` are sums over every rank's rows; ``Xc @ M`` is gathered to
    the whole (N, k + 8) matrix, 4 MB at 100,000 cells in float32, whose QR
    every rank takes alike, so that the scores keep the one-process fit's
    signs (a CholeskyQR of the row blocks would fix other ones). B's SVD is
    every rank's too; the scores are the rank's rows.

    With ``genes`` Y is this rank's gene block of its rows: ``Xc @ M`` is
    a sum over every gene block (M this block's rows), the Gaussian test
    matrix is drawn for every gene and sliced, and B = Q.T Xc is gathered
    over the genes, so that every rank takes the one-process SVD and
    signs."""
    n_rows, G_local = Y.shape
    N = n_rows if cells is None else cells.n
    G = G_local if genes is None else genes.g
    blocks = _row_blocks(n_rows, G_local) if blocks is None else blocks
    k_eff = min(k + oversample, min(N, G))

    def xb(i, j):
        return torch.log2(Y[i:j].to(dtype) + 1.0)

    total = torch.zeros(G_local, dtype=dtype, device=Y.device)
    sumsq = torch.zeros(G_local, dtype=dtype, device=Y.device)
    for i, j in blocks:
        b = xb(i, j)
        total += torch.sum(b, dim=0)
        sumsq += torch.sum(b * b, dim=0)
    total, sumsq = all_sum(torch.stack([total, sumsq]), cells).unbind()
    mean = total / N
    sd = torch.sqrt(torch.clamp_min(sumsq - N * mean * mean, 0.0) / max(N - 1, 1))
    sd = torch.where(sd == 0, 1.0, sd)

    def xcb(i, j):
        return (xb(i, j) - mean) / sd

    def xc_matmul(M):  # Xc @ M, this rank's rows, every gene block's sum
        return all_sum(torch.cat([xcb(i, j) @ M for i, j in blocks], dim=0), genes)

    def xcT_matmul(Q):  # Xc.T @ Q, Q every rank's rows; this gene block's rows
        Q = Q if cells is None else Q[cells.start : cells.stop]
        acc = torch.zeros(G_local, Q.shape[1], dtype=dtype, device=Y.device)
        for i, j in blocks:
            acc += xcb(i, j).T @ Q[i:j]
        return all_sum(acc, cells)

    def own(M):  # this gene block's rows of a (G, ...) matrix
        return M if genes is None else M[genes.start : genes.stop]

    omega = own(noise.normal("pca_omega", (G, k_eff), dtype, Y.device))
    with full_fp32_matmul():
        Q = gather_rows(xc_matmul(omega), cells)
        for _ in range(power_iters):
            Q, _ = torch.linalg.qr(Q)
            Q, _ = torch.linalg.qr(gather_rows(xc_matmul(xcT_matmul(Q)), cells))
        B = gather_cols(xcT_matmul(Q).T, genes, dim=1)  # (k_eff, G)
        _, _, Vt = torch.linalg.svd(B, full_matrices=False)
        return xc_matmul(own(Vt[:k].T))  # (N, k)


def pca_init_scores(Y, K: int, noise, dtype=torch.float32, cells: Optional[Cells] = None,
                    genes: Optional[Genes] = None):
    """Standardized top-K PCA scores of log2(Y+1)
    (reference R/inference-tflow.R:204-207), before the jitter, row-blocked
    above ``_CHUNK_ELEMENTS`` and on a mesh (``cells``: Y this rank's rows,
    the scores too; ``genes``: Y its gene block of them). A restart sweep
    computes them once and shares them across lanes."""
    N, G = Y.shape
    if K <= 0:
        return torch.zeros(N, 0, dtype=dtype, device=Y.device)
    if cells is not None or N * G > _CHUNK_ELEMENTS:  # a mesh with genes has cells too
        pcs = _pca_scores_blocked(Y, K, noise, dtype, cells=cells, genes=genes)
    else:
        pcs = randomized_pca(torch.log2(Y.to(dtype) + 1.0), K, noise)
    return _standardize(pcs, dim=0, cells=cells)


def data_mu_guess(Y, dtype=torch.float32, blocks=None, cells: Optional[Cells] = None,
                  genes: Optional[Genes] = None):
    """colMeans(Y / rowMeans(Y)) — the data-driven mu initialization
    (reference R/inference-tflow.R:220-231), row-blocked above
    ``_CHUNK_ELEMENTS`` or over the given ``blocks``; ``Y`` and ``blocks``
    as :func:`_pca_scores_blocked` takes them. On a mesh (``cells``) Y is
    this rank's rows and the sum is every rank's, over every cell; with
    ``genes`` Y is its gene block of them, and the row means are every
    gene block's."""
    N, G = Y.shape
    if blocks is not None or cells is not None or N * G > _CHUNK_ELEMENTS:
        acc = torch.zeros(G, dtype=dtype, device=Y.device)
        for i, j in _row_blocks(N, G) if blocks is None else blocks:
            yb = Y[i:j].to(dtype)
            if genes is None:
                row_mean = torch.mean(yb, dim=1, keepdim=True)
            else:
                row_mean = all_sum(torch.sum(yb, dim=1, keepdim=True), genes) / genes.g
            acc += torch.sum(yb / row_mean, dim=0)
        return all_sum(acc, cells) / (N if cells is None else cells.n)
    Y = Y.to(dtype)
    return torch.mean(Y / torch.mean(Y, dim=1, keepdim=True), dim=0)


def init_params(
    Y,
    L,
    noise,
    K: int = 1,
    data_init_mu=True,
    dtype=torch.float32,
    pca_scores=None,
    mu_guess=None,
    P: int = 0,
    cells: Optional[Cells] = None,
    genes: Optional[Genes] = None,
) -> CloneAlignParams:
    """Initial parameter values (reference R/inference-tflow.R:204-273).

    - psi: PCA of log2(Y+1), re-standardized, + N(0, 0.05) jitter
    - qmu_loc: inv-softplus of colMeans(Y / rowMeans(Y)) (or ones, or the
      given array divided by its mean)
    - everything else zeros, beta (G, P) included

    ``pca_scores`` / ``mu_guess`` take precomputed outputs of
    :func:`pca_init_scores` / :func:`data_mu_guess` (shared across restarts).
    On a mesh (``cells``) Y is this rank's rows: the jitter is drawn for
    every cell and sliced, so each rank's rows are the one-process fit's.
    With ``genes`` Y and L are its gene block: the per-gene parameters are
    the block's, an array ``data_init_mu`` (every kept gene's) is divided
    by its mean over every gene and sliced.
    """
    N, G = Y.shape
    C = L.shape[1]
    dev = Y.device

    if K > 0:
        pcs = (pca_scores if pca_scores is not None
               else pca_init_scores(Y, K, noise, dtype, cells=cells, genes=genes))
        if cells is None:
            jitter = noise.normal("psi_jitter", pcs.shape, dtype, dev)
        else:
            jitter = noise.normal("psi_jitter", (cells.n, K), dtype, dev)[cells.start : cells.stop]
        pcs = pcs.to(dtype) + 0.05 * jitter
    else:
        pcs = torch.zeros(N, 0, dtype=dtype, device=dev)

    if mu_guess is not None:
        mu_guess = torch.as_tensor(mu_guess, dtype=dtype, device=dev)
    elif isinstance(data_init_mu, (bool, np.bool_)):
        mu_guess = (data_mu_guess(Y, dtype, cells=cells, genes=genes) if data_init_mu
                    else torch.ones(G, dtype=dtype, device=dev))
    else:
        mu_guess = torch.as_tensor(data_init_mu, dtype=dtype, device=dev)
        mu_guess = mu_guess / torch.mean(mu_guess)
        if genes is not None:
            mu_guess = mu_guess[genes.start : genes.stop]

    def zeros(*shape):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    return CloneAlignParams(
        W=zeros(G, max(K, 0)),
        chi_unconstr=zeros(max(K, 0)),
        psi=pcs,
        alpha_unconstr=zeros(C),
        qmu_loc=safe_inverse_softplus(mu_guess),
        qmu_log_scale=zeros(G),
        gamma_logits=zeros(N, C),
        beta=zeros(G, P),
    )


# ---------------------------------------------------------------------------
# Likelihood + ELBO
# ---------------------------------------------------------------------------

def sample_mu_base(params: CloneAlignParams, eps):
    """Reparametrized base-normal draws from the (..., S, G) standard normals
    ``eps``; mu = softplus(base) (reference R/inference-tflow.R:258-269)."""
    return params.qmu_loc[..., None, :] + torch.exp(params.qmu_log_scale)[..., None, :] * eps


def stack_lanes(tensors):
    """One tensor with a leading lane axis from the lanes' tensors (a view
    for a single lane, which saves the copy)."""
    return tensors[0].unsqueeze(0) if len(tensors) == 1 else torch.stack(tensors)


class _RowBlockedProduct(torch.autograd.Function):
    """``Y @ B2`` over row blocks of Y, each converted to B2's dtype (a no-op
    for Y in it), in full float32. The backward converts each block again
    for ``dB2 = sum_blocks Y_block^T dOut_block`` instead of keeping the
    converted blocks, so a narrow Y never has a full-precision copy, not
    even between the forward and the backward. Y gets no gradient."""

    @staticmethod
    def forward(ctx, Y, B2):
        ctx.save_for_backward(Y)
        with full_fp32_matmul():
            return torch.cat([Y[i:j].to(B2.dtype) @ B2 for i, j in _row_blocks(*Y.shape)], dim=0)

    @staticmethod
    def backward(ctx, dout):
        (Y,) = ctx.saved_tensors
        dB2 = torch.zeros(Y.shape[1], dout.shape[1], dtype=dout.dtype, device=dout.device)
        with full_fp32_matmul():
            for i, j in _row_blocks(*Y.shape):
                dB2 += Y[i:j].to(dout.dtype).T @ dout[i:j]
        return None, dB2


def _y_times(Y, B):
    """``Y @ B`` for B of shape (..., G, J), as (..., N, J): one product with
    Y serves every lane, row-blocked (:class:`_RowBlockedProduct`) so that
    every storage type of Y takes the same path."""
    (N, G), J = Y.shape, B.shape[-1]
    lead = B.shape[:-2]
    out = _RowBlockedProduct.apply(Y, B.movedim(-2, 0).reshape(G, -1))  # (N, prod(lead) J)
    return out.reshape(N, *lead, J).movedim(0, -2)


def _a_terms(params, data, log_mu):
    """A1 (..., N) and A2 (..., N, S) or None as products with Y in full
    float32 (reference models/multinomial.py:1271-1279): the z_cheb path's,
    where the fused op is not called. With ``data.genes`` the products are
    summed over every gene block."""
    genes = data.genes
    with full_fp32_matmul():
        A1 = torch.sum(params.psi * sum_over_genes(_y_times(data.Y, params.W), genes), dim=-1)
        A2 = None if log_mu is None else sum_over_genes(_y_times(data.Y, log_mu.mT), genes)
    return A1, A2


def _extended(psi, W, beta, X):
    """``psi_ext = [psi, X]`` (N, K + P) and ``W_ext = [W, beta]`` (G, K + P)
    of one lane (reference ops/fused_likelihood.py:22-23); psi and W as they
    are without covariates. X is data: the fused op's backward computes
    d psi_ext for its columns too, and autograd drops them at the
    concatenation, which passes only psi's columns on."""
    if beta.shape[-1] == 0:
        return psi, W
    return torch.cat([psi, X], dim=-1), torch.cat([W, beta], dim=-1)


def _likelihood_terms(params, data, mu_samples, log_mu, config=None):
    """A1 (..., N), A2 (..., N, S) or None, and log Z as (..., S, C, N)
    (the reference's ``_compute_logZ`` with the A terms beside it).

    Exact: through the fused-likelihood op on ``[psi, X]`` and ``[W, beta]``
    (:func:`_extended`), once per lane when the parameters carry a lane axis
    (the op's kernels take one lane; X is shared). z_cheb:
    :func:`_compute_logZ_cheb` and :func:`_a_terms`.

    With ``data.genes`` the op runs on this rank's gene block and its A1,
    A2 and Z, partial sums over genes, are summed over every gene block in
    one all_reduce an evaluation (every lane's at once, before the log);
    psi enters the op through :func:`grad_sum_over_genes`, since its
    gradient from the op is a partial sum too.
    """
    if _use_z_cheb(config):
        A1, A2 = _a_terms(params, data, log_mu)
        return A1, A2, _compute_logZ_cheb(params, data, mu_samples, config.z_degree)
    S, G = mu_samples.shape[-2:]
    N, C = data.Y.shape[0], data.L.shape[1]
    lead = mu_samples.shape[:-2]
    genes = data.genes
    muL = (mu_samples[..., :, :, None] * data.L).transpose(-3, -2).reshape(*lead, G, S * C)
    psi = grad_sum_over_genes(params.psi, genes)
    if not lead:
        psi_ext, W_ext = _extended(psi, params.W, params.beta, data.X)
        A1, A2, Z = fused_likelihood_terms(data.Y, psi_ext, W_ext, log_mu, muL)
    else:
        log_mus = [None] * lead[0] if log_mu is None else log_mu.unbind(0)
        lanes = [
            fused_likelihood_terms(data.Y, *_extended(p, W, beta, data.X), lm, m)
            for p, W, beta, lm, m in zip(psi.unbind(0), params.W.unbind(0),
                                         params.beta.unbind(0), log_mus, muL.unbind(0))
        ]
        A1 = stack_lanes([a1 for a1, _, _ in lanes])
        A2 = None if log_mu is None else stack_lanes([a2 for _, a2, _ in lanes])
        Z = stack_lanes([z for _, _, z in lanes])
    if genes is not None:
        terms = [t for t in (A1, A2, Z) if t is not None]
        flat = sum_over_genes(torch.cat([t.reshape(-1) for t in terms]), genes)
        A1, *rest = [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in terms]),
                                                           terms)]
        A2, Z = (None, rest[0]) if A2 is None else rest
    logZ = torch.log(Z).reshape(*lead, N, S, C).movedim(-3, -1)
    return A1, A2, logZ


def log_p_y_on_c(params: CloneAlignParams, data: ModelData, mu_base, config=None,
                 extra_log_lik=None):
    """(..., S, C, N) expression log-likelihood, decomposed form (module
    docstring). ``extra_log_lik`` is an optional (N, C) addition, the
    allele-specific beta-binomial term (reference R/inference-tflow.R:302-304;
    ``models/allele.py``), shared by every lane."""
    mu_samples = softplus(mu_base)
    log_mu = torch.log(mu_samples)
    A1, A2, logZ = _likelihood_terms(params, data, mu_samples, log_mu, config)
    ll = (
        data.log_binom
        + A1[..., None, None, :]
        + A2.mT[..., :, None, :]
        + data.YlogL.T
        - data.s * logZ
    )
    return ll if extra_log_lik is None else ll + extra_log_lik.T


def elbo(params: CloneAlignParams, data: ModelData, eps, config: ModelConfig,
         extra_log_lik=None):
    """The evidence lower bound (reference R/inference-tflow.R:298-336) at the
    mu sample made from the (..., S, G) standard normals ``eps``; one value
    per lane. ``extra_log_lik`` is the optional (N, C) allele term.

    Reproduces the reference's objective with its quirks: the mu prior is
    Normal(0,1) on log(mu) without a Jacobian, and the Dirichlet prior is
    evaluated at softmax(alpha)+1e-3, off the simplex.

    Constant-cotangent decomposition: the likelihood terms that are the same
    for every clone — log_binom, A1, A2 — leave the responsibility
    contraction, because softmax rows sum to 1 and a per-cell constant
    shift is annihilated by the softmax Jacobian. So A2 enters as
    ``dot(colsum_Y, sum_s log_mu) / S`` (Y is not read for it) and A1 as
    its sum; only YlogL, the normalizer Z and the allele term, which differ
    by clone, stay inside the contraction.

    It is :func:`elbo_cell_terms` plus :func:`elbo_global_terms` at one mu
    draw; on a mesh (``data.cells``) the cell terms are this rank's only.
    """
    mu_base = sample_mu_base(params, eps)
    return (elbo_cell_terms(params, data, mu_base, config, extra_log_lik)
            + elbo_global_terms(params, mu_base, config, data.colsum_Y, data.genes))


def gamma_warm_start_logits(
    params: CloneAlignParams,
    data: ModelData,
    eps,
    initial_shrink=5.0,
    config=None,
    extra_log_lik=None,
):
    """Likelihood-based responsibility warm start
    (reference R/inference-tflow.R:338-342,367-369), at the mu sample made
    from the (..., S, G) standard normals ``eps``. Logits are scaled by
    ``initial_shrink``/5: 0 = uniform, 5 = the reference's behaviour,
    10 = sharper; with a lane axis ``initial_shrink`` may be an (R,) tensor,
    one shrink per lane. ``extra_log_lik`` is the optional (N, C) allele
    term."""
    p_y = log_p_y_on_c(params, data, sample_mu_base(params, eps), config,
                       extra_log_lik)  # (..., S, C, N)
    # SUM over MC samples, as the reference's tf$reduce_sum(p_y_on_c, axis=0)
    g = torch.sum(p_y, dim=-3)  # (..., C, N)
    impossible = torch.isneginf(g)  # zero-CN clone at an expressed gene
    g = g - torch.logsumexp(g, dim=-2, keepdim=True)
    if torch.is_tensor(initial_shrink):
        initial_shrink = initial_shrink[..., None, None]
    logits = (initial_shrink / 5.0) * torch.clamp_min(g, -1e30)
    # impossible clones stay impossible at any shrink: their logit is pinned
    # at a finite value whose softmax underflows to exactly 0
    logits = torch.where(impossible, -1e30, logits)
    return logits.mT  # (..., N, C)


# ---------------------------------------------------------------------------
# Cell / global ELBO split
# ---------------------------------------------------------------------------
#
# elbo() is a sum of per-cell terms and terms that do not depend on the
# cells (reference models/multinomial.py:1441-1560). A streaming fit
# evaluates the per-cell part one chunk of cells at a time, every chunk at
# the same (S, G) mu draw, and adds the global part once:
#
#   elbo(params, data, eps) == sum over chunks of elbo_cell_terms(chunk)
#                              + elbo_global_terms(params, mu_base, colsum_Y)
#
# up to the order of the floating-point sums. A fit whose cells are split
# over ranks sums the cell terms of every rank's rows the same way. Both
# take parameters with a leading lane axis.

def _log_alpha(params, config):
    zeros_or_alpha = (torch.zeros_like(params.alpha_unconstr) if config.fix_alpha
                      else params.alpha_unconstr)
    return torch.log_softmax(zeros_or_alpha, dim=-1)


def elbo_cell_terms(params: CloneAlignParams, data: ModelData, mu_base, config: ModelConfig,
                    extra_log_lik=None):
    """The per-cell part of :func:`elbo` for the cells in ``data``: log
    binomials and A1, the responsibility-weighted clone log-likelihood, the
    clone prior's and the psi prior's terms, minus the responsibilities'
    entropy term.

    ``params.psi`` and ``params.gamma_logits`` (and ``data``'s per-cell
    fields, ``extra_log_lik`` among them) carry only this chunk's rows; the
    other fields are the whole fit's. ``mu_base`` is the step's one (..., S,
    G) draw (:func:`sample_mu_base`), shared by every chunk and by
    :func:`elbo_global_terms`; one value per lane. The likelihood goes through
    :func:`_likelihood_terms`, so on CUDA tensors through the fused kernels,
    and under z_cheb the Chebyshev table is fitted to this chunk's psi.
    ``data.colsum_Y`` is not read."""
    mu_samples = softplus(mu_base)
    cells = (-2, -1)  # the (N, C) / (N, K) axes a lane's sums run over
    A1, _, logZ = _likelihood_terms(params, data, mu_samples, None, config)
    const_sum = torch.sum(data.log_binom) + torch.sum(A1, dim=-1)

    clone_ll = data.YlogL.T - data.s * logZ  # (..., S, C, N)
    if extra_log_lik is not None:
        clone_ll = clone_ll + extra_log_lik.T
    gamma = torch.softmax(params.gamma_logits, dim=-1)
    log_gamma = torch.log_softmax(params.gamma_logits, dim=-1)
    E_clone_ll = torch.mean(clone_ll, dim=-3)  # (..., C, N)
    # xlogy-style guard: a clone with zero copy number at an expressed gene
    # has log-lik -inf and responsibility exactly 0; 0 * -inf must give 0.
    # The -inf is masked before the multiply so the backward pass never
    # sees 0 * inf either.
    safe_ll = torch.where(gamma == 0, 0.0, E_clone_ll.mT)
    EE_p_y = torch.sum(gamma * safe_ll, dim=cells) + const_sum

    E_log_p_cells = torch.sum(_log_alpha(params, config)[..., None, :] * gamma, dim=cells)
    if config.K > 0:
        E_log_p_cells = E_log_p_cells + torch.sum(_normal_log_prob(params.psi), dim=cells)
    gamma_entropy_term = torch.sum(torch.where(gamma == 0, 0.0, gamma * log_gamma), dim=cells)
    return EE_p_y + E_log_p_cells - gamma_entropy_term


def elbo_global_terms(params: CloneAlignParams, mu_base, config: ModelConfig, colsum_Y,
                      genes: Optional[Genes] = None):
    """The part of :func:`elbo` that does not depend on the cells, added once
    an evaluation: the A2 = Y log mu constant from the per-gene totals
    ``colsum_Y``, the mu, Dirichlet, W and chi priors, minus the qmu
    entropy term. ``params.psi`` and ``params.gamma_logits`` are not read.

    With ``genes`` the per-gene fields, ``mu_base`` and ``colsum_Y`` are
    this rank's gene block: the four sums over genes (the A2 constant, the
    mu and W priors, the qmu entropy) are summed over every gene block in
    one all_reduce, and chi enters the W prior through
    :func:`grad_sum_over_genes` (the chi prior reads it as it is, so that
    its gradient is counted once)."""
    S = config.mc_samples
    axes = (-2, -1)  # the (S, G) / (G, K) axes a lane's sums run over
    log_mu = torch.log(softplus(mu_base))
    A2_sum = torch.sum(colsum_Y * torch.sum(log_mu, dim=-2), dim=-1) / S

    log_alpha = _log_alpha(params, config)
    C = log_alpha.shape[-1]
    dir_conc = 1.0 / C
    dir_x = torch.exp(log_alpha) + 1e-3
    dirichlet_lp = (torch.sum((dir_conc - 1.0) * torch.log(dir_x), dim=-1)
                    - C * math.lgamma(dir_conc))
    mu_prior = torch.sum(_normal_log_prob(log_mu), dim=axes) / S
    w_prior = chi_prior = None
    if config.K > 0:
        chi = torch.exp(params.chi_unconstr)
        w_scale = torch.sqrt(1.0 / grad_sum_over_genes(chi, genes))
        w_prior = torch.sum(_normal_log_prob(params.W, 0.0, w_scale[..., None, :]), dim=axes)
        chi_prior = torch.sum(torch.log(chi) - chi, dim=-1)

    scale = torch.exp(params.qmu_log_scale)
    qmu_lp = _normal_log_prob(mu_base, params.qmu_loc[..., None, :], scale[..., None, :])
    qmu_lp = qmu_lp - torch.nn.functional.logsigmoid(mu_base)
    entropy = torch.sum(torch.mean(qmu_lp, dim=-2), dim=-1)
    if genes is not None:
        sums = [A2_sum, mu_prior, entropy] + ([] if w_prior is None else [w_prior])
        A2_sum, mu_prior, entropy, *w = sum_over_genes(torch.stack(sums), genes).unbind()
        w_prior = w[0] if w else None
    E_log_p_glob = mu_prior + dirichlet_lp
    if config.K > 0:
        E_log_p_glob = E_log_p_glob + w_prior
        E_log_p_glob = E_log_p_glob + chi_prior
    return A2_sum + E_log_p_glob - entropy


# ---------------------------------------------------------------------------
# Chebyshev log-normalizer (likelihood_impl="z_cheb")
# ---------------------------------------------------------------------------

def _clenshaw(coef, x):
    """sum_j coef[..., j] T_j(x_n) by the Clenshaw recurrence.

    coef: (..., S, C, D+1), x: (..., N) in [-1, 1] -> (..., S, C, N).
    """
    D = coef.shape[-1] - 1
    xb = x[..., None, None, :]
    two_x = 2.0 * xb
    b1 = torch.zeros(coef.shape[:-1] + x.shape[-1:], dtype=x.dtype, device=x.device)
    b2 = b1
    for j in range(D, 0, -1):
        b1, b2 = two_x * b1 - b2 + coef[..., j : j + 1], b1
    return xb * b1 - b2 + coef[..., 0:1]


class _ChebEval(torch.autograd.Function):
    """Chebyshev-series evaluation with an analytic, residual-free backward
    (reference models/multinomial.py:1110-1164): it saves only ``coef`` and
    ``x``, not the D Clenshaw carries autograd would keep.

    * d/dx differentiates the Clenshaw recurrence itself, carrying (b, b')
      pairs;
    * d/dcoef[..., j] = sum_n cot[..., n] T_j(x_n), one thin product with the
      Chebyshev-Vandermonde columns, rebuilt by the T_j recurrence.
    """

    @staticmethod
    def forward(ctx, coef, x):
        ctx.save_for_backward(coef, x)
        return _clenshaw(coef, x)

    @staticmethod
    def backward(ctx, cot):
        coef, x = ctx.saved_tensors
        D = coef.shape[-1] - 1
        xb = x[..., None, None, :]
        two_x = 2.0 * xb
        zero = torch.zeros_like(cot)
        b1, b2, db1, db2 = zero, zero, zero, zero
        for j in range(D, 0, -1):
            b1, b2, db1, db2 = (
                two_x * b1 - b2 + coef[..., j : j + 1],
                b1,
                2.0 * b1 + two_x * db1 - db2,
                db1,
            )
        # p = x b1 - b2 + c0  =>  dp/dx = b1 + x b1' - b2'
        dpdx = b1 + xb * db1 - db2  # (..., S, C, N)
        dx = torch.sum(cot * dpdx, dim=(-3, -2))  # (..., N)

        cols = [torch.ones_like(x), x]
        for _ in range(2, D + 1):
            cols.append(2.0 * x * cols[-1] - cols[-2])
        V = torch.stack(cols[: D + 1], dim=-1)  # (..., N, D+1)
        # full precision: the contraction feeds the optimizer's coefficient
        # gradients directly
        with full_fp32_matmul():
            dcoef = cot @ V[..., None, :, :]  # (..., S, C, D+1)
        return dcoef, dx


def cheb_eval(coef, x):
    """Evaluate the Chebyshev series ``coef`` (..., S, C, D+1) at ``x``
    (..., N) in [-1, 1], differentiably in both (see :class:`_ChebEval`)."""
    return _ChebEval.apply(coef, x)


def _compute_logZ_cheb(params: CloneAlignParams, data: ModelData, mu_samples, degree: int):
    """log Z[..., s, c, n] for K=1 by a Chebyshev expansion over psi
    (reference models/multinomial.py:1167-1222).

    With one latent dimension the normalizer is a smooth function of each
    cell's scalar psi, ``Z_c(t) = sum_g mu_sg L_gc exp(w_g t)``, so a
    degree-D Chebyshev polynomial is fitted to log Z_c over [min psi, max psi]
    (O(G x D) exps and two small products) and evaluated per cell by the
    Clenshaw recurrence, instead of the O(N x G) exps of the exact path.
    Gradients flow through the node table (mu, W, L) and the recurrence
    (psi); the expansion range is detached, like a constant grid. With
    ``data.genes`` the node table's sum over genes is every gene block's.
    """
    dt = params.psi.dtype
    w = params.W[..., 0]      # (..., G)
    psi = params.psi[..., 0]  # (..., N)
    mL = mu_samples[..., :, None, :] * data.L.T  # (..., S, C, G): this rank's gene block

    t_min = torch.amin(psi, dim=-1).detach()
    t_max = torch.amax(psi, dim=-1).detach()
    if data.cells is not None:  # the range of every rank's psi
        neg_min, t_max = all_max(torch.stack([-t_min, t_max]), data.cells).unbind()
        t_min = -neg_min
    mid = 0.5 * (t_min + t_max)
    half = torch.clamp_min(0.5 * (t_max - t_min), 1e-6)

    k = torch.arange(degree + 1, dtype=dt, device=psi.device)
    theta = math.pi * (k + 0.5) / (degree + 1)
    tk = mid[..., None] + half[..., None] * torch.cos(theta)  # (..., D+1) Chebyshev nodes
    expw = torch.exp(w[..., :, None] * tk[..., None, :])       # (..., G, D+1)
    # The table build is tiny (G x D + D^2 products) and runs in full
    # float32: rounded node values (|log Z| ~ 10) would annihilate the small
    # high-order coefficients the transform's cancellation produces.
    with full_fp32_matmul():
        Zk = sum_over_genes(mL @ expw[..., None, :, :], data.genes)  # (..., S, C, D+1)
        fk = torch.log(Zk)
        # center: the transform then cancels O(spread)~1 values, not O(10)
        f0 = torch.mean(fk, dim=-1, keepdim=True)
        M = torch.cos(k[:, None] * theta[None, :])  # (D+1, D+1)
        coef = (2.0 / (degree + 1)) * ((fk - f0) @ M.T)
    coef = torch.cat([0.5 * coef[..., :1] + f0, coef[..., 1:]], dim=-1)

    x = (psi - mid[..., None]) / half[..., None]  # (..., N)
    return cheb_eval(coef, x)  # (..., S, C, N)


def _use_z_cheb(config) -> bool:
    """Whether ``config`` selects the Chebyshev normalizer; raises where it
    cannot apply (reference models/multinomial.py:1225-1233)."""
    if config is None or config.likelihood_impl != "z_cheb":
        return False
    if config.K != 1 or config.P != 0:
        raise ValueError(
            "likelihood_impl='z_cheb' requires K=1 and no covariates "
            f"(got K={config.K}, P={config.P}); use the default backend"
        )
    return True

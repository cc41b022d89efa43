"""Clone calling and post-hoc QC (reference R/inference-tflow.R:22-46,
R/clonealign.R:318-334), counterpart of ``clonealign_tpu/assign.py``."""

from __future__ import annotations

import numpy as np
import torch

from .models.multinomial import _row_blocks
from .parallel.collectives import all_sum, gather_cols
from .utils.chunking import host_row_chunk as _host_row_chunk
from .utils.device import full_fp32_matmul
from .utils.sparsity import is_scipy_sparse as _is_scipy_sparse

UNASSIGNED = "unassigned"


def clone_assignment(clone_probs, clone_names, clone_assignment_probability: float = 0.95):
    """Threshold-argmax clone calls (reference R/inference-tflow.R:22-29):
    a cell gets its argmax clone if that probability reaches the threshold,
    otherwise ``"unassigned"``."""
    probs = np.asarray(clone_probs)
    names = np.asarray(list(clone_names) + [UNASSIGNED], dtype=object)
    best = probs.argmax(axis=1)
    maxp = probs.max(axis=1)
    # NaN rows (a diverged fit) must read as unassigned, not clone 0:
    # `nan < t` is False, so the plain threshold test would pass them through
    low = ~(maxp >= clone_assignment_probability)
    called = np.where(low, len(clone_names), best)
    return [str(x) for x in names[called]]


def recompute_clone_assignment(fit, clone_assignment_probability: float = 0.95):
    """Re-threshold an existing fit (reference R/inference-tflow.R:36-46)."""
    from dataclasses import replace

    clones = clone_assignment(
        fit.ml_params["clone_probs"], fit.clone_names, clone_assignment_probability
    )
    return replace(fit, clone=clones)


def compute_ca_fit_mse(fit, Y, L, model_mu: bool = False, random_clones: bool = False, rng=None):
    """Mean squared error of the fit's predicted expression
    (reference R/clonealign.R:415-434; unexported and uncalled there, kept
    for parity). ``random_clones`` replaces assignments with uniform draws
    from the distinct assigned clones as a baseline."""
    if _is_scipy_sparse(Y):
        Y = Y.toarray()
    Y = np.asarray(Y, np.float64)
    L = np.asarray(L, np.float64)
    clones = list(fit.clone)
    if random_clones:
        rng = np.random.default_rng() if rng is None else rng
        distinct = sorted(set(clones))
        clones = list(rng.choice(distinct, Y.shape[0], replace=True))

    col_idx = {str(c): i for i, c in enumerate(fit.clone_names)}
    # reference indexes L[, clones] directly; unassigned cells would error
    # there too — require callers to re-threshold first
    idx = np.asarray([col_idx[str(c)] for c in clones])
    predicted = L[:, idx]  # (G, N)
    if model_mu:
        predicted = np.asarray(fit.ml_params["mu"])[:, None] * predicted
    normalizer = Y.sum(axis=1) / predicted.sum(axis=0)
    predicted = predicted.T * normalizer[:, None]
    return float(np.mean((predicted - Y) ** 2))


def _clone_sums_device(Y_dev, idx_full, C, dtype=None, blocks=None, cells=None):
    """Sufficient statistics for :func:`compute_correlations` on the device
    that holds the counts: per-(clone, gene) sums S as (C, N) x (N, G)
    products, per-gene sum(y) from S, and sum(y^2) as masked column sums,
    over row blocks of Y converted one at a time (Y may be stored narrow;
    ``blocks``, by default ``_row_blocks``). A float64 fit (``dtype``, by
    default Y's) keeps float64 sums; otherwise they accumulate in float32
    without TF32. On a mesh (``cells``) Y is this rank's rows and the sums
    are every rank's."""
    acc = torch.float64 if (dtype or Y_dev.dtype) == torch.float64 else torch.float32
    (N, G), dev = Y_dev.shape, Y_dev.device
    idx = torch.as_tensor(np.asarray(idx_full), dtype=torch.int64, device=dev)
    keep = (idx >= 0).to(acc)
    onehot = torch.nn.functional.one_hot(idx.clamp_min(0), C).to(acc) * keep[:, None]
    S = torch.zeros(C, G, dtype=acc, device=dev)
    sum_y2 = torch.zeros(G, dtype=acc, device=dev)
    with full_fp32_matmul():
        for i, j in _row_blocks(N, G) if blocks is None else blocks:
            Yf = Y_dev[i:j].to(acc)
            S += onehot[i:j].T @ Yf          # (C, G)
            sum_y2 += keep[i:j] @ (Yf * Yf)  # (G,)
    S, sum_y2 = all_sum(torch.cat([S, sum_y2[None]]), cells).split([C, 1])
    S = S.cpu().numpy().astype(np.float64)
    return S, S.sum(axis=0), sum_y2[0].cpu().numpy().astype(np.float64)


def multirun_calls_device(gamma_logits, threshold, cells=None):
    """Threshold-argmax clone calls for every restart lane at once, on the
    device that holds the logits: softmax -> (argmax, max) -> threshold (NaN
    rows read unassigned, as in :func:`clone_assignment`), plus per-lane
    per-label counts.

    Returns ``(called, counts)`` as numpy arrays: ``called[r, n]`` in
    ``0..C`` with ``C`` meaning unassigned; ``counts[r, label]`` over the
    ``C + 1`` labels. On a mesh (``cells``) the logits are this rank's
    cells, and so are the calls; the counts are every rank's.
    """
    gl = torch.as_tensor(gamma_logits)
    probs = torch.softmax(gl, dim=-1)
    maxp, best = torch.max(probs, dim=-1)
    n_clones = gl.shape[-1]
    # compare in the logits dtype, as the host path does
    t = torch.tensor(threshold, dtype=gl.dtype, device=gl.device)
    called = torch.where(maxp >= t, best, n_clones)
    counts = all_sum(torch.nn.functional.one_hot(called, n_clones + 1).sum(dim=-2), cells)
    return called.to(torch.int32).cpu().numpy(), counts.to(torch.int32).cpu().numpy()


def compute_correlations(Y, L, clones, clone_names, device_Y=None, clones_idx=None, dtype=None,
                         blocks=None, cells=None, genes=None):
    """Per-gene Pearson correlation between expression and the copy number of
    each cell's assigned clone (reference R/clonealign.R:318-334; Pearson is
    affine-invariant, so correlating raw counts matches the reference's
    z-scored version, including the NaN for zero-variance genes). Unassigned
    cells are dropped.

    All sums aggregate by clone, so the computation is O(C x G) plus one
    pass over Y. Pass the device copy of the counts as ``device_Y`` (the fit
    entry points do) and that pass runs on its device; otherwise it runs on
    the host, over a dense matrix in row chunks or over a scipy sparse
    matrix's CSR without densifying it (reference assign.py:212-262).

    ``clones_idx`` is the integer form of ``clones`` (values in ``0..C-1``;
    anything else reads unassigned). When given, ``clones`` is ignored.
    ``dtype`` is the fit's compute dtype: float64 keeps the device sums in
    float64 whatever type ``device_Y`` is stored in. ``device_Y`` may also
    be a row source that uploads ``device_Y[i:j]`` (a streaming fit's), read
    in the row ``blocks`` given, and ``Y`` then anything that gives the
    columns ``Y[:, genes]``.

    On a mesh (``cells``, with ``device_Y``) ``Y``, ``device_Y`` and the
    clones are this rank's cells, and every sum is every rank's (the host
    sums of the guard below too), so each rank returns the same values.
    With ``genes`` ``Y``, ``L`` and ``device_Y`` are this rank's gene block
    (of its cells): each rank correlates its block, whose ranks share the
    same sums, and the values are gathered over the genes group, so every
    rank returns every gene's.
    """
    sparse = _is_scipy_sparse(Y)
    L = np.asarray(L, np.float64)
    C = len(clone_names)
    if clones_idx is not None:
        idx_all = np.asarray(clones_idx)
        keep = (idx_all >= 0) & (idx_all < C)
        idx_full = np.where(keep, idx_all, -1)
    else:
        clones = np.asarray([str(c) for c in clones], dtype=object)
        keep = clones != UNASSIGNED
        col_idx = {str(c): i for i, c in enumerate(clone_names)}
        idx_full = np.asarray(
            [col_idx[c] if k else -1 for c, k in zip(clones, keep)]
        )
    m = all_sum(np.bincount(idx_full[keep], minlength=C).astype(np.float64), cells)  # per clone
    M = int(m.sum())
    G = Y.shape[1] if device_Y is None else device_Y.shape[1]
    if M < 2:
        return np.full(G if genes is None else genes.g, np.nan)

    if device_Y is not None:
        S, sum_y, sum_y2 = _clone_sums_device(device_Y, idx_full, C, dtype, blocks, cells)
        # Cancellation guard: var_y = sum_y2 - sum_y^2/M subtracts two
        # near-equal numbers for a near-constant high-mean gene, amplifying
        # the float32 error of the device sums. Genes whose variance is a
        # tiny fraction of sum_y2 are recomputed exactly on the host from
        # their columns.
        with np.errstate(invalid="ignore"):
            var_pre = sum_y2 - sum_y * sum_y / M
        suspect = np.flatnonzero((sum_y2 > 0) & ~(var_pre > 1e-3 * sum_y2))
        if suspect.size:
            cols = Y.tocsr()[:, suspect].toarray() if sparse else np.asarray(Y[:, suspect])
            cols = cols.astype(np.float64)[keep]
            ib = idx_full[keep]
            sums = np.stack([cols.sum(axis=0), (cols * cols).sum(axis=0)]
                            + [cols[ib == c].sum(axis=0) for c in range(C)])
            sums = all_sum(sums, cells)
            sum_y[suspect], sum_y2[suspect], S[:, suspect] = sums[0], sums[1], sums[2:]
    elif sparse:
        import scipy.sparse as sp

        Yk = Y.tocsr()[keep].astype(np.float64)
        sum_y = np.asarray(Yk.sum(axis=0)).ravel()
        sum_y2 = np.asarray(Yk.multiply(Yk).sum(axis=0)).ravel()
        ind = sp.csr_matrix((np.ones(M), (idx_full[keep], np.arange(M))), shape=(C, M))
        S = (ind @ Yk).toarray()
    else:
        sum_y = np.zeros(G)
        sum_y2 = np.zeros(G)
        S = np.zeros((C, G))
        rows = _host_row_chunk(G)
        N = Y.shape[0]
        for i in range(0, N, rows):
            blk = np.asarray(Y[i : i + rows], np.float64)
            kb = keep[i : i + rows]
            if not kb.all():
                blk = blk[kb]
            sum_y += blk.sum(axis=0)
            sum_y2 += (blk * blk).sum(axis=0)
            ib = idx_full[i : i + rows][kb]
            for c in range(C):
                sel = ib == c
                if sel.any():
                    S[c] += blk[sel].sum(axis=0)

    # x_ng = L[g, clone(n)]: sums aggregate over clones
    sum_x = L @ m
    sum_x2 = (L * L) @ m
    cross = np.einsum("cg,gc->g", S, L)

    num = cross - sum_x * sum_y / M
    var_x = sum_x2 - sum_x * sum_x / M
    var_y = sum_y2 - sum_y * sum_y / M
    den = np.sqrt(np.maximum(var_x, 0) * np.maximum(var_y, 0))
    with np.errstate(divide="ignore", invalid="ignore"):
        out = num / den
    out[den == 0] = np.nan
    return gather_cols(out, genes)

"""Streaming fit: the full-batch clonealign fit for count matrices that do
not fit on the card, with only Y streamed (counterpart of
``clonealign_tpu/stream.py``).

* **Y streams** through the device one chunk of cells at a time, from the
  host array it was given (dense, ``np.memmap`` or scipy sparse; each chunk
  is read from it when needed, so a memmap is never loaded whole).
* **Everything else stays on the device**: the per-cell variational state
  (psi, gamma logits) and its Adam moments, the per-cell statistics (s, log
  binomials, Y log L), the covariates and the allele term: O(N (K + C)).

The math is the in-core full-batch algorithm. The ELBO splits into per-cell
and global terms (``models/multinomial.elbo_cell_terms`` /
``elbo_global_terms``); each step evaluates the per-cell part chunk by
chunk at the step's one (S, G) draw and sums. Adam is elementwise, so the
per-cell parameters step chunk by chunk with the global step count, and the
shared parameters step once from the summed gradients. The draws come from
the same ``Noise`` in the in-core order ("pca_omega", "psi_jitter", "warm",
"init_eval", per step "train" and with ``elbo_eval="fresh"`` "eval", then
"final"), so a streamed fit replays the in-core fit with the same seed up to
the order of the sums across chunk boundaries.

On CUDA the exact likelihood is the fused kernels (``_likelihood_terms``):
every warm-start, ELBO and training evaluation launches the forward kernel
once per chunk, and each training step the backward kernels once per
chunk. Chunks travel in Y's storage type (``y_storage``, int8 where the
counts fit) from two pinned host buffers into two device buffers
(:class:`_ChunkFeeder`): the copy of chunk c + 1 is queued on a side
stream, ordered by events, before chunk c's work, and runs beside it. The
statistics come from ``prepare_data``'s own row loop without a device Y,
and the parsing, checks and packaging are the in-core fit's (``api``'s
helpers, ``infer.Monitor``). An evaluation of several draws
(the final ELBO's 20) uploads each chunk once.

Differences from the in-core path, by design (as in the reference):
``elbo_eval`` defaults to "reuse" (one pass over Y a step; "fresh" makes a
second); under z_cheb the Chebyshev table is fitted to each chunk's psi.

On a mesh (``mesh``) each rank streams its own block of rows in chunks,
with a genes axis only its gene block's columns of them: its chunks'
value and shared gradients are summed over the cell blocks by one
all_reduce a step before the global terms are added and the shared
parameters step, and the statistics, the init passes, the evaluations and
the packaging take every rank's sums, as the in-core fit on a mesh does.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from .api import (
    _check_host_counts,
    _check_reference_keywords,
    _check_statistics,
    _colsum_f64,
    _device_validated,
    _model_config,
    _mu_init_switch,
    _package_fit,
    _parse_inputs,
    _resolve_storage,
    _retained_genes,
    _setup_allele,
)
from .fit import ClonealignFit
from .infer import InferenceResult, Monitor, TF1Adam, _upload, final_config, gene_draws
from .models import multinomial as mm
from .parallel.collectives import CELL_AXIS, all_sum, block_of, check_mesh, gene_block
from .utils.device import resolve_device, resolve_dtype, synchronize
from .utils.noise import Noise
from .utils.sparsity import is_scipy_sparse as _is_scipy_sparse

# The passes over Y outside the kernels (the statistics, the PCA and the mu
# guess) convert row blocks of at most this many elements to the compute
# dtype (64 MB at float32), so that the streaming fit's device peak stays
# below Y's own bytes at int8 from ~10^8 elements up.
_AUX_ELEMENTS = 1 << 24

# the fit's parameters shared by every cell, and the per-cell ones (those
# split along the cells on a mesh)
_SHARED = tuple(f for f, spec in vars(mm.param_specs()).items() if CELL_AXIS not in spec)
_CELL = tuple(f for f, spec in vars(mm.param_specs()).items() if CELL_AXIS in spec)


class _RowSource:
    """Row-sliceable view of the gene-filtered count matrix (reference
    stream.py:201-228): ``src[i:j]`` gives ``Y[i:j][:, kept]`` as a numpy
    array on demand, so a memmap or a CSR is never copied whole;
    ``src[:, genes]`` gives columns of the filtered matrix. ``cols``, a
    slice of the kept columns, restricts it to a rank's gene block. Kept
    columns that lie side by side are read as a slice, so a dense block is
    a view of the input's rows (of a memmap, of the map itself)."""

    def __init__(self, Y, keep_cols, cols: Optional[slice] = None):
        self._Y = Y
        self._sparse = _is_scipy_sparse(Y)
        kept = np.arange(Y.shape[1]) if keep_cols is None else np.flatnonzero(keep_cols)
        if cols is not None:
            kept = kept[cols]
        self._kept = kept
        side_by_side = kept.size and kept[-1] - kept[0] + 1 == kept.size
        self._cols = slice(int(kept[0]), int(kept[-1]) + 1) if side_by_side else kept
        if kept.size == Y.shape[1]:  # every column: the rows as they are
            self._cols = None
        self.shape = (Y.shape[0], kept.size)
        self.dtype = Y.dtype

    def __getitem__(self, sl) -> np.ndarray:
        if isinstance(sl, tuple):  # (rows, columns of the filtered matrix)
            rows, cols = sl
            blk = self._Y[rows][:, self._kept[cols]]
            return blk.toarray() if self._sparse else np.asarray(blk)
        blk = self._Y[sl] if self._cols is None else self._Y[sl][:, self._cols]
        return blk.toarray() if self._sparse else np.asarray(blk)

    def tensor(self, i, j) -> torch.Tensor:
        """Rows i:j as a CPU tensor in the input dtype, over the rows' view
        where there is one: a read-only memmap's rows are not copied, since
        every reader (``_ChunkFeeder``'s copy into its pinned buffer, the
        statistics' conversion) only reads them."""
        blk = self[i:j]
        if blk.flags.writeable:
            return torch.from_numpy(blk)
        with warnings.catch_warnings():  # PyTorch warns of a tensor it may not write
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(blk)


def _chunk_bounds(N: int, chunk: int):
    return [(i, min(i + chunk, N)) for i in range(0, N, chunk)]


def _resolve_chunk_cells(chunk_cells, N: int, G: int) -> int:
    """``chunk_cells`` as a row count: "auto" (or None) takes
    ``max(1024, 2**26 // G)`` cells, about 256 MB of float32 (reference
    stream.py:235-244); never more than N."""
    if chunk_cells is None or chunk_cells == "auto":
        chunk = max(1024, (1 << 26) // max(G, 1))
    else:
        chunk = int(chunk_cells)
    if chunk <= 0:
        raise ValueError(f"chunk_cells must be positive, got {chunk_cells!r}")
    return min(chunk, N)


class _DeviceRows:
    """The row source the passes over host Y read a block at a time (the
    PCA and the mu guess, ``models/multinomial``'s ``_pca_scores_blocked``
    and ``data_mu_guess``; the correlations; ``serve``'s scoring):
    ``rows[i:j]`` uploads rows i:j of ``src`` to ``device`` in the storage
    type ``store``, from pinned memory."""

    def __init__(self, src: _RowSource, store, device):
        self.src, self.store, self.device = src, store, device
        self.shape = src.shape

    def __getitem__(self, sl):
        return _upload(self.src.tensor(sl.start, sl.stop).to(self.store), self.device)


class _ChunkFeeder:
    """The chunks of Y on the device, one after another, in the storage type
    ``store``. Each chunk is converted on the host (PyTorch's CPU kernels)
    into one of two pinned buffers and copied into one of two device
    buffers. On CUDA the copy runs on a side stream and is queued one chunk
    ahead: chunk c + 1 is converted and its copy queued before chunk c is
    handed out, so the copy runs while chunk c's work is queued and runs.
    The copy waits for the work that last read its device buffer (an event
    recorded after chunk c - 1's work was queued), and chunk c's work waits
    for its copy (another event). On the CPU the host buffer is the chunk.

    ``marks``, when set to a list, collects timing events for each sweep:
    ``{"copy": [(start, end), ...], "compute": [(start, end), ...]}``, the
    copies on the side stream and each chunk's work on the compute stream,
    from the moment its copy has landed to the end of the work queued for
    it."""

    def __init__(self, src: _RowSource, bounds, store, device):
        self.src, self.bounds, self.device = src, bounds, device
        self.cuda = device.type == "cuda"
        rows = max(j - i for i, j in bounds)
        shape = (rows, src.shape[1])
        self.host = [torch.empty(shape, dtype=store, pin_memory=self.cuda) for _ in range(2)]
        self.dev = ([torch.empty(shape, dtype=store, device=device) for _ in range(2)]
                    if self.cuda else self.host)
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.copied = [None, None]  # the copy into buffer b has finished
        self.used = [None, None]    # the work that reads buffer b is queued up to here
        self.marks = None

    def _event(self, stream=None):
        ev = torch.cuda.Event(enable_timing=self.marks is not None)
        ev.record(stream)
        return ev

    def _fill(self, c):
        b = c % 2
        i, j = self.bounds[c]
        if self.copied[b] is not None:
            self.copied[b].synchronize()  # the last copy out of host[b] is done
        self.host[b][: j - i].copy_(self.src.tensor(i, j))
        if self.cuda:
            with torch.cuda.stream(self.stream):
                if self.used[b] is not None:
                    self.stream.wait_event(self.used[b])
                start = self._event(self.stream) if self.marks is not None else None
                self.dev[b][: j - i].copy_(self.host[b][: j - i], non_blocking=True)
                self.copied[b] = self._event(self.stream)
            if start is not None:
                self.marks[-1]["copy"].append((start, self.copied[b]))

    def sweep(self):
        """Yield ``(c, y)`` for every chunk c, y its (rows, G) device tensor,
        valid until the caller asks for the next chunk: queue all work that
        reads y (a backward too) before then."""
        if self.marks is not None:
            self.marks.append({"copy": [], "compute": []})
        self._fill(0)
        for c in range(len(self.bounds)):
            if c + 1 < len(self.bounds):
                self._fill(c + 1)
            b = c % 2
            i, j = self.bounds[c]
            if self.cuda:
                torch.cuda.current_stream(self.device).wait_event(self.copied[b])
                start = self._event() if self.marks is not None else None
            yield c, self.dev[b][: j - i]
            if self.cuda:
                self.used[b] = self._event()
                if start is not None:
                    self.marks[-1]["compute"].append((start, self.used[b]))


def fit_streaming(
    gene_expression_data,
    copy_number_data,
    chunk_cells=None,
    max_iter: int = 200,
    rel_tol: float = 1e-6,
    gene_filter_threshold: float = 0,
    learning_rate: float = 0.1,
    x=None,
    clone_allele=None,
    cov=None,
    ref=None,
    fix_alpha: bool = False,
    dtype: str = "float32",
    saturate: bool = True,
    saturation_threshold: float = 6,
    K: Optional[int] = None,
    mc_samples: int = 1,
    verbose: bool = True,
    initial_shrink: float = 5,
    clone_call_probability: float = 0.95,
    data_init_mu=True,
    seed: Optional[int] = None,
    key=None,
    elbo_eval: str = "reuse",
    y_storage: Optional[str] = "auto",
    likelihood_impl: str = "auto",
    window_size: int = 10,
    n_final_elbo_samples: int = 20,
    mesh=None,
    allow_fractional: bool = False,
    *,
    device="cuda",
    noise=None,
) -> ClonealignFit:
    """:func:`~clonealign_torch.clonealign` for count matrices larger than
    the card: the same model, optimizer and arguments (the JAX package's
    ``fit_streaming``), with Y streamed through the card ``chunk_cells``
    cells at a time (module docstring). ``chunk_cells`` is a positive count
    or "auto" / None (:func:`_resolve_chunk_cells`).

    ``gene_expression_data`` may be a dense array, an ``np.memmap`` or a
    scipy sparse matrix (a CSR with duplicate entries is read by its summed
    counts). ``device`` is "cuda" (default) or "cpu"; ``noise`` (a
    :class:`~clonealign_torch.utils.noise.Noise`, by default seeded with
    ``seed`` or 0) makes every draw. ``key`` (a JAX PRNG key) is refused,
    and ``likelihood_impl="fused"`` raises as in the JAX package. The fit's
    ``timings`` hold the wall seconds of its phases, as ``clonealign``'s.

    ``mesh`` (:func:`clonealign_torch.parallel.sharding.make_mesh`) splits
    the cells, and with ``gene_parallelism`` the kept genes, over its ranks
    (module docstring): every rank passes the whole input, streams its
    block of rows, of them its gene block's columns, ``chunk_cells`` at a
    time on the mesh's device (``device`` is not read), and returns the fit
    the one-process call gives (clonealign_tpu/stream.py:419-444).
    """
    _check_reference_keywords(key, "while")
    if mesh is not None:
        device = check_mesh(mesh).device
    if elbo_eval not in ("fresh", "reuse"):
        raise ValueError(f"elbo_eval must be 'fresh' or 'reuse', got {elbo_eval!r}")
    if likelihood_impl == "fused":
        raise ValueError(
            "likelihood_impl='fused' was retired (docs/design.md §2b); "
            "use 'auto', 'xla', or 'z_cheb'"
        )
    t0 = time.perf_counter()
    dev = resolve_device(device)
    dt = resolve_dtype(dtype, dev)
    K = 1 if K is None else int(K)  # reference R/clonealign.R:226-232
    Y, gene_names, L, clone_names, x, P = _parse_inputs(
        gene_expression_data, copy_number_data, x, K, mc_samples, fix_alpha, y_storage,
        likelihood_impl, verbose)
    cells = block_of(mesh, Y.shape[0])
    if cells is not None:
        Y = Y[cells.start : cells.stop]
        x = None if x is None else x[cells.start : cells.stop]
    N = Y.shape[0]
    sparse = _is_scipy_sparse(Y)

    # --- the gene filter (the in-core fit's, on the host): a dense matrix
    # is filtered row block by row block as it is read, a CSR's columns are
    # sliced once ---
    low = all_sum(_colsum_f64(Y), cells) <= gene_filter_threshold
    retained_genes = _retained_genes(gene_names, low, verbose)
    L = L[~low]
    if sparse and low.any():
        Y = Y[:, ~low]
        low = np.zeros(Y.shape[1], bool)
    device_validated = _device_validated(Y)
    _check_host_counts(Y if sparse else _RowSource(Y, ~low), device_validated, allow_fractional,
                       K, cells)
    n_genes = L.shape[0]
    genes = gene_block(mesh, n_genes)
    cols = None if genes is None else slice(genes.start, genes.stop)
    src = _RowSource(Y, ~low, cols)
    G = src.shape[1]
    if cols is not None:
        L = L[cols]
    if saturate:
        L = np.minimum(L, float(saturation_threshold))
    n_cells = N if cells is None else cells.n
    extra, clone_probs_from_snv = _setup_allele(clone_allele, cov, ref, n_cells, L.shape[1], dt,
                                                dev, verbose, cells)
    storage = _resolve_storage(y_storage, Y, cells, genes)
    store = dt if storage is None else storage
    config = _model_config(K, P, mc_samples, fix_alpha, likelihood_impl, dt, n_cells * n_genes)
    chunk = _resolve_chunk_cells(chunk_cells, N, G)
    bounds = _chunk_bounds(N, chunk)
    if verbose:
        print(f"Streaming {N} cells x {G} genes in {len(bounds)} chunks of {chunk} "
              f"({mm._storage_name(store)} transfer)")

    # --- the statistics (prepare_data's row loop without a device Y), in
    # blocks of _AUX_ELEMENTS ---
    aux = _chunk_bounds(N, max(1, _AUX_ELEMENTS // max(G, 1)))
    stats = mm._prepare_rows(src, L, x, src.tensor, device=dev, dtype=dt, y_storage=storage,
                             check_feasible=False, blocks=aux, with_y=False, cells=cells,
                             genes=genes)
    _check_statistics(stats, device_validated)

    # --- init (mm.init_params, the in-core draws in the in-core order):
    # above _CHUNK_ELEMENTS the PCA and the mu guess read the host rows
    # block by block, below it Y goes to the device whole, as in-core ---
    if noise is None:
        noise = Noise(0 if seed is None else int(seed), dev)
    data_init_mu = _mu_init_switch(data_init_mu)
    rows = _DeviceRows(src, store, dev)
    synchronize(dev)
    t1 = time.perf_counter()
    if cells is not None or N * G > mm._CHUNK_ELEMENTS:
        pcs = (mm._standardize(mm._pca_scores_blocked(rows, K, noise, dt, blocks=aux,
                                                      cells=cells, genes=genes),
                               dim=0, cells=cells)
               if K > 0 else None)
        mu_guess = (mm.data_mu_guess(rows, dt, blocks=aux, cells=cells, genes=genes)
                    if data_init_mu is True else None)
        params0 = mm.init_params(rows, stats.L, noise, K=K, data_init_mu=data_init_mu,
                                 dtype=dt, pca_scores=pcs, mu_guess=mu_guess, P=P, cells=cells,
                                 genes=genes)
    else:
        params0 = mm.init_params(rows[0:N], stats.L, noise, K=K, data_init_mu=data_init_mu,
                                 dtype=dt, P=P)
    synchronize(dev)
    t2 = time.perf_counter()

    feeder = _ChunkFeeder(src, bounds, store, dev)

    def chunk_data(c, y):
        i, j = bounds[c]
        return mm.ModelData(Y=y, L=stats.L, s=stats.s[i:j], log_binom=stats.log_binom[i:j],
                            YlogL=stats.YlogL[i:j], colsum_Y=None,
                            X=None if stats.X is None else stats.X[i:j], genes=genes)

    def chunk_extra(c):
        i, j = bounds[c]
        return None if extra is None else extra[i:j]

    shared = {f: getattr(params0, f).detach().clone().requires_grad_(True) for f in _SHARED}
    chunk_params = [{f: getattr(params0, f)[i:j].detach().clone().requires_grad_(True)
                     for f in _CELL} for i, j in bounds]
    del params0

    def params_of(c):
        return mm.CloneAlignParams(**shared, **chunk_params[c])

    def draw(what):
        return gene_draws([noise], config.mc_samples, G, dt, dev, genes)(what, [0])[0]

    # the ranks of cell block 0 add the global terms to their chunks' sums
    # (in one process, the ELBO), and the all_reduce after the chunks sums
    # every cell block's
    owns_global = cells is None or cells.mesh.cell_coord == 0

    def evaluate(eps_list, eval_config):
        """The ELBO at each draw of ``eps_list``: the global terms plus every
        chunk's cell terms (on a mesh every rank's), each chunk uploaded
        once."""
        with torch.no_grad():
            bases = [mm.sample_mu_base(params_of(0), e) for e in eps_list]
            tot = torch.stack([mm.elbo_global_terms(params_of(0), b, eval_config,
                                                    stats.colsum_Y, genes) for b in bases])
            if not owns_global:
                tot = torch.zeros_like(tot)
            for c, y in feeder.sweep():
                data = chunk_data(c, y)
                tot = tot + torch.stack([
                    mm.elbo_cell_terms(params_of(c), data, b, eval_config, chunk_extra(c))
                    for b in bases])
        return all_sum(tot, cells)

    # --- warm start and the initial ELBO (infer.run_inference_lanes) ---
    if verbose:
        print("Optimizing ELBO")  # reference R/inference-tflow.R:383
    eps = draw("warm")
    with torch.no_grad():
        for c, y in feeder.sweep():
            warm = mm.gamma_warm_start_logits(params_of(c), chunk_data(c, y), eps,
                                              float(initial_shrink), config, chunk_extra(c))
            chunk_params[c]["gamma_logits"].copy_(warm)
    np_dtype = np.float64 if dt == torch.float64 else np.float32
    mon = Monitor(evaluate([draw("init_eval")], config)[:1].cpu().numpy(), int(max_iter),
                  float(rel_tol), int(window_size), np_dtype)

    # --- the Adam loop: per chunk, the cell terms' value and gradients and
    # the chunk's own Adam step; then the global terms and one step of the
    # shared parameters from the summed gradients (on a mesh, the chunks'
    # sums every rank's, by one all_reduce) ---
    lr = float(learning_rate)
    shared_opt = TF1Adam(list(shared.values()), lr)
    cell_opts = [TF1Adam(list(cell.values()), lr) for cell in chunk_params]
    synchronize(dev)
    t_loop = time.perf_counter()
    while mon.live()[0]:
        eps = draw("train")
        base = mm.sample_mu_base(params_of(0), eps)
        value = mm.elbo_global_terms(params_of(0), base, config, stats.colsum_Y, genes)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            shared.values(), torch.autograd.grad(-value, list(shared.values()), allow_unused=True))]
        value = value.detach()
        if not owns_global:
            value, grads = torch.zeros_like(value), [torch.zeros_like(g) for g in grads]
        for c, y in feeder.sweep():
            leaves = list(shared.values()) + list(chunk_params[c].values())
            val = mm.elbo_cell_terms(params_of(c), chunk_data(c, y),
                                     mm.sample_mu_base(params_of(c), eps), config, chunk_extra(c))
            g = torch.autograd.grad(-val, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)]
            for acc, gi in zip(grads, g[: len(shared)]):
                acc += gi
            cell_opts[c].step(list(chunk_params[c].values()), g[len(shared):])
            value = value + val.detach()
        flat = all_sum(torch.cat([g.reshape(-1) for g in grads] + [value.reshape(1)]), cells)
        pieces = flat.split([g.numel() for g in grads] + [1])
        grads = [p.view_as(g) for g, p in zip(grads, pieces)]
        value = pieces[-1][0]
        shared_opt.step(list(shared.values()), grads)
        if elbo_eval == "fresh":
            value = evaluate([draw("eval")], config)[0]
        mon.record([0], value.reshape(1).cpu().numpy())  # the iteration's one host sync
        if verbose and mon.i[0] % 50 == 0:
            print(f"  iter {mon.i[0]:4d}  elbo {float(mon.elbo[0]):.4f}  "
                  f"mean|d| {float(np.mean(np.abs(mon.window[0]))):.3e}")
    synchronize(dev)
    loop_seconds = time.perf_counter() - t_loop

    # --- the final ELBO: mean and sd of fresh draws ---
    finals = evaluate([draw("final") for _ in range(int(n_final_elbo_samples))],
                      final_config(config))
    if verbose:
        print("ELBO converged or reached max iterations")  # R/inference-tflow.R:420
    synchronize(dev)
    t3 = time.perf_counter()

    params = mm.CloneAlignParams(
        **{f: t.detach() for f, t in shared.items()},
        **{f: torch.cat([cell[f].detach() for cell in chunk_params]) for f in _CELL})
    result = InferenceResult(params=params, elbo_trace=mon.trace[0], n_iters=int(mon.i[0]),
                             final_elbo=float(torch.mean(finals)),
                             sd_final_elbo=float(torch.std(finals, correction=1)),
                             loop_seconds=loop_seconds)
    fit = _package_fit(result, src, L, clone_names, retained_genes, config,
                       clone_call_probability, clone_probs_from_snv, device_Y=rows,
                       device_s=stats.s, blocks=aux, cells=cells, genes=genes)
    fit.timings = {"setup": t1 - t0, "init": t2 - t1, "inference": t3 - t2,
                   "loop": loop_seconds, "package": time.perf_counter() - t3}
    return fit

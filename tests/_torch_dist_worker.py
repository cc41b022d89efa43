"""One rank of the CPU runs of tests/test_torch_distributed.py.

Run as ``python tests/_torch_dist_worker.py RANK WORLD PORT INPUTS.npz
OUT.npz [GENES]``: it joins a gloo process group on 127.0.0.1:PORT (a 60 s
timeout, so that a collective one rank never reaches fails), runs every
mode of the distributed fit on the inputs the test wrote, and saves this
rank's results. With GENES (2 for the four-rank run) the mesh is
``(WORLD // GENES) x GENES`` and the modes are the genes axis's. It imports
clonealign_torch and never jax: the test holds the results against the
port's one-process fits and the JAX package.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from clonealign_torch import api, restarts
from clonealign_torch.models import multinomial as mm
from clonealign_torch.parallel import distributed as dist
from clonealign_torch.parallel import sharding
from clonealign_torch.parallel.collectives import (agree, all_sum, block_of, cells_of,
                                                   gene_block)
from clonealign_torch.utils.noise import Noise

# the keywords both sides of each comparison share (the test imports them)
SWEEP = dict(initial_shrinks=(0.0, 5.0, 10.0), dtype="float64", max_iter=30, rel_tol=1e-4)
JAX_SWEEP = dict(n_restarts=2, max_iter=15, rel_tol=1e-8)
RUN = dict(initial_shrinks=(0, 5), n_repeats=1, max_iter=20, seed=1, dtype="float64",
           verbose=False, print_elbos=False)
STREAM = dict(chunk_cells=8, max_iter=15, rel_tol=1e-8, dtype="float64", seed=2, verbose=False)
NEGBIN = dict(max_iter=150, rel_tol=1e-9, dtype="float64")
NEGBIN_RESUME = dict(max_iter=5, rel_tol=1e-9)  # two chained runs of the 2 x 2 v1 fit
GENE_FILTER_THRESHOLD = 2
GENES = 2  # the gene blocks of the four-rank run's 2 x 2 mesh
OP_LANES, OP_S = 2, 2  # the fused op's check on gene blocks: lanes and mu samples


class NpzNoise(Noise):
    """The draws of lane ``r`` of the JAX package's sweep, in the order the
    port asks for them, from the arrays the test wrote: ``{prefix}{r}_{what}``
    holds every draw of that kind, one after another."""

    def __init__(self, z, r, prefix="jax"):
        self.z, self.r, self.prefix, self.used = z, r, prefix, {}

    def normal(self, what, shape, dtype, device):
        k = self.used.get(what, 0)
        self.used[what] = k + 1
        name = f"{self.prefix}{self.r}_{what}"
        draw = self.z[name] if what in ("pca_omega", "psi_jitter") else self.z[name][k]
        return torch.tensor(draw, dtype=dtype, device=device).reshape(tuple(shape))


def cheb_params(psi, W):
    """Parameters holding only what the Chebyshev normalizer reads."""
    fields = {f: None for f in vars(sharding.param_specs())}
    return mm.CloneAlignParams(**dict(fields, psi=psi, W=W))


def _sweep_out(out, prefix, result, cells):
    out[f"{prefix}_final_elbo"] = result.final_elbo
    out[f"{prefix}_n_iters"] = result.n_iters
    out[f"{prefix}_trace"] = result.elbo_trace
    out[f"{prefix}_gamma_logits"] = result.params.gamma_logits.numpy()
    out[f"{prefix}_psi"] = result.params.psi.numpy()
    out[f"{prefix}_qmu_loc"] = result.params.qmu_loc.numpy()
    out[f"{prefix}_rows"] = np.array([cells.start, cells.stop])


def _fit_out(out, prefix, fit):
    out[f"{prefix}_clone"] = np.array(fit.clone)
    out[f"{prefix}_elbo"] = fit.convergence_info.elbo
    out[f"{prefix}_final_elbo"] = fit.convergence_info.final_elbo
    out[f"{prefix}_correlations"] = fit.correlations
    out[f"{prefix}_retained"] = np.array([str(g) for g in fit.retained_genes])
    for name, value in fit.ml_params.items():
        out[f"{prefix}_ml_{name}"] = value
    if fit.clone_probs_from_snv is not None:
        out[f"{prefix}_snv"] = fit.clone_probs_from_snv
    if fit.multirun_info is not None:
        info = fit.multirun_info
        out[f"{prefix}_multirun"] = json.dumps({
            "elbos": [float(e) for e in info["elbos"]],
            "prevalences": info["clone_prevalences_at_different_shrinks"],
            "median_correlations": [float(v) for v in info["median_correlations"]],
            "best_run": int(info["best_run"])})


def sweeps(z, mesh, out, Y="Y", L="L", jax_prefix="jax", prefix="", jax_counts=None):
    """sharded_fit from the whole matrix, distributed_fit from the rank's
    rows, and sharded_fit on the JAX package's draws (``{jax_prefix}{r}_*``
    of the inputs, made on the counts ``jax_counts`` names, by default the
    same), each saved under ``{prefix}{mode}_*``."""
    Y, L = z[Y], z[L]
    cells = block_of(mesh, Y.shape[0])
    _sweep_out(out, prefix + "sharded", sharding.sharded_fit(Y, L, mesh, seed=3, **SWEEP), cells)
    local = Y[dist.process_cell_slice(Y.shape[0], mesh=mesh)]
    _sweep_out(out, prefix + "distributed", dist.distributed_fit(local, L, mesh, seed=3, **SWEEP),
               cells)

    # the JAX package's PCA scores and this rank's: equal up to the sign,
    # which the SVDs choose; the port's take the JAX package's sign
    port_pca = mm.pca_init_scores

    def aligned(Yd, K, noise, dtype=torch.float32, cells=None, genes=None):
        got = port_pca(Yd, K, noise, dtype, cells=cells, genes=genes)
        want = torch.tensor(z[f"{jax_prefix}_pca"][cells.start : cells.stop], dtype=dtype)
        sign = torch.sign(all_sum(torch.sum(got * want, dim=0), cells))
        out[prefix + "jax_pca_err"] = float(torch.max(torch.abs(got * sign - want)))
        return got * sign

    if jax_counts is not None:
        Y, L = z[jax_counts[0]], z[jax_counts[1]]
    mm.pca_init_scores = aligned
    try:
        noises = [NpzNoise(z, r, jax_prefix) for r in range(JAX_SWEEP["n_restarts"])]
        kw = {k: v for k, v in JAX_SWEEP.items() if k != "n_restarts"}
        result = sharding.sharded_fit(Y, L, mesh, noises=noises, dtype="float64", **kw)
    finally:
        mm.pca_init_scores = port_pca
    _sweep_out(out, prefix + "jax", result, cells)


def decisions(z, mesh, out):
    """The fits whose decisions read every cell, and the decisions
    themselves: the gene filter (genes with counts on one rank only), Y's
    storage (a count above int8's range on rank 1 only), the likelihood
    ("auto" made to pick z_cheb from the global N x G up) and the restart
    batching (a budget between the ranks' needs)."""
    import scipy.sparse as sp

    rich = dict(x=z["x"], clone_allele=z["clone_allele"], cov=z["cov"], ref=z["ref"],
                gene_filter_threshold=GENE_FILTER_THRESHOLD)
    fit = restarts.run_clonealign(sp.csr_matrix(z["Y_genes"]), z["L_genes"], mesh=mesh, **rich,
                                  **RUN)
    _fit_out(out, "rich", fit)
    ctx = api.setup_fit(sp.csr_matrix(z["Y_genes"]), z["L_genes"], mesh=mesh, device=mesh.device,
                        verbose=False, **rich)
    out["rich_storage"] = str(ctx.data.Y.dtype)
    out["rich_local_genes"] = ctx.data.Y.shape[1]

    Y2, L = z["Y_wide_counts"], z["L_odd"]
    N, G = Y2.shape
    resolve, budget = api._resolve_auto_impl, restarts.SWEEP_BUDGET_BYTES
    api._resolve_auto_impl = lambda K, S, dt, n_elements, P=0: (
        "z_cheb" if n_elements >= N * G else "xla")
    shares = [dist.process_cell_slice(N, r, mesh.world) for r in range(mesh.world)]
    needs = [restarts._sweep_bytes(s.stop - s.start, G, L.shape[1], 1, 1, 2, 8, "cpu", 2,
                                   z_cheb=True) for s in shares]
    restarts.SWEEP_BUDGET_BYTES = (min(needs) + max(needs)) // 2
    try:
        ctx = api.setup_fit(Y2, L, mesh=mesh, device=mesh.device, verbose=False, dtype="float64")
        out["cheb_storage"] = str(ctx.data.Y.dtype)
        out["cheb_impl"] = ctx.config.likelihood_impl
        out["cheb_batching"] = restarts._auto_restart_batching(
            ctx.data.Y.shape[0], G, L.shape[1], 1, 1, 2, 8, "cpu", ctx.data.Y.element_size(),
            z_cheb=True, cells=ctx.cells)
        # the Chebyshev normalizer at the test's psi (sorted: the ranks'
        # own ranges differ), W and mu sample
        rows = slice(ctx.cells.start, ctx.cells.stop)
        t = {name: torch.tensor(z[f"cheb_{name}"]) for name in ("psi", "W", "mu")}
        params = cheb_params(t["psi"][rows], t["W"])
        out["cheb_logz"] = mm._compute_logZ_cheb(params, ctx.data, t["mu"], 16).numpy()
        fit = restarts.run_clonealign(Y2, L, mesh=mesh, **RUN)
    finally:
        api._resolve_auto_impl, restarts.SWEEP_BUDGET_BYTES = resolve, budget
    _fit_out(out, "cheb", fit)


def streaming(z, mesh, out):
    from clonealign_torch.stream import fit_streaming

    _fit_out(out, "stream", fit_streaming(z["Y"], z["L"], mesh=mesh, **STREAM))


def negbin(z, mesh, out):
    for impl in ("exact", "cheb"):
        r = sharding.sharded_negbin_fit(z["Y_nb"], z["L_nb"], mesh,
                                        stats="cheb" if impl == "cheb" else None, **NEGBIN)
        out[f"nb_{impl}_rows"] = np.array([block_of(mesh, z["Y_nb"].shape[0]).start,
                                           block_of(mesh, z["Y_nb"].shape[0]).stop])
        out[f"nb_{impl}_trace"] = r.elbo_trace
        out[f"nb_{impl}_final_elbo"] = r.final_elbo
        out[f"nb_{impl}_n_iter"] = r.n_iter
        out[f"nb_{impl}_gamma"] = r.post.gamma.numpy()
        out[f"nb_{impl}_r"] = r.post.r.numpy()
        for name in r.params._fields:
            out[f"nb_{impl}_{name}"] = getattr(r.params, name).numpy()


def refusals(z, mesh, out):
    """Failures that every rank raises together: fewer cells than ranks
    (whole on every rank, and a rank given no rows of its own), and a check
    that fails on rank 1 only with an exception of no particular kind."""
    def outcome(fn):
        try:
            fn()
        except Exception as e:  # the test reads which exception each rank raised
            return f"{type(e).__name__}: {e}"
        return "returned"

    out["refuse_block"] = outcome(lambda: block_of(mesh, mesh.world - 1))
    out["refuse_fit"] = outcome(lambda: restarts.run_clonealign(z["Y"][:1], z["L"], mesh=mesh,
                                                                **RUN))
    out["refuse_local"] = outcome(lambda: cells_of(mesh, 3 if mesh.rank else 0))
    cells = block_of(mesh, z["Y"].shape[0])

    def fails_on_rank_1():
        if mesh.rank == 1:
            raise KeyError("rank 1's own failure")
        return "value"

    out["refuse_agree"] = outcome(lambda: agree(cells, fails_on_rank_1))
    out["agree_value"] = outcome(lambda: agree(cells, lambda: "value"))


# --- the four-rank run on a 2 x 2 mesh (GENES gene blocks) -------------------

def genes_sweeps(z, mesh, out):
    """sharded_fit and distributed_fit on the ragged gene split (47 genes:
    23 and 24 a block), and on the JAX package's draws at 48 genes (its
    mesh splits only evenly)."""
    sweeps(z, mesh, out, Y="Yg", L="Lg", jax_prefix="jg", prefix="g_", jax_counts=("Yg48", "Lg48"))
    out["g_local_genes"] = gene_block(mesh, z["Yg"].shape[1]).stop - \
        gene_block(mesh, z["Yg"].shape[1]).start


def genes_fits(z, mesh, out):
    """run_clonealign on a CSR stored int8 with covariates and the allele
    term, as lanes and one restart after another, and under z_cheb; the
    counts' last gene is filtered out before the kept 47 are split."""
    import scipy.sparse as sp

    rich = dict(x=z["xg"], clone_allele=z["clone_allele"], cov=z["covg"], ref=z["refg"])
    for batching in ("vmap", "map"):
        fit = restarts.run_clonealign(sp.csr_matrix(z["Yg_f"]), z["Lg_f"], mesh=mesh,
                                      restart_batching=batching, **rich, **RUN)
        _fit_out(out, f"g_rich_{batching}", fit)
    ctx = api.setup_fit(sp.csr_matrix(z["Yg_f"]), z["Lg_f"], mesh=mesh, device=mesh.device,
                        verbose=False, **rich)
    out["g_rich_storage"] = str(ctx.data.Y.dtype)
    out["g_rich_tile"] = np.array(ctx.data.Y.shape)
    _fit_out(out, "g_cheb", restarts.run_clonealign(z["Yg_f"], z["Lg_f"], mesh=mesh,
                                                    likelihood_impl="z_cheb", **RUN))
    from clonealign_torch.stream import fit_streaming

    _fit_out(out, "g_stream", fit_streaming(z["Yg_f"], z["Lg_f"], mesh=mesh, **STREAM))


def genes_negbin(z, mesh, out):
    """Both v1 loops, and the exact loop resumed from a first run's result
    (its per-gene fields whole, cut to the gene block for the second),
    beside the same iterations in one run."""
    negbin(z, mesh, out)
    for name in list(out):
        if name.startswith("nb_"):
            out["g_" + name] = out.pop(name)
    first = sharding.sharded_negbin_fit(z["Y_nb"], z["L_nb"], mesh, dtype="float64",
                                        **NEGBIN_RESUME)
    chained = sharding.sharded_negbin_fit(z["Y_nb"], z["L_nb"], mesh, dtype="float64",
                                          resume_from=first, **NEGBIN_RESUME)
    both = dict(NEGBIN_RESUME, max_iter=2 * NEGBIN_RESUME["max_iter"])
    one_run = sharding.sharded_negbin_fit(z["Y_nb"], z["L_nb"], mesh, dtype="float64", **both)
    out["g_nb_resume_trace"] = chained.elbo_trace
    out["g_nb_one_run_trace"] = one_run.elbo_trace
    out["g_nb_one_run_gamma"] = one_run.post.gamma.numpy()
    out["g_nb_resume_gamma"] = chained.post.gamma.numpy()
    out["g_nb_resume_r"] = chained.post.r.numpy()
    out["g_nb_resume_log_mu"] = chained.params.log_mu.numpy()
    out["g_nb_resume_nu"] = chained.opt_state.nu[0].numpy()


def op_params(z, rows=slice(None), cols=slice(None)):
    """The fused op's check's parameters, lanes first: psi's rows, W's and
    the mu samples' gene block, each a leaf."""
    def leaf(a):
        return torch.tensor(a, dtype=torch.float64, requires_grad=True)

    psi, W, mu = leaf(z["op_psi"][:, rows]), leaf(z["op_W"][:, cols]), leaf(z["op_mu"][..., cols])
    fields = {f: None for f in vars(sharding.param_specs())}
    params = mm.CloneAlignParams(**dict(fields, psi=psi, W=W,
                                        beta=torch.zeros(W.shape[:-1] + (0,), dtype=W.dtype)))
    return params, mu


def op_terms(z, data, impl, rows=slice(None), cols=slice(None)):
    """A1, A2, log Z of the fused op (or z_cheb's), a loss with fixed
    cotangents and its gradients with respect to psi, W and the mu
    samples."""
    params, mu = op_params(z, rows, cols)
    config = mm.ModelConfig(K=1, mc_samples=OP_S, likelihood_impl=impl)
    A1, A2, logZ = mm._likelihood_terms(params, data, mu, torch.log(mu), config)
    c = {k: torch.tensor(z[f"op_c{k}"]) for k in (1, 2, 3)}
    loss = (torch.sum(A1 * c[1][:, rows]) + torch.sum(A2 * c[2][:, rows])
            + torch.sum(logZ * c[3][..., rows]))
    grads = torch.autograd.grad(loss, [params.psi, params.W, mu])
    return [t.detach() for t in (A1, A2, logZ)] + list(grads)


def genes_op(z, mesh, out):
    """The exact op (its plain version on the CPU) and z_cheb's normalizer
    on this rank's tile, with the lane axis: values and gradients, the
    gene block's gradients summed over the cell blocks, beside the whole
    op's on one rank's view of every cell and gene."""
    whole = mm.prepare_data(z["Yg"], z["Lg"], device="cpu", dtype=torch.float64)
    tile = sharding.shard_data(whole, mesh)
    rows = slice(tile.cells.start, tile.cells.stop)
    cols = slice(tile.genes.start, tile.genes.stop)
    for impl in ("xla", "z_cheb"):
        got = op_terms(z, tile, impl, rows, cols)
        got[4], got[5] = all_sum(got[4], tile.cells), all_sum(got[5], tile.cells)
        want = op_terms(z, whole, impl)
        want = [want[0][:, rows], want[1][:, rows], want[2][..., rows], want[3][:, rows],
                want[4][:, cols], want[5][..., cols]]
        for name, g, w in zip(("A1", "A2", "logZ", "dpsi", "dW", "dmu"), got, want):
            out[f"g_op_{impl}_{name}"] = g.numpy()
            out[f"g_op_{impl}_{name}_want"] = w.numpy()


def genes_refusals(z, mesh, out):
    """Fewer kept genes than gene blocks: a ValueError on every rank."""
    def outcome(fn):
        try:
            fn()
        except Exception as e:  # the test reads which exception each rank raised
            return f"{type(e).__name__}: {e}"
        return "returned"

    Y = np.zeros((z["Yg"].shape[0], 3), np.int64)
    Y[:, 0] = 5  # two of the three genes have no counts: one is kept
    out["g_refuse_genes"] = outcome(lambda: restarts.run_clonealign(Y, z["Lg"][:3], mesh=mesh,
                                                                    **RUN))


def main():
    rank, world, port, inputs, path = sys.argv[1:6]
    genes = int(sys.argv[6]) if len(sys.argv) > 6 else 1
    torch.set_num_threads(1)
    dist.initialize(f"127.0.0.1:{port}", int(world), int(rank), backend="gloo",
                    timeout_seconds=60)
    try:
        mesh = sharding.make_mesh(devices="cpu", gene_parallelism=genes)
        out = {}
        with np.load(inputs) as z:
            z = dict(z)
        modes = ((sweeps, decisions, streaming, negbin, refusals) if genes == 1 else
                 (genes_sweeps, genes_fits, genes_negbin, genes_op, genes_refusals))
        for mode in modes:
            mode(z, mesh, out)
        np.savez(path, **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

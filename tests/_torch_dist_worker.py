"""One rank of the two-rank CPU runs of tests/test_torch_distributed.py.

Run as ``python tests/_torch_dist_worker.py RANK WORLD PORT INPUTS.npz
OUT.npz``: it joins a gloo process group on 127.0.0.1:PORT (a 60 s
timeout, so that a collective one rank never reaches fails), runs every
mode of the distributed fit on the inputs the test wrote, and saves this
rank's results. It imports clonealign_torch and never jax: the test holds
the results against the port's one-process fits and the JAX package.
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
from clonealign_torch.parallel.collectives import agree, all_sum, block_of, cells_of
from clonealign_torch.utils.noise import Noise

# the keywords both sides of each comparison share (the test imports them)
SWEEP = dict(initial_shrinks=(0.0, 5.0, 10.0), dtype="float64", max_iter=30, rel_tol=1e-4)
JAX_SWEEP = dict(n_restarts=2, max_iter=15, rel_tol=1e-8)
RUN = dict(initial_shrinks=(0, 5), n_repeats=1, max_iter=20, seed=1, dtype="float64",
           verbose=False, print_elbos=False)
STREAM = dict(chunk_cells=8, max_iter=15, rel_tol=1e-8, dtype="float64", seed=2, verbose=False)
NEGBIN = dict(max_iter=150, rel_tol=1e-9, dtype="float64")
GENE_FILTER_THRESHOLD = 2


class NpzNoise(Noise):
    """The draws of lane ``r`` of the JAX package's sweep, in the order the
    port asks for them, from the arrays the test wrote: ``jax{r}_{what}``
    holds every draw of that kind, one after another."""

    def __init__(self, z, r):
        self.z, self.r, self.used = z, r, {}

    def normal(self, what, shape, dtype, device):
        k = self.used.get(what, 0)
        self.used[what] = k + 1
        name = f"jax{self.r}_{what}"
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


def sweeps(z, mesh, out):
    """sharded_fit from the whole matrix, distributed_fit from the rank's
    rows, and sharded_fit on the JAX package's draws."""
    Y, L = z["Y"], z["L"]
    cells = block_of(mesh, Y.shape[0])
    _sweep_out(out, "sharded", sharding.sharded_fit(Y, L, mesh, seed=3, **SWEEP), cells)
    local = Y[dist.process_cell_slice(Y.shape[0])]
    _sweep_out(out, "distributed", dist.distributed_fit(local, L, mesh, seed=3, **SWEEP), cells)

    # the JAX package's PCA scores and this rank's: equal up to the sign,
    # which the SVDs choose; the port's take the JAX package's sign
    port_pca = mm.pca_init_scores

    def aligned(Yd, K, noise, dtype=torch.float32, cells=None):
        got = port_pca(Yd, K, noise, dtype, cells=cells)
        want = torch.tensor(z["jax_pca"][cells.start : cells.stop], dtype=dtype)
        sign = torch.sign(all_sum(torch.sum(got * want, dim=0), cells))
        out["jax_pca_err"] = float(torch.max(torch.abs(got * sign - want)))
        return got * sign

    mm.pca_init_scores = aligned
    try:
        noises = [NpzNoise(z, r) for r in range(JAX_SWEEP["n_restarts"])]
        kw = {k: v for k, v in JAX_SWEEP.items() if k != "n_restarts"}
        result = sharding.sharded_fit(Y, L, mesh, noises=noises, dtype="float64", **kw)
    finally:
        mm.pca_init_scores = port_pca
    _sweep_out(out, "jax", result, cells)


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


def main():
    rank, world, port, inputs, path = sys.argv[1:6]
    torch.set_num_threads(1)
    dist.initialize(f"127.0.0.1:{port}", int(world), int(rank), backend="gloo",
                    timeout_seconds=60)
    try:
        mesh = sharding.make_mesh(devices="cpu")
        out = {}
        with np.load(inputs) as z:
            z = dict(z)
        for mode in (sweeps, decisions, streaming, negbin, refusals):
            mode(z, mesh, out)
        np.savez(path, **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

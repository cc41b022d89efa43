"""End-to-end workflow on the PyTorch port: region-level CNV calls ->
gene-level matrix -> align with expression -> preprocess -> multi-restart
fit -> QC -> save -> serve a NEW cohort against the saved fit, through
``clonealign_torch`` (the steps of examples/full_workflow.py, which runs
the JAX package).

Run:  python examples/full_workflow_torch.py [--device cuda|cpu] [--small] [--out DIR]

``--device`` is "cuda" by default and raises without a card; ``--device cpu``
runs on the host. ``--small`` runs fewer iterations (the same cohorts:
600 cells fitted, 200 served). Writes full_workflow_torch_fit.npz to
``--out`` (default: the current directory).
"""

import argparse
import collections
import os

import numpy as np

from clonealign_torch import run_clonealign
from clonealign_torch.cnv import align_expression_to_cnv, cnv_regions_to_genes
from clonealign_torch.fit import ClonealignFit
from clonealign_torch.preprocess import preprocess_for_clonealign
from clonealign_torch.serve import assign_cells
from clonealign_torch.synth import assignment_accuracy
from clonealign_torch.utils.device import resolve_device


def simulate_inputs(rng, n_cells=800, n_genes=300, clones=("A", "B", "C")):
    """Region-level CNV calls + raw counts over named genes, like a user
    would have after scDNA CNV calling and scRNA quantification."""
    # --- genes on 3 chromosomes ---
    gene_ids = [f"gene_{i}" for i in range(n_genes)]
    gene_chr = np.repeat(["1", "2", "3"], n_genes // 3)
    gene_start = np.concatenate([
        np.sort(rng.integers(0, 5_000_000, n_genes // 3)) for _ in range(3)
    ])
    gene_end = gene_start + rng.integers(1_000, 50_000, n_genes)

    # --- region-level CNV segments per clone (5 segments per chromosome) ---
    rows = {"chr": [], "start": [], "end": [], "cn": [], "clone": []}
    bounds = np.linspace(0, 5_050_000, 6).astype(int)
    for chrom in ("1", "2", "3"):
        for clone in clones:
            for s, e in zip(bounds[:-1], bounds[1:]):
                rows["chr"].append(chrom)
                rows["start"].append(s)
                rows["end"].append(e)
                rows["cn"].append(int(rng.integers(1, 5)))
                rows["clone"].append(clone)

    gene_cnv = cnv_regions_to_genes(
        rows["chr"], rows["start"], rows["end"], rows["cn"], rows["clone"],
        gene_ids, gene_chr, gene_start, gene_end,
    )
    print(f"CNV mapping: {len(gene_cnv.gene_ids)} genes x "
          f"{len(gene_cnv.clone_names)} clones retained")

    # --- counts drawn from the clonealign generative model over those genes ---
    L = np.asarray(gene_cnv.copy_number)
    G = L.shape[0]
    mu = rng.lognormal(0, 0.5, G)
    z = rng.integers(0, len(clones), n_cells)
    rates = mu[None, :] * L[:, z].T
    probs = rates / rates.sum(axis=1, keepdims=True)
    totals = rng.poisson(2000, n_cells) + 1
    Y = np.stack([rng.multinomial(int(t), p) for t, p in zip(totals, probs)])
    # expression matrix carries ALL genes (some without CNV calls), shuffled
    order = rng.permutation(n_genes)
    Y_all = np.zeros((n_cells, n_genes))
    pos = {g: i for i, g in enumerate(gene_ids)}
    for j, g in enumerate(gene_cnv.gene_ids):
        Y_all[:, pos[g]] = Y[:, j]
    all_ids = list(np.asarray(gene_ids)[order])
    return Y_all[:, order], all_ids, gene_cnv, z


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--small", action="store_true", help="a small, quick configuration")
    parser.add_argument("--out", default=".", help="directory for the saved fit")
    args = parser.parse_args(argv)
    device = str(resolve_device(args.device))
    os.makedirs(args.out, exist_ok=True)
    max_iter = 100 if args.small else 200

    rng = np.random.default_rng(0)
    Y_all, all_gene_ids, gene_cnv, truth = simulate_inputs(rng)

    # --- align expression to the CNV gene set (vignette's subsetting step) ---
    Y, L, gene_ids = align_expression_to_cnv(Y_all, all_gene_ids, gene_cnv)
    print(f"aligned: {Y.shape[0]} cells x {Y.shape[1]} genes")

    # --- reference-ordered preprocessing ---
    pp = preprocess_for_clonealign(Y, L)
    print(f"after preprocessing: {pp.gene_expression_data.shape}")

    # --- train/serve split: fit on 600 cells, serve the remaining 200 ---
    Y_fit = pp.gene_expression_data[:600]
    Y_new = pp.gene_expression_data[600:]

    fit = run_clonealign(
        Y_fit, dict(zip(gene_cnv.clone_names, np.asarray(pp.copy_number_data).T)),
        initial_shrinks=(0, 5, 10), n_repeats=2, max_iter=max_iter, seed=1,
        y_storage="auto", print_elbos=False, verbose=False, device=device,
    )
    print(fit)
    print("clone counts:", dict(collections.Counter(fit.clone)))
    finite = fit.correlations[np.isfinite(fit.correlations)]
    print(f"correlation QC: median per-gene r = {np.median(finite):.3f}")

    acc = assignment_accuracy(fit.clone, fit.clone_names, truth[: len(fit.clone)])
    print(f"training-cohort accuracy vs ground truth: {acc:.3f}")

    # --- persist + reload (npz) ---
    path = fit.save(os.path.join(args.out, "full_workflow_torch_fit.npz"))
    reloaded = ClonealignFit.load(path)

    # --- serve the held-out cohort against the saved fit (no refit) ---
    clones_new, probs_new = assign_cells(reloaded, Y_new, pp.copy_number_data, device=device)
    acc_new = assignment_accuracy(
        clones_new, reloaded.clone_names, truth[600 : 600 + len(clones_new)]
    )
    print(f"served {len(clones_new)} new cells; accuracy {acc_new:.3f}")


if __name__ == "__main__":
    main()

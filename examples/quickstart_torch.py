"""Quickstart on the PyTorch port: simulate clone-structured data, fit,
inspect, plot, save, through ``clonealign_torch`` (the steps of
examples/quickstart.py, which runs the JAX package).

Run:  python examples/quickstart_torch.py [--device cuda|cpu] [--small] [--out DIR]

``--device`` is "cuda" by default and raises without a card; ``--device cpu``
runs on the host. ``--small`` fits a smaller simulation in fewer iterations.
Writes quickstart_torch_elbo.png, quickstart_torch_tracks.png and
quickstart_torch_fit.npz to ``--out`` (default: the current directory).
"""

import argparse
import collections
import os

import numpy as np

from clonealign_torch import clonealign, preprocess_for_clonealign, run_clonealign
from clonealign_torch.synth import assignment_accuracy, simulate_multinomial
from clonealign_torch.utils.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    parser.add_argument("--small", action="store_true", help="a small, quick configuration")
    parser.add_argument("--out", default=".", help="directory for the plots and the fit")
    args = parser.parse_args(argv)
    device = str(resolve_device(args.device))
    os.makedirs(args.out, exist_ok=True)
    N, G, max_iter = (300, 150, 100) if args.small else (1000, 400, 200)

    # --- simulate cells x genes x 4 clones with known ground truth ---
    sim = simulate_multinomial(N=N, G=G, C=4, seed=0, mean_total=2000)
    print(f"simulated: {sim.Y.shape[0]} cells x {sim.Y.shape[1]} genes, "
          f"{sim.L.shape[1]} clones")

    # --- filter (reference-ordered pipeline) ---
    pp = preprocess_for_clonealign(sim.Y, sim.L)
    print(f"after preprocessing: {pp.gene_expression_data.shape}")

    # --- single fit ---
    fit = clonealign(pp.gene_expression_data, pp.copy_number_data, max_iter=max_iter, seed=1,
                     device=device)
    print(fit)
    print("clone counts:", dict(collections.Counter(fit.clone)))

    # --- recommended: multi-restart sweep, best ELBO wins ---
    best = run_clonealign(pp.gene_expression_data, pp.copy_number_data,
                          initial_shrinks=(0, 5, 10), n_repeats=2, max_iter=max_iter, seed=2,
                          device=device)
    print("restart ELBOs:", np.round(best.multirun_info["elbos"], 1))

    # --- accuracy vs ground truth (preprocessing may drop genes, not cells) ---
    acc = assignment_accuracy(best.clone, best.clone_names, sim.clone_idx)
    print(f"assignment accuracy vs ground truth: {acc:.3f}")

    # --- plots ---
    try:
        import matplotlib

        matplotlib.use("Agg")
        from clonealign_torch.plot import plot_clonealign, plot_elbo

        elbo_png = os.path.join(args.out, "quickstart_torch_elbo.png")
        tracks_png = os.path.join(args.out, "quickstart_torch_tracks.png")
        plot_elbo(best).savefig(elbo_png, dpi=120)
        Gk = pp.gene_expression_data.shape[1]
        logcounts = np.log1p(pp.gene_expression_data
                             / pp.gene_expression_data.sum(1, keepdims=True) * 1e4)
        fig = plot_clonealign(
            logcounts, best.clone, pp.copy_number_data,
            gene_chr=["1"] * Gk, gene_start=np.arange(Gk), gene_end=np.arange(Gk) + 1,
            chromosome="1", clone_names=best.clone_names, expression_ylim=None,
        )
        fig.savefig(tracks_png, dpi=120)
        print(f"wrote {elbo_png}, {tracks_png}")
    except ImportError:
        print("matplotlib not available; skipping plots")

    # --- persist ---
    path = best.save(os.path.join(args.out, "quickstart_torch_fit.npz"))
    print(f"saved {path}")


if __name__ == "__main__":
    main()

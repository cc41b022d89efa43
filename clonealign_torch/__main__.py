"""Command-line interface; the counterpart of ``clonealign_tpu/__main__.py``
with the same commands, options, messages and exit codes, for pipeline use:

    python -m clonealign_torch fit --counts matrix.mtx.gz --cnv cnv.csv --out fit.npz
    python -m clonealign_torch assign --fit fit.npz --counts new.mtx.gz --cnv cnv.csv --out a.npz
    python -m clonealign_torch show fit.npz
    python -m clonealign_torch info

What differs, because the port runs on a card: ``fit`` and ``assign`` take
``--device`` ("cuda" by default, "cpu" when asked; a missing GPU is an
error, never a run on the CPU); ``info`` reports torch, CUDA, the card and
whether the kernel library is built; there is no compilation cache to
enable.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _device_refused(device: str) -> bool:
    """Print why ``--device`` cannot be used and return True; False when it
    can."""
    from .utils.device import resolve_device

    try:
        resolve_device(device)
    except (RuntimeError, ValueError) as e:
        print(f"error: --device {device}: {e} (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return True
    return False


def _load_counts(path: str, transpose: bool, layer: str = None):
    """Counts from .mtx[.gz], a CellRanger dir, .h5ad, 10x .h5, .npz (key
    'counts'), or CSV.

    Sparse formats (.mtx, .h5ad/.h5 with sparse groups) stay scipy-sparse
    and every format keeps its on-disk dtype — peak host memory is nnz-bound
    for sparse inputs (an N x G float64 densification here once cost 4 GB at
    100k x 5k; the library ingestion is engineered around exactly that,
    api._parse_expression / prepare_data_sparse).

    ``transpose`` applies to every format (the file is genes x cells);
    CellRanger directories are already transposed to cells x genes by their
    loader, so the flag flips that too if a non-standard dir is given.

    ``layer`` selects ``layers/<name>`` of an .h5ad instead of X — scanpy
    pipelines usually leave normalized data in X and raw counts in a layer
    (the fit rejects fractional values pointing here)."""
    import os

    gene_names = cell_names = None
    if layer is not None and not path.endswith(".h5ad"):
        raise ValueError(
            f"--layer applies to .h5ad inputs only (got {path!r})"
        )
    if os.path.isdir(path):
        from .io.mtx import load_cellranger_dir

        Y, gene_names, cell_names = load_cellranger_dir(path)
    elif path.endswith((".mtx", ".mtx.gz")):
        from .io.mtx import read_mtx

        Y = read_mtx(path, dense=False, transpose=transpose).tocsr()
        transpose = False  # consumed by the reader
    elif path.endswith(".h5ad"):
        from .io.h5 import read_h5ad

        cm = read_h5ad(path, layer=layer)
        Y, gene_names, cell_names = cm.counts, cm.gene_names, cm.cell_names
    elif path.endswith((".h5", ".hdf5")):
        from .io.h5 import read_10x_h5

        cm = read_10x_h5(path)
        Y, gene_names, cell_names = cm.counts, cm.gene_names, cm.cell_names
    elif path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        Y = z["counts"]
        if "gene_names" in z.files:
            gene_names = [str(g) for g in z["gene_names"]]
        if "cell_names" in z.files:
            cell_names = [str(c) for c in z["cell_names"]]
    else:
        Y = np.loadtxt(path, delimiter=",", skiprows=0)
    if transpose:
        Y = Y.T  # scipy transpose is a view-flip, dense is a view
        gene_names, cell_names = cell_names, gene_names
    return Y, gene_names, cell_names


def _load_cnv(path: str):
    """Copy numbers from CSV (header row = clone names; optional leading
    gene-id column) or .npz (key 'copy_number' [+ 'clone_names'])."""
    if path.endswith(".npz"):
        z = np.load(path, allow_pickle=False)
        L = z["copy_number"]
        names = [str(c) for c in z["clone_names"]] if "clone_names" in z.files else None
        return np.asarray(L, np.float64), names

    with open(path) as fh:
        header = fh.readline().strip().split(",")
        rows = [line.strip().split(",") for line in fh if line.strip()]
    # leading gene-id column if the first data cell is non-numeric
    lead = 0
    try:
        float(rows[0][0])
    except ValueError:
        lead = 1
    names = [h.strip() for h in header[lead:]]
    L = np.asarray([[float(v) for v in r[lead:]] for r in rows])
    return L, names


def _load_fit(path: str):
    """A saved fit: .npz (this package — v2 or the legacy v1 family,
    dispatched on the npz's ``model`` tag) or .rds (R's saveRDS, either the
    original package's output or :meth:`ClonealignFit.save_rds`)."""
    from .fit import ClonealignFit

    if path.endswith(".rds"):
        return ClonealignFit.load_rds(path)
    with np.load(path, allow_pickle=True) as z:
        is_v1 = "model" in z.files and str(z["model"]) == "negbin_v1"
    if is_v1:
        from .models.negbin import ClonealignV1Fit

        return ClonealignV1Fit.load(path)
    return ClonealignFit.load(path)


def _save_fit(fit, path: str) -> str:
    if path.endswith(".rds"):
        fit.save_rds(path)
        return path
    return fit.save(path)


def cmd_fit(args) -> int:
    from . import clonealign, run_clonealign

    if _device_refused(args.device):
        return 1
    Y, gene_names, _ = _load_counts(args.counts, args.transpose, args.layer)
    L, clone_names = _load_cnv(args.cnv)
    if clone_names:
        cnv_input = dict(zip(clone_names, L.T))
    else:
        cnv_input = L

    if args.preprocess:
        from . import preprocess_for_clonealign

        pp = preprocess_for_clonealign(Y, cnv_input)
        Y = pp.gene_expression_data
        cnv_input = dict(zip(pp.clone_names, pp.copy_number_data.T))

    if args.model == "negbin-v1":
        import collections

        from .models.negbin import inference_em

        if args.out.endswith(".rds"):
            print("error: v1 fits save as .npz (no R-side v1 layout to "
                  "target — the reference deleted the v1 code)", file=sys.stderr)
            return 2
        # the v1 fit is deterministic (no MC, moment init) and has no
        # storage knobs; refusing beats silently ignoring
        unsupported = [
            ("--restarts", args.restarts != 1),
            ("--seed", args.seed != 0),
            ("--y-storage", args.y_storage != "auto"),
            ("--likelihood-impl",
             args.likelihood_impl not in ("auto", "cheb")),
            ("--stream", args.stream),
            ("--allow-fractional", args.allow_fractional),
        ]
        bad = [flag for flag, set_ in unsupported if set_]
        if bad:
            print(f"error: {', '.join(bad)} not supported with "
                  "--model negbin-v1 (the v1 VEM is deterministic and has "
                  "no v2 storage knobs; its backends are 'auto' [exact] "
                  "and 'cheb')", file=sys.stderr)
            return 2
        L_arr = (np.column_stack([cnv_input[k] for k in cnv_input])
                 if isinstance(cnv_input, dict) else np.asarray(cnv_input))
        names = list(cnv_input) if isinstance(cnv_input, dict) else None
        fit = inference_em(
            Y, L_arr, max_iter=args.max_iter, rel_tol=args.rel_tol,
            learning_rate=(0.05 if args.learning_rate is None
                           else args.learning_rate),
            clone_call_probability=args.clone_call_probability,
            clone_names=names, verbose=not args.quiet,
            likelihood_impl=("cheb" if args.likelihood_impl == "cheb"
                             else "exact"),
            device=args.device,
        )
        written = fit.save(args.out)
        if not args.quiet:
            print(fit)
            print("clone counts:", dict(collections.Counter(fit.clone)))
            print(f"saved -> {written}")
        return 0

    if args.likelihood_impl == "cheb":
        # 'cheb' is the negbin-v1 VEM backend only; the v2 analog is 'z_cheb'
        print("error: --likelihood-impl cheb is only valid with "
              "--model negbin-v1 (for the default multinomial model use "
              "'z_cheb')", file=sys.stderr)
        return 2

    common = dict(
        max_iter=args.max_iter,
        rel_tol=args.rel_tol,
        learning_rate=0.1 if args.learning_rate is None else args.learning_rate,
        clone_call_probability=args.clone_call_probability,
        seed=args.seed,
        verbose=not args.quiet,
        y_storage=None if args.y_storage == "float32" else args.y_storage,
        likelihood_impl=args.likelihood_impl,
        allow_fractional=args.allow_fractional,
        device=args.device,
    )
    if args.stream:
        if args.restarts != 1:
            print("error: --stream does not support --restarts (each restart "
                  "would re-stream the whole matrix; run them separately)",
                  file=sys.stderr)
            return 2
        from .stream import fit_streaming

        fit = fit_streaming(Y, cnv_input, chunk_cells=args.chunk_cells, **common)
        written = _save_fit(fit, args.out)
        if not args.quiet:
            import collections

            print(fit)
            print("clone counts:", dict(collections.Counter(fit.clone)))
            print(f"final ELBO: {fit.convergence_info.final_elbo:.4f}")
            print(f"saved -> {written}")
        return 0
    if args.restarts > 1:
        fit = run_clonealign(
            Y, cnv_input, initial_shrinks=(5,), n_repeats=args.restarts,
            print_elbos=not args.quiet, **common,
        )
    else:
        fit = clonealign(Y, cnv_input, **common)

    written = _save_fit(fit, args.out)
    if not args.quiet:
        import collections

        print(fit)
        print("clone counts:", dict(collections.Counter(fit.clone)))
        print(f"final ELBO: {fit.convergence_info.final_elbo:.4f}")
        print(f"saved -> {written}")
    return 0


def cmd_assign(args) -> int:
    """Serve: assign new cells against a saved fit (no refit)."""
    import collections

    if _device_refused(args.device):
        return 1
    fit = _load_fit(args.fit)
    Y, _genes, cell_names = _load_counts(args.counts, args.transpose, args.layer)
    L, _names = _load_cnv(args.cnv)
    from .models.negbin import ClonealignV1Fit, classify_cells

    if isinstance(fit, ClonealignV1Fit):
        if args.latent != "auto":
            print(f"error: --latent {args.latent} applies to v2 fits only "
                  "(the v1 family has no latent factor)", file=sys.stderr)
            return 2
        clones, probs = classify_cells(
            fit, Y, L, clone_call_probability=args.clone_call_probability,
            device=args.device,
        )
    else:
        from .serve import assign_cells

        clones, probs = assign_cells(
            fit, Y, L, clone_call_probability=args.clone_call_probability,
            latent=args.latent, device=args.device,
        )
    np.savez_compressed(
        args.out,
        clone=np.asarray(clones, dtype=str),
        clone_probs=probs,
        clone_names=np.asarray(fit.clone_names, dtype=str),
        cell_names=np.asarray(cell_names if cell_names else [], dtype=str),
    )
    written = args.out if args.out.endswith(".npz") else f"{args.out}.npz"
    if not args.quiet:
        print("clone counts:", dict(collections.Counter(clones)))
        print(f"saved -> {written}")
    return 0


def cmd_show(args) -> int:
    fit = _load_fit(args.fit)
    import collections

    from .models.negbin import ClonealignV1Fit

    print(fit)
    if isinstance(fit, ClonealignV1Fit):
        info = {
            "model": "negbin_v1",
            "clone_counts": dict(collections.Counter(fit.clone)),
            "final_elbo": fit.final_elbo,
            "n_iters": fit.n_iter,
            "n_genes": len(fit.mu),
            "dosage_genes": int((fit.rho_probs > 0.5).sum()),
        }
    else:
        info = {
            "clone_counts": dict(collections.Counter(fit.clone)),
            "final_elbo": fit.convergence_info.final_elbo,
            "sd_final_elbo": fit.convergence_info.sd_final_elbo,
            "n_iters": fit.convergence_info.n_iters,
            "n_retained_genes": len(fit.retained_genes),
            "median_correlation": float(np.nanmedian(fit.correlations)),
        }
    print(json.dumps(info, indent=2, default=str))
    return 0


def cmd_info(args) -> int:
    import torch

    from . import __version__
    from .io.mtx import _load_native
    from .ops import _build

    print(f"clonealign_torch {__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    else:
        print("devices: none (torch.cuda.is_available() is false; --device cpu only)")
    lib = _build.library_path()
    print("kernel library: " + (f"built, {lib}" if lib.exists()
                                else "not built (nvcc builds it on the first CUDA fit)"))
    print(f"native loader: {'available' if _load_native() is not None else 'fallback (pure python)'}")
    return 0


def _add_device(p) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device: 'cuda' (default; a missing GPU is an error) or 'cpu'",
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="clonealign_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_fit = sub.add_parser("fit", help="assign cells to clones")
    p_fit.add_argument("--counts", required=True, help=".mtx[.gz], CellRanger dir, .h5ad, 10x .h5, .npz, or CSV (cells x genes)")
    p_fit.add_argument("--cnv", required=True, help="CSV (header = clone names) or .npz copy-number matrix (genes x clones)")
    p_fit.add_argument("--out", required=True, help="output fit (.npz, or .rds for R's readRDS)")
    p_fit.add_argument("--transpose", action="store_true", help="counts file is genes x cells (e.g. raw .mtx from CellRanger)")
    p_fit.add_argument(
        "--layer", default=None,
        help=".h5ad only: read layers/<name> (e.g. 'counts') instead of X — "
        "scanpy pipelines usually leave normalized data in X",
    )
    p_fit.add_argument(
        "--allow-fractional", action="store_true",
        help="fit fractional (non-integer) expression values instead of "
        "rejecting them; the model is a count likelihood, so prefer raw "
        "counts (--layer counts for scanpy .h5ad files)",
    )
    p_fit.add_argument("--preprocess", action="store_true", help="run preprocess_for_clonealign first")
    p_fit.add_argument(
        "--model", default="multinomial", choices=["multinomial", "negbin-v1"],
        help="model family: the v2 multinomial (default, the published "
        "model) or the legacy v1 negative-binomial dosage mixture "
        "(docs/legacy_v1.md)",
    )
    p_fit.add_argument("--restarts", type=int, default=1)
    p_fit.add_argument("--max-iter", type=int, default=200)
    p_fit.add_argument("--rel-tol", type=float, default=1e-6)
    p_fit.add_argument("--learning-rate", type=float, default=None,
                   help="Adam step size (default: 0.1 for the v2 model, 0.05 for negbin-v1)")
    p_fit.add_argument("--clone-call-probability", type=float, default=0.95)
    p_fit.add_argument("--seed", type=int, default=0)
    p_fit.add_argument(
        "--y-storage", default="auto",
        choices=["auto", "int8", "int16", "bfloat16", "float32"],
        help="device storage for the count matrix; 'auto' (default) picks "
        "the narrowest EXACT integer dtype (api._auto_y_storage)",
    )
    p_fit.add_argument(
        "--likelihood-impl", default="auto",
        choices=["auto", "xla", "z_cheb", "cheb"],
        help="ELBO backend: 'auto' (default; exact at every size — on the "
        "card the exact likelihood kernels beat z_cheb in a single fit, "
        "api._resolve_auto_impl, PERF.md), 'xla' (exact, the fused CUDA "
        "kernels on the card), or 'z_cheb' — the Chebyshev log-normalizer "
        "(K=1, no covariates). "
        "With --model negbin-v1: 'cheb' — the Chebyshev "
        "sufficient-statistics VEM (docs/legacy_v1.md)",
    )
    p_fit.add_argument(
        "--stream", action="store_true",
        help="streaming fit (fit_streaming): Y stays on the host and streams "
             "through the device one cell chunk per step; for counts larger "
             "than device memory",
    )
    p_fit.add_argument(
        "--chunk-cells", type=int, default=None,
        help="streaming chunk size in cells (default: auto, ~256 MB chunks)",
    )
    p_fit.add_argument("--quiet", action="store_true")
    _add_device(p_fit)
    p_fit.set_defaults(fn=cmd_fit)

    p_as = sub.add_parser("assign", help="assign NEW cells against a saved fit (no refit)")
    p_as.add_argument("--fit", required=True, help="fit .npz produced by `fit`, or a .rds fit (incl. the R package's saveRDS output)")
    p_as.add_argument("--counts", required=True, help="new cells' counts over the fit's retained genes")
    p_as.add_argument("--cnv", required=True, help="copy numbers over the fit's retained genes")
    p_as.add_argument("--out", required=True, help="output assignments .npz")
    p_as.add_argument("--transpose", action="store_true")
    p_as.add_argument(
        "--layer", default=None,
        help=".h5ad only: read layers/<name> (e.g. 'counts') instead of X",
    )
    p_as.add_argument("--clone-call-probability", type=float, default=0.95)
    p_as.add_argument(
        "--latent", choices=("auto", "ignore", "refine"), default="auto",
        help="latent-factor handling for unseen cells (serve.py docstring): "
        "refine = per-(cell, clone) Laplace psi estimate for K=1 fits",
    )
    p_as.add_argument("--quiet", action="store_true")
    _add_device(p_as)
    p_as.set_defaults(fn=cmd_assign)

    p_show = sub.add_parser("show", help="summarize a saved fit")
    p_show.add_argument("fit", help="fit .npz produced by `fit`, or a .rds fit (incl. the R package's saveRDS output)")
    p_show.set_defaults(fn=cmd_show)

    p_info = sub.add_parser("info", help="torch / CUDA / kernel library / native-loader status")
    p_info.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

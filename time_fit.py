"""Milliseconds per iteration of the full-width single fit, for the
``clonealign_torch`` package of any checkout.

    python3 time_fit.py [--f64] [ROOT ...]

For each ROOT in turn (default: this file's directory) it runs, in a process
of its own, the package found there: ``clonealign`` on the card at 100,000
cells x 5,000 genes x 10 clones (``chip_smoke.synth_counts``'s counts, seed
3), exact likelihood, 100 iterations, ``elbo_eval="fresh"``, seed 0, three
times after one warm-up fit. The loop is bound by the host, so two
checkouts given in turns (A B B A ...) are what compares them. With
``--f64`` the fits take ``dtype="float64"`` (the float64 kernel family; Y
stored as "auto" gives it, int8). Prints the card's name and power limit,
then one JSON line per ROOT with each fit's ms per iteration
(``timings["loop"]`` over the iterations) and setup seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# This file's chip_smoke, imported before ROOT goes on the path.
from chip_smoke import FIT_MAX_ITER, FULL, synth_counts

REPS = 3


def time_root(root: str, dtype: str = "float32") -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import clonealign_torch

    Y, L, _ = synth_counts(3, FULL["N"], FULL["G"], FULL["C"])
    ms, setup = [], []
    for rep in range(REPS + 1):
        fit = clonealign_torch.clonealign(Y, L, device="cuda", max_iter=FIT_MAX_ITER, seed=0,
                                          verbose=False, likelihood_impl="xla", dtype=dtype)
        if rep:  # the first fit builds the kernels and warms the allocator
            ms.append(1000 * fit.timings["loop"] / fit.convergence_info.n_iters)
            setup.append(fit.timings["setup"])
    return {"root": root, "dtype": dtype, "ms_per_iteration": ms, "setup_s": setup}


def main() -> int:
    args = sys.argv[1:]
    f64 = args[:1] == ["--f64"]
    args = args[f64:]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(time_root(args[1], "float64" if f64 else "float32")), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_fit: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    for root in args or [os.path.dirname(os.path.abspath(__file__))]:
        subprocess.run([sys.executable, os.path.abspath(__file__), *["--f64"] * f64, "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Card time of the fused likelihood's training step through its public
autograd function, for the ``clonealign_torch`` package of any checkout.

    python3 time_likelihood.py [ROOT ...]

For each ROOT in turn (default: this file's directory) it runs, in a process
of its own, the package found there: it builds that package's kernels and,
at the full width of the fit (100,000 cells x 5,000 genes, S*C = 10,
Kf = 1, A2 off, inputs made on the card from a seed), times

* ``fwd_nograd_ms``: the forward under ``torch.no_grad()`` (the fit's
  fresh-eval and final forwards),
* ``fwd_grad_ms``: the forward with gradients on (the training step's),
* ``step_ms``: that forward and its backward through ``torch.autograd.grad``,
  and ``bwd_ms = step_ms - fwd_grad_ms``.

Each time is ``chip_smoke.cuda_ms``'s: the median over rounds of a batch of
calls queued between two CUDA events, divided by the batch, which times the
card rather than the host. The inputs are ``chip_smoke.kernel_inputs``'s.
``fused_likelihood_terms`` is the same entry point in every version of the
package, so two checkouts given in turns (A B B A) are compared in one run.
Prints one JSON line per ROOT, after the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

# This file's chip_smoke, imported before ROOT goes on the path.
from chip_smoke import FULL, cuda_ms, kernel_inputs


def time_root(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from clonealign_torch.ops import _build
    from clonealign_torch.ops import fused_likelihood as fl

    _build.load()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x = kernel_inputs(gen, FULL["N"], FULL["G"], FULL["C"], S=1, Kf=1, device="cuda")
    Y = x["Y"]
    leaves = [x[n].requires_grad_() for n in ("psi", "W", "muL")]
    cot = (x["dA1"], x["dZ"])

    def fwd_nograd():
        with torch.no_grad():
            fl.fused_likelihood_terms(Y, leaves[0], leaves[1], None, leaves[2])

    def fwd_grad():
        fl.fused_likelihood_terms(Y, leaves[0], leaves[1], None, leaves[2])

    def step():
        A1, _, Z = fl.fused_likelihood_terms(Y, leaves[0], leaves[1], None, leaves[2])
        torch.autograd.grad((A1, Z), leaves, grad_outputs=cot)

    t = {"fwd_nograd_ms": cuda_ms(fwd_nograd, reps=10),
         "fwd_grad_ms": cuda_ms(fwd_grad, reps=10),
         "step_ms": cuda_ms(step, reps=10)}
    t["bwd_ms"] = t["step_ms"] - t["fwd_grad_ms"]
    return {"root": root, **t}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(time_root(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("time_likelihood: torch.cuda.is_available() is false; this needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    for root in sys.argv[1:] or [os.path.dirname(os.path.abspath(__file__))]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

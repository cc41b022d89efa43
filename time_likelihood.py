"""Card time of the fused likelihood's training step through its public
autograd function, for the ``clonealign_torch`` package of any checkout.

    python3 time_likelihood.py [--wide | --f64] [ROOT ...]

For each ROOT in turn (default: this file's directory) it runs, in a process
of its own, the package found there: it builds that package's kernels and,
at the full width of the fit (100,000 cells x 5,000 genes, S*C = 10,
Kf = 1, A2 off, inputs made on the card from a seed), times

* ``fwd_nograd_ms``: the forward under ``torch.no_grad()`` (the fit's
  fresh-eval and final forwards),
* ``fwd_grad_ms``: the forward with gradients on (the training step's),
* ``step_ms``: that forward and its backward through ``torch.autograd.grad``,
  and ``bwd_ms = step_ms - fwd_grad_ms``.

With ``--wide`` it times instead the wide family's wrappers at each of
``chip_smoke``'s full-width wide configurations (``WIDE_FULL``: (Kf, S) with
C = 10, A2 off) and at the widest [psi, X] (Kf = 64, S = 8), at each of its
Y storages (``WIDE_FULL_STORAGES``): ``fwd_ms``
(``kernel_forward``: the packing and ``fwd_wide_kernel``), ``dpsi_ms``
(``kernel_dpsi``) and ``gene_ms`` (``kernel_gene``: the packing,
``gene_wide_kernel`` and ``reduce_chunks_kernel``), the numbers
``chip_smoke.py`` reports under the same names.

With ``--f64`` it times the float64 family's wrappers at each of
``chip_smoke``'s full-width float64 configurations (``F64_FULL``: (Kf, S)
with C = 10, A2 off) at each of its Y storages (``F64_FULL_STORAGES``):
``fwd_ms`` (``kernel_forward``: ``fwd_f64_kernel``), ``dpsi_ms``
(``kernel_dpsi``: ``dpsi_f64_kernel``) and ``gene_ms`` (``kernel_gene``:
``gene_f64_kernel`` and ``reduce_chunks_f64_kernel``), float64 operands
from ``chip_smoke.kernel_inputs``.

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
from chip_smoke import (F64_FULL, F64_FULL_STORAGES, FULL, WIDE_FULL, WIDE_FULL_STORAGES, cuda_ms,
                        kernel_inputs)


def time_wide(fl) -> dict:
    import torch

    out = {}
    for storage in WIDE_FULL_STORAGES:
        for Kf, S in (*WIDE_FULL, (64, 8)):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(3)
            x = kernel_inputs(gen, FULL["N"], FULL["G"], FULL["C"], S=S, Kf=Kf, device="cuda")
            Y = x["Y"].to(getattr(torch, storage))
            _, _, _, YW = fl.kernel_forward(Y, x["psi"], x["W"], None, x["muL"])
            out[f"{storage} Kf={Kf} S*C={S * FULL['C']}"] = {
                "fwd_ms": cuda_ms(lambda: fl.kernel_forward(Y, x["psi"], x["W"], None, x["muL"]),
                                  reps=5),
                "dpsi_ms": cuda_ms(lambda: fl.kernel_dpsi(x["psi"], x["W"], x["muL"], x["dA1"],
                                                          x["dZ"], YW), reps=5),
                "gene_ms": cuda_ms(lambda: fl.kernel_gene(Y, x["psi"], x["W"], x["muL"],
                                                          x["dA1"], None, x["dZ"]), reps=5)}
            del x, Y, YW
            torch.cuda.empty_cache()
    return out


def time_f64(fl) -> dict:
    import torch

    out = {}
    for storage in F64_FULL_STORAGES:
        for Kf, S in F64_FULL:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(3)
            x = {k: v.double() for k, v in kernel_inputs(gen, FULL["N"], FULL["G"], FULL["C"], S=S,
                                                         Kf=Kf, device="cuda").items()}
            Y = x["Y"].to(getattr(torch, storage))
            _, _, _, YW = fl.kernel_forward(Y, x["psi"], x["W"], None, x["muL"])
            out[f"{storage} Kf={Kf} S*C={S * FULL['C']}"] = {
                "fwd_ms": cuda_ms(lambda: fl.kernel_forward(Y, x["psi"], x["W"], None, x["muL"]),
                                  reps=5),
                "dpsi_ms": cuda_ms(lambda: fl.kernel_dpsi(x["psi"], x["W"], x["muL"], x["dA1"],
                                                          x["dZ"], YW), reps=5),
                "gene_ms": cuda_ms(lambda: fl.kernel_gene(Y, x["psi"], x["W"], x["muL"],
                                                          x["dA1"], None, x["dZ"]), reps=5)}
            del x, Y, YW
            torch.cuda.empty_cache()
    return out


def time_root(root: str, family: str = "") -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from clonealign_torch.ops import _build
    from clonealign_torch.ops import fused_likelihood as fl

    _build.load()
    if family == "--wide":
        return {"root": root, **time_wide(fl)}
    if family == "--f64":
        return {"root": root, **time_f64(fl)}
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
    args = sys.argv[1:]
    family = args[0] if args and args[0] in ("--wide", "--f64") else ""
    args = args[bool(family):]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(time_root(args[1], family)), flush=True)
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
    for root in args or [os.path.dirname(os.path.abspath(__file__))]:
        subprocess.run([sys.executable, os.path.abspath(__file__), *[family] * bool(family),
                        "--one", root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

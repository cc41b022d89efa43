"""Variational-inference engine: the reference's Adam training loop
(reference R/inference-tflow.R:344-421), counterpart of
``clonealign_tpu/infer.py``.

The loop runs in Python with one host sync per iteration: the stop test
needs the new ELBO on the host.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .models import multinomial as mm
from .utils.device import synchronize

class TF1Adam:
    """Adam with TF1's update form (the reference uses
    ``tf$train$AdamOptimizer`` defaults, R/inference-tflow.R:345); the
    counterpart of ``clonealign_tpu.infer.tf1_adam``.

    TF1 applies ``lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)`` — the
    epsilon sits outside the bias correction — and computes the
    bias-correction scalars in the variable's dtype.
    """

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.count = 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads) -> None:
        """Update ``params`` in place from ``grads``."""
        self.count += 1
        b1, b2 = self.b1, self.b2
        for p, g, m, v in zip(params, grads, self.m, self.v):
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            t = torch.tensor(self.count, dtype=torch.promote_types(p.dtype, torch.float32))
            lr_t = self.lr * torch.sqrt(1 - b2**t) / (1 - b1**t)
            p.add_(-lr_t * m / (torch.sqrt(v) + self.eps))


class InferenceResult(NamedTuple):
    params: mm.CloneAlignParams
    elbo_trace: np.ndarray     # (max_iter + 1,), NaN-padded after convergence
    n_iters: int
    final_elbo: float          # mean of the final stochastic evaluations
    sd_final_elbo: float       # ddof=1 sd of those evaluations
    loop_seconds: float        # wall time of the Adam loop alone


def run_inference(
    params: mm.CloneAlignParams,
    data: mm.ModelData,
    noise,
    config: mm.ModelConfig,
    *,
    max_iter: int = 100,
    rel_tol: float = 1e-5,
    learning_rate: float = 0.1,
    initial_shrink: float = 5.0,
    window_size: int = 10,
    n_final_elbo_samples: int = 20,
    elbo_eval: str = "fresh",
    progress: bool = False,
) -> InferenceResult:
    """Fit by reparametrization-gradient VI, drawing every sample from
    ``noise`` (see ``utils/noise.py``).

    Loop semantics mirror the reference: likelihood-based gamma warm start
    (scaled by ``initial_shrink``/5); each iteration takes one Adam step on
    -ELBO with a fresh sample, then re-evaluates the ELBO with another fresh
    sample; it stops when the mean |relative ELBO change| over the last
    ``window_size`` iterations drops below ``rel_tol``.

    ``elbo_eval="reuse"`` monitors the value already computed for the
    gradient (pre-update, training sample) instead of a second forward pass.
    """
    if elbo_eval not in ("fresh", "reuse"):
        raise ValueError(f"elbo_eval must be 'fresh' or 'reuse', got {elbo_eval!r}")
    dtype, device = params.qmu_loc.dtype, params.qmu_loc.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    shape = (config.mc_samples, params.qmu_loc.shape[0])

    def draw(what):
        return noise.normal(what, shape, dtype, device)

    with torch.no_grad():
        warm = mm.gamma_warm_start_logits(params, data, draw("warm"), initial_shrink)
        params = params.replace(gamma_logits=warm)
        elbo_val = np_dtype(mm.elbo(params, data, draw("init_eval"), config).item())

    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    params = mm.CloneAlignParams(*leaves)
    opt = TF1Adam(leaves, learning_rate)

    trace = np.full(max_iter + 1, np.nan, np_dtype)
    trace[0] = elbo_val
    window = np.full(window_size, 1e3, np_dtype)
    i = 0
    synchronize(device)
    t0 = time.perf_counter()
    while i < max_iter and np.mean(np.abs(window)) >= rel_tol:
        neg_elbo = -mm.elbo(params, data, draw("train"), config)
        grads = torch.autograd.grad(neg_elbo, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        opt.step(leaves, grads)
        if elbo_eval == "fresh":
            with torch.no_grad():
                elbo_new = mm.elbo(params, data, draw("eval"), config)
        else:
            elbo_new = -neg_elbo.detach()
        elbo_new = np_dtype(elbo_new.item())
        window = np.roll(window, -1)
        window[-1] = (elbo_new - elbo_val) / np.abs(elbo_val)
        trace[i + 1] = elbo_new
        elbo_val = elbo_new
        i += 1
        if progress:
            print(
                f"  VB iter {i:4d}  elbo {float(elbo_new):.4f}  "
                f"mean|Δ| {float(np.mean(np.abs(window))):.3e}"
            )
    synchronize(device)
    loop_seconds = time.perf_counter() - t0

    with torch.no_grad():
        params = mm.CloneAlignParams(*[t.detach() for t in leaves])
        finals = torch.stack([
            mm.elbo(params, data, draw("final"), config)
            for _ in range(n_final_elbo_samples)
        ])
        final_elbo = float(torch.mean(finals))
        sd_final = float(torch.std(finals, correction=1))

    return InferenceResult(
        params=params,
        elbo_trace=trace,
        n_iters=i,
        final_elbo=final_elbo,
        sd_final_elbo=sd_final,
        loop_seconds=loop_seconds,
    )

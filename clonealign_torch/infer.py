"""Variational-inference engine: the reference's Adam training loop
(reference R/inference-tflow.R:344-421), counterpart of
``clonealign_tpu/infer.py``.

The loop runs in Python over R lanes (restarts) at once, with one host sync
per iteration for all of them: the stop test needs the new ELBOs on the
host. A single fit is the one-lane case. On a mesh (``ModelData.cells``)
each rank runs the loop on its tile, and one all_reduce a step over the
cells group sums the cell blocks' values and shared gradients.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .models import multinomial as mm
from .parallel.collectives import CELL_AXIS, all_sum
from .utils.device import synchronize


def _upload(x, device):
    """A host array as a tensor on ``device``. To a CUDA device it is copied
    from pinned memory without blocking: a copy from pageable memory would
    make the host wait for every kernel queued before it."""
    t = torch.as_tensor(x)
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


class TF1Adam:
    """Adam with TF1's update form (the reference uses
    ``tf$train$AdamOptimizer`` defaults, R/inference-tflow.R:345); the
    counterpart of ``clonealign_tpu.infer.tf1_adam``.

    TF1 applies ``lr * sqrt(1-b2^t)/(1-b1^t) * m / (sqrt(v) + eps)`` — the
    epsilon sits outside the bias correction — and computes the
    bias-correction scalars in the variable's dtype.

    With ``n_lanes`` every parameter carries a leading lane axis and each
    lane keeps its own step count: :meth:`step` moves only the lanes it is
    told are active, as the reference's ``jnp.where(keep, new, old)`` does.
    The counts and the bias-correction scalars live on the host and reach
    the device in one copy a step that does not wait for the card.
    """

    def __init__(self, params, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, n_lanes=None):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.count = np.zeros(() if n_lanes is None else (n_lanes,), np.int64)
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params, grads, active=None) -> None:
        """Update ``params`` in place from ``grads``; with lanes, ``active``
        (a bool array, one entry per lane, or None for all) selects the lanes
        that move: the others keep their parameters, moments and count."""
        b1, b2 = self.b1, self.b2
        self.count += 1 if active is None else active
        t = torch.as_tensor(self.count, dtype=torch.promote_types(params[0].dtype, torch.float32))
        device = params[0].device
        neg_lr = _upload(-(self.lr * torch.sqrt(1 - b2**t) / (1 - b1**t)), device)
        keep_lanes = None if active is None else _upload(active, device)
        for p, g, m, v in zip(params, grads, self.m, self.v):
            if not p.numel():  # e.g. beta without covariates: nothing to move
                continue
            lane = (-1,) + (1,) * (p.dim() - 1)
            lr_p = neg_lr if neg_lr.dim() == 0 else neg_lr.view(lane)
            m_new = b1 * m + (1 - b1) * g
            v_new = b2 * v + (1 - b2) * g * g
            p_new = p + lr_p * m_new / (torch.sqrt(v_new) + self.eps)
            if keep_lanes is not None:
                keep = keep_lanes.view(lane)
                m_new = torch.where(keep, m_new, m)
                v_new = torch.where(keep, v_new, v)
                p_new = torch.where(keep, p_new, p)
            m.copy_(m_new)
            v.copy_(v_new)
            p.copy_(p_new)


class OptaxAdamState(NamedTuple):
    """The state of :class:`OptaxAdam`, in the layout of optax's
    ``(ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))``:
    Adam's step count and moments (one tensor per parameter) and the
    learning-rate schedule's own count, None for a constant rate."""

    count: int
    mu: tuple
    nu: tuple
    schedule_count: Optional[int] = None


class OptaxAdam:
    """Adam in optax's form, ``optax.adam(optax.exponential_decay(lr,
    transition_steps, decay_rate))``, or ``optax.adam(lr)`` when
    ``decay_rate`` is 1.0: the counterpart of the optimizer of
    ``clonealign_tpu.models.negbin`` (there :718-731). Unlike
    :class:`TF1Adam`, epsilon sits outside the square root of the
    bias-corrected second moment, ``m_hat / (sqrt(v_hat) + eps)``, the bias
    correction uses the incremented count, and the step size is the
    schedule's value at its count before the increment (non-staircase), so
    the first step uses ``lr(0)``. The state is explicit
    (:class:`OptaxAdamState`), so a fit can be resumed from it."""

    def __init__(self, learning_rate: float, transition_steps: int = 0,
                 decay_rate: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.decay_rate = learning_rate, decay_rate
        self.transition_steps = transition_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.constant = decay_rate == 1.0

    def learning_rate(self, count: int) -> float:
        """optax.exponential_decay at ``count`` (constant where optax's is:
        no transition steps, or a zero rate). optax's schedule takes an
        int32 count and returns float32, its power taken as XLA takes a
        float32 power (in float64, rounded), so this does too."""
        if self.constant or self.transition_steps <= 0 or self.decay_rate == 0:
            return self.lr
        f32 = np.float32
        if count <= 0:
            return float(f32(self.lr))
        p = f32(count) / f32(self.transition_steps)
        return float(f32(self.lr) * f32(np.power(np.float64(f32(self.decay_rate)), np.float64(p))))

    def init(self, params) -> OptaxAdamState:
        return OptaxAdamState(count=0, mu=tuple(torch.zeros_like(p) for p in params),
                              nu=tuple(torch.zeros_like(p) for p in params),
                              schedule_count=None if self.constant else 0)

    @torch.no_grad()
    def step(self, state: OptaxAdamState, params, grads):
        """The parameters after one step from ``grads``, and the new state."""
        if (state.schedule_count is None) != self.constant:
            raise ValueError(
                "the optimizer state was made with a "
                f"{'constant' if state.schedule_count is None else 'decaying'} learning rate "
                f"but this optimizer's is {'constant' if self.constant else 'decaying'} "
                "(lr_decay_rate must match the run it resumes)"
            )
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        c1, c2 = 1 - b1**count, 1 - b2**count
        step = -self.learning_rate(0 if self.constant else state.schedule_count)
        mus, nus, new = [], [], []
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            m = (1 - b1) * g + b1 * m
            v = (1 - b2) * (g * g) + b2 * v
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            new.append(p + step * u)
            mus.append(m)
            nus.append(v)
        return new, OptaxAdamState(
            count=count, mu=tuple(mus), nu=tuple(nus),
            schedule_count=None if self.constant else state.schedule_count + 1)


class InferenceResult(NamedTuple):
    """One fit, or with lanes one entry per lane along a leading axis."""

    params: mm.CloneAlignParams
    elbo_trace: np.ndarray     # ([R,] max_iter + 1), NaN-padded after convergence
    n_iters: object            # int, or (R,) int array
    final_elbo: object         # mean of the final stochastic evaluations
    sd_final_elbo: object      # ddof=1 sd of those evaluations
    loop_seconds: float        # wall time of the Adam loop alone (shared by lanes)


def stack_lanes(params_list) -> mm.CloneAlignParams:
    """Parameters of R fits as one set with a leading lane axis."""
    return mm.CloneAlignParams(*[mm.stack_lanes(ts) for ts in zip(*[p.tensors() for p in params_list])])


def lane_result(result: InferenceResult, r: int) -> InferenceResult:
    """Lane ``r`` of a lane-batched result, as a single fit's result."""
    return InferenceResult(
        params=mm.CloneAlignParams(*[t[r] for t in result.params.tensors()]),
        elbo_trace=result.elbo_trace[r],
        n_iters=int(result.n_iters[r]),
        final_elbo=float(result.final_elbo[r]),
        sd_final_elbo=float(result.sd_final_elbo[r]),
        loop_seconds=result.loop_seconds,
    )


def final_config(config: mm.ModelConfig) -> mm.ModelConfig:
    """The configuration of the final ELBO: the exact normalizer also when
    training used z_cheb (reference infer.py:219-223)."""
    return config._replace(likelihood_impl="xla") if mm._use_z_cheb(config) else config


class Monitor:
    """The ELBO traces of R lanes and the reference's stopping rule: a lane
    stops when the mean |relative ELBO change| over its last ``window_size``
    iterations drops below ``rel_tol``, or at ``max_iter``."""

    def __init__(self, elbo0, max_iter, rel_tol, window_size, np_dtype):
        R = len(elbo0)
        self.max_iter, self.rel_tol = max_iter, rel_tol
        self.trace = np.full((R, max_iter + 1), np.nan, np_dtype)
        self.trace[:, 0] = elbo0
        self.window = np.full((R, window_size), 1e3, np_dtype)
        self.elbo = np.array(elbo0, np_dtype)  # each lane's last ELBO
        self.i = np.zeros(R, np.int64)         # each lane's iterations

    def live(self) -> np.ndarray:
        return (self.i < self.max_iter) & (np.mean(np.abs(self.window), axis=1) >= self.rel_tol)

    def record(self, lanes, elbo_new) -> None:
        """Take one new ELBO for each lane in ``lanes``."""
        old = self.elbo[lanes]
        self.window[lanes] = np.roll(self.window[lanes], -1, axis=1)
        self.window[lanes, -1] = (elbo_new - old) / np.abs(old)
        self.trace[lanes, self.i[lanes] + 1] = elbo_new
        self.elbo[lanes] = elbo_new
        self.i[lanes] += 1


def gene_draws(noises, S: int, G_local: int, dtype, device, genes=None):
    """``draw(what, lanes)``: the (len(lanes), S, G) standard normals of
    ``what`` from each lane's noise source. With ``genes`` (a
    :class:`~clonealign_torch.parallel.collectives.Genes`) each is drawn
    for every gene and sliced to this rank's block, so that every rank's
    draws are the one-process fit's."""
    G = G_local if genes is None else genes.g

    def one(noise, what):
        eps = noise.normal(what, (S, G), dtype, device)
        return eps if genes is None else eps[:, genes.start : genes.stop]

    def draw(what, lanes):
        return mm.stack_lanes([one(noises[r], what) for r in lanes])

    return draw


def run_inference(
    params: mm.CloneAlignParams,
    data: mm.ModelData,
    noise,
    config: mm.ModelConfig,
    *,
    initial_shrink: float = 5.0,
    **kwargs,
) -> InferenceResult:
    """One fit: the one-lane case of :func:`run_inference_lanes`, which
    documents the loop and the keywords."""
    result = run_inference_lanes(
        stack_lanes([params]), data, [noise], config,
        initial_shrinks=[initial_shrink], **kwargs,
    )
    return lane_result(result, 0)


def run_inference_lanes(
    params: mm.CloneAlignParams,
    data: mm.ModelData,
    noises,
    config: mm.ModelConfig,
    *,
    initial_shrinks,
    max_iter: int = 100,
    rel_tol: float = 1e-5,
    learning_rate: float = 0.1,
    window_size: int = 10,
    n_final_elbo_samples: int = 20,
    elbo_eval: str = "fresh",
    progress: bool = False,
    extra_log_lik=None,
) -> InferenceResult:
    """Fit R lanes by reparametrization-gradient VI: ``params`` carry a
    leading lane axis, lane r starts from ``initial_shrinks[r]`` and draws
    every sample from ``noises[r]`` (see ``utils/noise.py``).

    Loop semantics mirror the reference: likelihood-based gamma warm start
    (scaled by ``initial_shrink``/5); each iteration takes one Adam step on
    -ELBO with a fresh sample, then re-evaluates the ELBO with another fresh
    sample; a lane stops when the mean |relative ELBO change| over its last
    ``window_size`` iterations drops below ``rel_tol``, or at ``max_iter``.

    A stopped lane freezes (reference infer.py:154-194): it keeps its
    parameters, Adam moments and step count, window, trace and last ELBO,
    draws no noise and launches no kernel, so each lane equals the same lane
    run alone and its final draws are that run's. Adam, the window, the
    trace and the ELBO's O(N·C) terms run batched over the live lanes; every
    sum stays within a lane, so a diverged lane's NaN reaches no other lane.

    ``elbo_eval="reuse"`` monitors the value already computed for the
    gradient (pre-update, training sample) instead of a second forward pass.
    When training used z_cheb, the final ELBO is evaluated through the
    exact normalizer (reference infer.py:219-223).

    ``extra_log_lik`` (N, C), the allele term or None, enters every ELBO and
    the warm start of every lane (reference infer.py:88-226).

    Every ELBO is taken as its cell terms
    (``models/multinomial.elbo_cell_terms``) plus its global terms
    (``elbo_global_terms``). On a mesh (``data.cells``) ``data``,
    ``extra_log_lik`` and the per-cell parameters are this rank's rows, and
    every rank runs this loop with the same draws: each rank takes the
    value and gradients of its cell terms (the ranks of cell block 0 add
    the global terms), and one all_reduce over the cells group sums the
    values and the shared parameters' gradients before every rank takes
    the same step. The per-cell parameters step on their own rank. So every
    rank's ``Monitor`` sees the same ELBOs and stops and freezes the same
    lanes, and the iteration keeps its one host sync. In one process the
    all_reduce is the identity. With a genes axis (``data.genes``) the
    per-gene parameters are the rank's gene block, every (S, G) draw is
    made for every gene and sliced, and the sums over genes inside the
    ELBO reduce over the genes group (``models/multinomial``), so that
    every gene rank of a cell block holds the whole value, and the same
    per-cell gradients, before the step.
    """
    if elbo_eval not in ("fresh", "reuse"):
        raise ValueError(f"elbo_eval must be 'fresh' or 'reuse', got {elbo_eval!r}")
    R = len(noises)
    dtype, device = params.qmu_loc.dtype, params.qmu_loc.device
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    cells, genes = data.cells, data.genes
    draw = gene_draws(noises, config.mc_samples, params.qmu_loc.shape[-1], dtype, device, genes)
    every = np.arange(R)
    shared = [i for i, spec in enumerate(mm.param_specs().tensors()) if CELL_AXIS not in spec]
    owns_global = cells is None or cells.mesh.cell_coord == 0

    def own_part(p, base, cfg):
        """This rank's part of the ELBO of every lane: its cell terms, and the
        global terms on cell block 0 (in one process, the whole ELBO)."""
        part = mm.elbo_cell_terms(p, data, base, cfg, extra_log_lik)
        if owns_global:
            part = part + mm.elbo_global_terms(p, base, cfg, data.colsum_Y, genes)
        return part

    def evaluate(p, eps_list, cfg):
        """The ELBO of every lane at each draw of ``eps_list``, (R, draws)."""
        return all_sum(torch.stack([own_part(p, mm.sample_mu_base(p, e), cfg)
                                    for e in eps_list], -1), cells)

    def neg_elbo_and_grads(p, eps):
        """-ELBO of the live lanes and its gradients with respect to the
        leaves: this rank's part's, then one all_reduce of the shared
        parameters' gradients and the values."""
        part = own_part(p, mm.sample_mu_base(p, eps), config)
        grads = torch.autograd.grad(-part.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        flat = all_sum(torch.cat([grads[i].reshape(-1) for i in shared] + [-part.detach()]),
                       cells)
        sizes = [grads[i].numel() for i in shared] + [part.numel()]
        for i, piece in zip(shared, flat.split(sizes)):
            grads[i] = piece.view_as(grads[i])
        return flat[-part.numel():], grads

    with torch.no_grad():
        shrinks = torch.as_tensor(np.asarray(initial_shrinks, np.float64), dtype=dtype, device=device)
        warm = mm.gamma_warm_start_logits(params, data, draw("warm", every), shrinks, config,
                                          extra_log_lik)
        params = params.replace(gamma_logits=warm)
        elbo_val = evaluate(params, [draw("init_eval", every)], config)[..., 0].cpu().numpy()

    leaves = [t.detach().clone().requires_grad_(True) for t in params.tensors()]
    opt = TF1Adam(leaves, learning_rate, n_lanes=R)
    mon = Monitor(elbo_val, max_iter, rel_tol, window_size, np_dtype)

    def lanes_of(tensors, idx):
        return mm.CloneAlignParams(*(tensors if idx is None else [t[idx] for t in tensors]))

    active = mon.live()
    synchronize(device)
    t0 = time.perf_counter()
    while active.any():
        lanes = np.flatnonzero(active)
        # all lanes live: no gather, and the step needs no mask
        idx = None if active.all() else _upload(lanes, device)
        neg_elbo, grads = neg_elbo_and_grads(lanes_of(leaves, idx), draw("train", lanes))
        opt.step(leaves, grads, None if idx is None else active)
        if elbo_eval == "fresh":
            with torch.no_grad():
                elbo_new = evaluate(lanes_of(leaves, idx), [draw("eval", lanes)], config)[..., 0]
        else:
            elbo_new = -neg_elbo
        elbo_new = elbo_new.cpu().numpy()  # the iteration's one host sync
        mon.record(lanes, elbo_new)
        if progress:
            change = np.mean(np.abs(mon.window[lanes]), axis=1)
            for r, e, c in zip(lanes, elbo_new, change):
                lane = f"lane {r}  " if R > 1 else ""
                print(f"  {lane}VB iter {mon.i[r]:4d}  elbo {float(e):.4f}  mean|Δ| {float(c):.3e}")
        active = mon.live()
    synchronize(device)
    loop_seconds = time.perf_counter() - t0

    with torch.no_grad():
        params = mm.CloneAlignParams(*[t.detach() for t in leaves])
        finals = evaluate(params, [draw("final", every) for _ in range(n_final_elbo_samples)],
                          final_config(config))  # (R, n_final_elbo_samples)
        final_elbo = torch.mean(finals, dim=-1).cpu().numpy().astype(np.float64)
        sd_final = torch.std(finals, dim=-1, correction=1).cpu().numpy().astype(np.float64)

    return InferenceResult(
        params=params,
        elbo_trace=mon.trace,
        n_iters=mon.i,
        final_elbo=final_elbo,
        sd_final_elbo=sd_final,
        loop_seconds=loop_seconds,
    )

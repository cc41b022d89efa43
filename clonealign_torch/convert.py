"""Carry model state across from the JAX package.

The JAX package's ``CloneAlignParams`` and ``ModelData`` are NamedTuples of
arrays; ``np.asarray`` turns each field into a numpy array without this
module importing jax. The converters accept those tuples, dicts of arrays,
or anything with the same attribute names, so the two packages can compute
on identical state; a JAX package's fitted model (numpy fields) becomes the
port's by :func:`fit_from_numpy`. The v1 family's parameters, results
(with their optax state, so that a JAX run can be resumed here) and fits
come across by :func:`negbin_params_from_numpy`,
:func:`negbin_result_from_numpy` and :func:`v1_fit_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .fit import ClonealignFit, ConvergenceInfo
from .infer import OptaxAdamState
from .models.multinomial import CloneAlignParams, ModelData
from .models.negbin import ClonealignV1Fit, NegbinParams, NegbinPosterior, NegbinResult


def _field_reader(obj):
    if isinstance(obj, Mapping):
        return obj.get
    return lambda name: getattr(obj, name, None)


def _tensor(value, device, dtype):
    return torch.tensor(np.asarray(value), dtype=dtype, device=device)  # copies


def params_from_numpy(params, device, dtype=torch.float32) -> CloneAlignParams:
    """The port's parameters from a JAX ``CloneAlignParams`` (or a dict of
    arrays); a missing ``beta`` is the (G, 0) of a fit without covariates.
    Parameters with a leading lane axis, as ``jax.vmap`` returns them, keep
    it: they are the R lanes ``infer.run_inference_lanes`` takes."""
    get = _field_reader(params)
    beta = get("beta")
    if beta is None:
        beta = np.zeros(np.shape(get("W"))[:-1] + (0,))
    return CloneAlignParams(**{
        f.name: _tensor(beta if f.name == "beta" else get(f.name), device, dtype)
        for f in dataclasses.fields(CloneAlignParams)
    })


def data_from_numpy(data, device, dtype=torch.float32) -> ModelData:
    """The port's data from a JAX ``ModelData`` (or a dict of arrays). Y and
    the covariates ``X`` (None without them) are stored in ``dtype``."""
    get = _field_reader(data)
    return ModelData(**{
        f.name: None if get(f.name) is None else _tensor(get(f.name), device, dtype)
        for f in dataclasses.fields(ModelData)
    })


def fit_from_numpy(fit) -> ClonealignFit:
    """The port's :class:`~clonealign_torch.fit.ClonealignFit` from a JAX
    package's fit (its fields are numpy arrays, lists and numbers), so that
    both packages can serve against one fitted model. Arrays are copied."""
    ci = fit.convergence_info
    snv = fit.clone_probs_from_snv
    return ClonealignFit(
        clone=list(fit.clone),
        ml_params={k: np.array(v) for k, v in fit.ml_params.items()},
        convergence_info=ConvergenceInfo(final_elbo=float(ci.final_elbo),
                                         sd_final_elbo=float(ci.sd_final_elbo),
                                         elbo=np.array(ci.elbo), n_iters=int(ci.n_iters)),
        retained_genes=list(fit.retained_genes),
        correlations=np.array(fit.correlations),
        clone_names=list(fit.clone_names),
        clone_probs_from_snv=None if snv is None else np.array(snv),
        multirun_info=getattr(fit, "multirun_info", None),
    )


def negbin_params_from_numpy(params, device, dtype=torch.float32) -> NegbinParams:
    """The port's v1 parameters from a JAX ``NegbinParams`` (or a dict of
    arrays)."""
    get = _field_reader(params)
    return NegbinParams(*(_tensor(get(f), device, dtype) for f in NegbinParams._fields))


def negbin_result_from_numpy(result, device, dtype=torch.float32) -> NegbinResult:
    """The port's :class:`~clonealign_torch.models.negbin.NegbinResult` from
    a JAX ``NegbinResult``, with its optax state ``(ScaleByAdamState(count,
    mu, nu), ScaleByScheduleState(count))`` (or an empty second state for a
    constant learning rate) as an ``infer.OptaxAdamState``, so that
    ``run_negbin_em(resume_from=...)`` continues the JAX run's trajectory."""
    opt = None
    if result.opt_state is not None:
        adam, schedule = result.opt_state
        # optax's EmptyState is a NamedTuple without fields (its ``count``
        # is tuple.count): a constant learning rate has no schedule count
        count = schedule.count if "count" in getattr(schedule, "_fields", ()) else None
        opt = OptaxAdamState(
            count=int(np.asarray(adam.count)),
            mu=tuple(_tensor(m, device, dtype) for m in adam.mu),
            nu=tuple(_tensor(v, device, dtype) for v in adam.nu),
            schedule_count=None if count is None else int(np.asarray(count)),
        )
    return NegbinResult(
        params=negbin_params_from_numpy(result.params, device, dtype),
        post=NegbinPosterior(gamma=_tensor(result.post.gamma, device, dtype),
                             r=_tensor(result.post.r, device, dtype)),
        elbo_trace=np.array(result.elbo_trace),
        n_iter=int(np.asarray(result.n_iter)),
        final_elbo=float(np.asarray(result.final_elbo)),
        opt_state=opt,
        cheb_degree=getattr(result, "cheb_degree", None),
    )


def v1_fit_from_numpy(fit) -> ClonealignV1Fit:
    """The port's :class:`~clonealign_torch.models.negbin.ClonealignV1Fit`
    from a JAX package's v1 fit (numpy fields). Arrays are copied."""
    return ClonealignV1Fit(
        clone=list(fit.clone), clone_probs=np.array(fit.clone_probs),
        rho_probs=np.array(fit.rho_probs), mu=np.array(fit.mu), beta=np.array(fit.beta),
        phi=np.array(fit.phi), alpha=np.array(fit.alpha), elbo_trace=np.array(fit.elbo_trace),
        n_iter=int(fit.n_iter), final_elbo=float(fit.final_elbo),
        clone_names=list(fit.clone_names), s_mean=float(fit.s_mean),
    )

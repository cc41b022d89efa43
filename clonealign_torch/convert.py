"""Carry model state across from the JAX package.

The JAX package's ``CloneAlignParams`` and ``ModelData`` are NamedTuples of
arrays; ``np.asarray`` turns each field into a numpy array without this
module importing jax. The converters accept those tuples, dicts of arrays,
or anything with the same attribute names, so the two packages can compute
on identical state; a JAX package's fitted model (numpy fields) becomes the
port's by :func:`fit_from_numpy`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .fit import ClonealignFit, ConvergenceInfo
from .models.multinomial import CloneAlignParams, ModelData


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

"""Carry model state across from the JAX package.

The JAX package's ``CloneAlignParams`` and ``ModelData`` are NamedTuples of
arrays; ``np.asarray`` turns each field into a numpy array without this
module importing jax. The converters accept those tuples, dicts of arrays,
or anything with the same attribute names, so the two packages can compute
on identical state.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .api import _not_ported
from .models.multinomial import CloneAlignParams, ModelData


def _field_reader(obj):
    if isinstance(obj, Mapping):
        return obj.get
    return lambda name: getattr(obj, name, None)


def _tensor(value, device, dtype):
    return torch.tensor(np.asarray(value), dtype=dtype, device=device)  # copies


def params_from_numpy(params, device, dtype=torch.float32) -> CloneAlignParams:
    """The port's parameters from a JAX ``CloneAlignParams`` (or a dict of
    arrays). Covariate coefficients ``beta`` must have no columns. Parameters
    with a leading lane axis, as ``jax.vmap`` returns them, keep it: they are
    the R lanes ``infer.run_inference_lanes`` takes."""
    get = _field_reader(params)
    beta = get("beta")
    if beta is not None and np.asarray(beta).shape[-1] != 0:
        raise _not_ported("covariate coefficients beta", "covariates")
    return CloneAlignParams(**{
        f.name: _tensor(get(f.name), device, dtype)
        for f in dataclasses.fields(CloneAlignParams)
    })


def data_from_numpy(data, device, dtype=torch.float32) -> ModelData:
    """The port's data from a JAX ``ModelData`` (or a dict of arrays). Y is
    stored in ``dtype``; covariates ``X`` must be absent."""
    get = _field_reader(data)
    if get("X") is not None:
        raise _not_ported("covariates X", "covariates")
    return ModelData(**{
        f.name: _tensor(get(f.name), device, dtype)
        for f in dataclasses.fields(ModelData)
    })

"""Shared scipy-sparse detection (scipy is an optional dependency)."""

from __future__ import annotations


def is_scipy_sparse(x) -> bool:
    """True if ``x`` is a scipy sparse matrix/array; False when scipy is
    not installed (sparse inputs are then impossible anyway)."""
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover
        return False
    return sp.issparse(x)

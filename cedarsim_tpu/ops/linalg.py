"""Dense linear solves for circuit Jacobians (f64 / c128).

Circuit matrices need f64: conductances span ~15 decades.  XLA factors f64
and c128 natively on every backend this package runs on — LAPACK on the CPU,
cuSOLVER/cuBLAS (batched LU for small matrices under ``vmap``) on the GPU —
so every dense solve is ``jnp.linalg.solve`` / ``jax.scipy.linalg.lu_*``.

Replaces the reference's KLU/UMFPACK+LAPACK dependency (SURVEY.md §2.10) for
the dense path; circuits above ``core.compile.SPARSE_AUTO_THRESHOLD`` unknowns
take the static-pattern sparse LU (``ops/sparse_lu.py``) instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve(A, b):
    """A x = b for one system, or a stack of them over leading axes."""
    return jnp.linalg.solve(A, b[..., None])[..., 0]


def _rowscale(J):
    r = jnp.max(jnp.abs(J), axis=-1)
    return jnp.where(r == 0, jnp.ones_like(r), r)


def chord_factor(J):
    """Row-equilibrated LU for the chord-Newton factor-once/solve-many split.

    Circuit Jacobians mix kΩ-level conductances with unit-coefficient branch
    constraints; scaling each row by its largest entry keeps partial
    pivoting honest.  Returns the factors consumed by :func:`chord_solve`."""
    r = _rowscale(J)
    lu, piv = jax.scipy.linalg.lu_factor(J / r[..., None])
    return lu, piv, r


def chord_solve(factors, b):
    """Solve J x = b with the factors from :func:`chord_factor`."""
    lu, piv, r = factors
    return jax.scipy.linalg.lu_solve((lu, piv), b / r)

"""Dense f64/c128 solves (ops/linalg.py) against numpy's LAPACK solve on the
host: the one-shot ``solve`` and the chord-Newton ``chord_factor`` /
``chord_solve`` split, unbatched and vmapped over lanes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cedarsim_tpu.ops import linalg


def _mna_like(rng, n, batch):
    """Random systems with circuit-like row scaling: conductance rows near
    1e-3 S mixed with unit-coefficient branch rows, diagonally weighted so
    they are comfortably nonsingular."""
    shape = (batch, n, n) if batch else (n, n)
    A = rng.standard_normal(shape) + n * np.eye(n)
    scale = np.where(np.arange(n) % 3 == 0, 1.0, 1e-3)
    A = A * scale[:, None]
    b = rng.standard_normal(shape[:-1])
    return A, b


def _ref(A, b):
    return np.linalg.solve(A, b[..., None])[..., 0]


def _rel(x, ref):
    return float(np.max(np.abs(np.asarray(x) - ref))
                 / np.max(np.abs(ref)))


def _chord(A, b):
    return linalg.chord_solve(linalg.chord_factor(A), b)


@pytest.mark.parametrize("batch", [0, 16], ids=["single", "vmap16"])
@pytest.mark.parametrize("n", [2, 25, 64, 200])
def test_solve_matches_numpy(n, batch):
    A, b = _mna_like(np.random.default_rng(n + batch), n, batch)
    f = jax.jit(jax.vmap(linalg.solve) if batch else linalg.solve)
    x = f(jnp.asarray(A), jnp.asarray(b))
    assert x.dtype == jnp.float64
    assert _rel(x, _ref(A, b)) < 1e-12


@pytest.mark.parametrize("batch", [0, 16], ids=["single", "vmap16"])
@pytest.mark.parametrize("n", [2, 25, 64, 200])
def test_chord_factor_solve_matches_numpy(n, batch):
    A, b = _mna_like(np.random.default_rng(100 + n + batch), n, batch)
    f = jax.jit(jax.vmap(_chord) if batch else _chord)
    x = f(jnp.asarray(A), jnp.asarray(b))
    assert x.dtype == jnp.float64
    assert _rel(x, _ref(A, b)) < 1e-12


def test_chord_factors_reused_across_rhs():
    # factor once, solve many: every right-hand side against one factor
    A, _ = _mna_like(np.random.default_rng(7), 25, 0)
    fct = linalg.chord_factor(jnp.asarray(A))
    for k in range(3):
        b = np.random.default_rng(k).standard_normal(25)
        assert _rel(linalg.chord_solve(fct, jnp.asarray(b)), _ref(A, b)) \
            < 1e-12


def test_zero_leading_pivot_needs_row_exchange():
    A = np.array([[0.0, 2.0, 1.0],
                  [1.0, 1e-3, 0.0],
                  [3.0, 0.0, 4.0]])
    b = np.array([1.0, 2.0, 3.0])
    for fn in (linalg.solve, _chord):
        x = np.asarray(fn(jnp.asarray(A), jnp.asarray(b)))
        assert np.all(np.isfinite(x))
        assert _rel(x, _ref(A, b)) < 1e-13


def test_zero_row_is_left_unscaled():
    # an all-zero row (a floating node before gmin) must not divide by zero
    # in the row equilibration; the singular system yields non-finite
    # values, which the Newton loops detect and reject
    A = np.array([[1.0, 0.0], [0.0, 0.0]])
    r = linalg._rowscale(jnp.asarray(A))
    assert np.allclose(np.asarray(r), [1.0, 1.0])


def test_complex128_solve():
    rng = np.random.default_rng(3)
    n = 25
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
         + n * np.eye(n))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    x = linalg.solve(jnp.asarray(A), jnp.asarray(b))
    assert x.dtype == jnp.complex128
    assert _rel(x, _ref(A, b)) < 1e-12

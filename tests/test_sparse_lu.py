"""Static-pattern sparse LU (ops/sparse_lu.py) vs dense reference solves."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from cedarsim_tpu.ops import sparse_lu


def _random_circuit_like(n, rng, density=4, with_branches=True):
    """MNA-ish unsymmetric sparse matrix: diagonally-weighted conductance
    block + a few voltage-source branch rows (zero diagonal before
    matching)."""
    rows, cols, vals = [], [], []
    for i in range(n):
        rows.append(i); cols.append(i); vals.append(2.0 + rng.random())
        for _ in range(density):
            j = int(rng.integers(0, n))
            if j != i:
                v = -rng.random()
                rows += [i, j]; cols += [j, i]; vals += [v, v * (0.5 + rng.random())]
    if with_branches and n >= 8:
        # emulate V-source rows: zero diagonal, +1/-1 off-diagonals
        for b in range(3):
            i, j = n - 1 - 2 * b, int(rng.integers(0, n // 2))
            rows += [i, j]; cols += [j, i]; vals += [1.0, 1.0]
    A = np.zeros((n, n))
    for r, c, v in zip(rows, cols, vals):
        A[r, c] += v
    if with_branches and n >= 8:
        for b in range(3):
            i = n - 1 - 2 * b
            A[i, i] = 0.0   # hard zero diagonal: forces structural pivoting
    rr, cc = np.nonzero(A)
    return A, rr.astype(np.int32), cc.astype(np.int32)


@pytest.mark.parametrize("n", [5, 20, 120])
def test_sparse_lu_matches_dense(n):
    rng = np.random.default_rng(42 + n)
    A, rows, cols = _random_circuit_like(n, rng, with_branches=(n >= 8))
    plan = sparse_lu.build_plan(
        n, rows, cols, weights=A[rows, cols])
    b = jnp.asarray(rng.standard_normal(n))
    vals = sparse_lu.vals_from_dense(plan, jnp.asarray(A))
    Aj = jnp.asarray(A)
    # one refinement pass: random unsymmetric matrices have no-pivot element
    # growth that real (diagonally gmin-shunted) MNA matrices don't
    x = sparse_lu.solve(plan, vals, b, refine=1, matvec=lambda v: Aj @ v)
    x_ref = np.linalg.solve(A, np.asarray(b))
    assert np.allclose(np.asarray(x), x_ref, rtol=1e-9, atol=1e-10), (
        np.abs(np.asarray(x) - x_ref).max())


def test_sparse_lu_jit_and_vmap():
    n = 60
    rng = np.random.default_rng(7)
    A, rows, cols = _random_circuit_like(n, rng)
    plan = sparse_lu.build_plan(n, rows, cols)

    B = 8
    mats = np.stack([A * (1.0 + 0.1 * k) for k in range(B)])
    mats[:, 0, 0] += np.linspace(0, 0.5, B)  # perturb a pattern entry
    bs = rng.standard_normal((B, n))

    @jax.jit
    def solve_batch(ms, bs):
        def one(m, b):
            vals = sparse_lu.vals_from_dense(plan, m)
            return sparse_lu.solve(plan, vals, b, refine=1,
                                   matvec=lambda v: m @ v)
        return jax.vmap(one)(ms, bs)

    xs = np.asarray(solve_batch(jnp.asarray(mats), jnp.asarray(bs)))
    for k in range(B):
        ref = np.linalg.solve(mats[k], bs[k])
        assert np.allclose(xs[k], ref, rtol=1e-9, atol=1e-10)


def test_sparse_lu_refinement():
    n = 40
    rng = np.random.default_rng(3)
    A, rows, cols = _random_circuit_like(n, rng)
    # make it badly scaled
    A[0] *= 1e8
    A[:, 1] *= 1e-6
    rr, cc = np.nonzero(A)
    plan = sparse_lu.build_plan(n, rr, cc)
    b = rng.standard_normal(n)
    b[0] *= 1e8
    vals = sparse_lu.vals_from_dense(plan, jnp.asarray(A))
    Aj = jnp.asarray(A)
    x = sparse_lu.solve(plan, vals, jnp.asarray(b), refine=2,
                        matvec=lambda x: Aj @ x)
    ref = np.linalg.solve(A, b)
    assert np.allclose(np.asarray(x), ref, rtol=1e-8, atol=1e-12)


def test_gesp_zero_pivot_boost():
    """A pivot the static matching chose can be numerically zero at the
    current Newton iterate (compact-model off-state conductances).  Without
    boosting, factor() returns NaN; with GESP boosting (+refinement) the
    solve stays finite and accurate.  (The BSIM4 DFF-chain divergence root
    cause, fixed alongside MC64 max-product matching.)"""
    n = 12
    rng = np.random.default_rng(7)
    A, rows, cols = _random_circuit_like(n, rng, with_branches=False)
    # weights say the diagonal is healthy → matching sits on it
    plan = sparse_lu.build_plan(n, rows, cols,
                                weights=np.abs(A[rows, cols]))
    # ...but at this iterate one matched pivot evaluates to exactly 0
    A2 = A.copy()
    A2[5, 5] = 0.0
    vals = sparse_lu.vals_from_dense(plan, jnp.asarray(A2))
    b = rng.standard_normal(n)
    x_boost = sparse_lu.solve(
        plan, vals, jnp.asarray(b),
        refine=3, matvec=lambda x: jnp.asarray(A2) @ x,
        boost=np.sqrt(np.finfo(np.float64).eps) * np.abs(A2).max())
    assert np.isfinite(np.asarray(x_boost)).all()
    ref = np.linalg.solve(A2, b)
    assert np.allclose(np.asarray(x_boost), ref, rtol=1e-7, atol=1e-10)
    # boosting a healthy matrix must not perturb its solution either
    vals_h = sparse_lu.vals_from_dense(plan, jnp.asarray(A))
    x_h = sparse_lu.solve(
        plan, vals_h, jnp.asarray(b), refine=1,
        matvec=lambda x: jnp.asarray(A) @ x,
        boost=np.sqrt(np.finfo(np.float64).eps) * np.abs(A).max())
    assert np.allclose(np.asarray(x_h), np.linalg.solve(A, b), rtol=1e-9)


def test_mc64_matching_prefers_large_product():
    """Max-product assignment (MC64 objective): with weights present the
    matched diagonal's |a| product must be at least the greedy matching's.
    On a ring matrix whose diagonal is tiny but structurally present, the
    matching must abandon the diagonal."""
    n = 6
    A = np.full((n, n), 0.0)
    for i in range(n):
        A[i, i] = 1e-14                 # structurally present, tiny
        A[i, (i + 1) % n] = 1.0         # healthy ring
    rr, cc = np.nonzero(A)
    plan = sparse_lu.build_plan(n, rr, cc, weights=np.abs(A[rr, cc]))
    vals = sparse_lu.vals_from_dense(plan, jnp.asarray(A))
    b = np.arange(1.0, n + 1.0)
    x = sparse_lu.solve(plan, vals, jnp.asarray(b))
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), rtol=1e-10)


def test_plan_reports_levels():
    n = 100
    rng = np.random.default_rng(11)
    A, rows, cols = _random_circuit_like(n, rng)
    plan = sparse_lu.build_plan(n, rows, cols)
    assert plan.n_levels < n   # leveling actually parallelizes
    assert plan.nnz_f >= plan.nnz


def test_nd_order_cuts_level_depth():
    """Nested dissection must produce a valid permutation and an
    O(log n)-depth elimination tree on a path graph (the chain-circuit
    shape where min-degree yields a path: n_levels ~ n).  Device solves pay
    one dispatch per level, so depth is the latency metric."""
    import numpy as np
    from cedarsim_tpu.ops.sparse import nd_order
    from cedarsim_tpu.ops import sparse_lu
    n = 256
    r = np.arange(n - 1)
    c = np.arange(1, n)
    rows = np.concatenate([r, c, np.arange(n)]).astype(np.int64)
    cols = np.concatenate([c, r, np.arange(n)]).astype(np.int64)
    perm = nd_order(n, rows.astype(np.int32), cols.astype(np.int32))
    assert sorted(perm.tolist()) == list(range(n))
    p_nd = sparse_lu.build_plan(n, rows, cols, order="nd")
    p_md = sparse_lu.build_plan(n, rows, cols, order="md")
    assert p_nd.n_levels < p_md.n_levels / 4, (p_nd.n_levels, p_md.n_levels)
    # numerics on the nd plan: solve a diagonally dominant system exactly
    A = np.zeros((n, n))
    rng = np.random.default_rng(3)
    v = rng.standard_normal(n - 1) * 0.3
    A[r, c] = v
    A[c, r] = rng.standard_normal(n - 1) * 0.3
    A[np.arange(n), np.arange(n)] = 2.0 + rng.random(n)
    b = rng.standard_normal(n)
    import jax.numpy as jnp
    vals = sparse_lu.vals_from_dense(p_nd, jnp.asarray(A))
    x = sparse_lu.solve(p_nd, vals, jnp.asarray(b))
    assert float(np.max(np.abs(A @ np.asarray(x) - b))) < 1e-9


def test_nd_order_peels_global_hubs():
    """A clock/supply-style hub touching every node must not defeat the
    BFS separators (it otherwise makes every level structure two fat
    shells: 13x fill measured on the DFF chain).  The hub is peeled into
    the outermost separator and the remaining path dissects normally."""
    import numpy as np
    from cedarsim_tpu.ops.sparse import nd_order
    from cedarsim_tpu.ops import sparse_lu
    n = 257                       # path 0..255 + hub node 256
    r = np.arange(n - 2)
    c = np.arange(1, n - 1)
    hub = np.full(n - 1, n - 1)
    oth = np.arange(n - 1)
    rows = np.concatenate([r, c, hub, oth, np.arange(n)]).astype(np.int64)
    cols = np.concatenate([c, r, oth, hub, np.arange(n)]).astype(np.int64)
    perm = nd_order(n, rows.astype(np.int32), cols.astype(np.int32))
    assert sorted(perm.tolist()) == list(range(n))
    assert perm[-1] == n - 1, "hub must be eliminated last"
    p_nd = sparse_lu.build_plan(n, rows, cols, order="nd")
    p_md = sparse_lu.build_plan(n, rows, cols, order="md")
    assert p_nd.n_levels < p_md.n_levels / 3, (p_nd.n_levels, p_md.n_levels)
    assert p_nd.nnz_f < 3 * p_md.nnz_f, (p_nd.nnz_f, p_md.nnz_f)

"""Sparse-matrix Newton operations for large circuits.

Couples the batched-stamp compiler (core/compile.py) to the static-pattern
sparse LU (ops/sparse_lu.py): instead of scatter-adding per-instance local
Jacobians into dense [n,n] matrices, they scatter into flat value vectors in
the factorization's filled pattern.  This removes both the O(n^2) memory and
the dense O(n^3) solve — the role KLU plays in the reference (its
Project.toml:31), built for the device: the factorization is a static
leveled schedule of batched gathers/scatters that jits and vmaps.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp


class SparseOps:
    """Holds the plan + assembly maps for one CompiledCircuit."""

    def __init__(self, compiled, weights_probe=True):
        from cedarsim_tpu.ops import sparse_lu
        self.compiled = compiled
        n = compiled.n_x
        nv = compiled.n_nodes + compiled.n_internal

        # structural pattern from the stamp index matrices + the gmin /
        # integrator diagonal on voltage rows only (branch rows have a
        # numerically-zero diagonal — forcing it would mislead the static
        # pivot matching, see ops/sparse_lu.py)
        rows, cols = [], []
        for key in compiled.group_order:
            g = compiled.groups[key]
            r = np.broadcast_to(g.row_idx[:, :, None],
                                g.row_idx.shape + (g.var_idx.shape[1],))
            c = np.broadcast_to(g.var_idx[:, None, :], r.shape)
            rows.append(r.ravel())
            cols.append(c.ravel())
        rows.append(np.arange(nv))
        cols.append(np.arange(nv))
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        keep = (rows < n) & (cols < n)

        weights = None
        if weights_probe:
            weights = self._numeric_weights(keep)
        #: pattern-order probe weights (None when probing is off) — kept
        #: for introspection/tests of the pivot-matching inputs
        self.probe_weights = weights
        rows, cols = rows[keep].astype(np.int64), cols[keep].astype(np.int64)

        self.plan = sparse_lu.build_plan(n, rows, cols, weights=weights)
        p = self.plan

        # (row, col) -> filled position lookup for the assembly maps
        posmap = {}
        for r, c, q in zip(p.in_rows, p.in_cols, p.in_pos):
            posmap[(int(r), int(c))] = int(q)
        trash = p.nnz_f
        self.group_pos = {}
        for key in compiled.group_order:
            g = compiled.groups[key]
            ni, nr, nc_ = (g.row_idx.shape[0], g.row_idx.shape[1],
                           g.var_idx.shape[1])
            pos = np.full((ni, nr, nc_), trash, np.int32)
            for j in range(ni):
                for a in range(nr):
                    r = int(g.row_idx[j, a])
                    if r >= n:
                        continue
                    for b in range(nc_):
                        c = int(g.var_idx[j, b])
                        if c < n:
                            pos[j, a, b] = posmap[(r, c)]
            self.group_pos[key] = pos
        # gmin-shunt diagonal positions (voltage rows)
        self.vdiag_pos = np.asarray(
            [posmap[(i, i)] for i in range(nv)], np.int32)
        self.nnz_f = p.nnz_f

    def _numeric_weights(self, keep):
        """Representative |G|+|C| magnitudes over a couple of bias points to
        guide the static pivot matching (runs eagerly on the host CPU,
        once).  Probes PER-GROUP local jacobians raveled in the exact
        structural-pattern order built above — O(nnz) memory instead of the
        dense [n, n] scatter (287 MB at 4k unknowns, 18 GB at 32k), no XLA
        compile (eager vmap dispatch is O(model primitives), not O(n)), and
        no interaction with an ambient trace when the plan is built lazily
        from inside a jitted solver.  ``keep`` is the ground-row/col filter
        applied to the pattern; the trailing nv diagonal entries enter with
        the floor weight only (build_plan accumulates duplicates)."""
        compiled = self.compiled
        from cedarsim_tpu.core.context import SimSpec
        cpu = jax.devices("cpu")[0]
        n = compiled.n_x
        nv = compiled.n_nodes + compiled.n_internal
        rng = np.random.default_rng(0)
        parts = []
        with jax.ensure_compile_time_eval(), jax.default_device(cpu):
            # ctx built inside the CPU-device scope: this planning is
            # one-off host math on concrete values, so its scalars stay on
            # the host rather than paying device transfers
            ctx = SimSpec.make(mode="dcop")
            ctx_e = compiled._ctx_eval(ctx)
            probes = [np.zeros(n + 1),
                      np.concatenate([0.5 + 0.1 * rng.standard_normal(n),
                                      [0.0]])]
            ed = np.dtype(compiled.eval_dtype)
            for key in compiled.group_order:
                g = compiled.groups[key]
                gp = compiled.params0[key]
                sp = g.static_params
                # inputs prepared in numpy and committed to the host CPU:
                # the probes are many tiny eager evaluations, which the host
                # runs without a device round trip each
                pv = {k: jax.device_put(np.asarray(v).astype(ed), cpu)
                      for k, v in gp.items() if k != "$mult"}
                ne = (g.model.n_noise + getattr(g.model, "n_delay", 0)
                      + getattr(g.model, "n_latch", 0))
                e0 = jnp.zeros(ne, compiled.eval_dtype)

                def local_jac(l, p, _g=g, _sp=sp, _e0=e0):
                    Js, Jq = jax.jacfwd(
                        lambda ll: _g.model.eval(ll, {**_sp, **p}, ctx_e,
                                                 _e0))(l)
                    return jnp.abs(Js) + jnp.abs(Jq)

                vjac = jax.jit(jax.vmap(local_jac))
                W = 0.0
                for x_pad in probes:
                    lv = jax.device_put(
                        np.asarray(x_pad[g.var_idx]).astype(ed), cpu)
                    Jl = vjac(lv, pv)                  # [ni, nr, nc]
                    W = W + np.asarray(Jl, np.float64)
                # the real assembly scales KCL rows by the $mult instance
                # multiplier (res_jacs_sparse / compile.py) — without it a
                # device with m>>1 probes m× weaker than its actual matrix
                # entries and the pivot matching can prefer numerically
                # weaker pivots on m=-heavy netlists (ADVICE r3)
                mult = np.asarray(gp["$mult"], np.float64)
                kcl = np.asarray(g.kcl_mask, bool)
                W = W * np.where(kcl[None, :, None], mult[:, None, None],
                                 1.0)
                # NaN-producing probe points (e.g. off-bias compact models)
                # must not poison the matching — treat as unknown magnitude
                parts.append(np.nan_to_num(W, nan=0.0, posinf=0.0).ravel())
        parts.append(np.zeros(nv))
        w = np.concatenate(parts)[np.asarray(keep)]
        # entries can be numerically zero at both probes yet active at other
        # biases; give them a small floor so they stay matchable
        return w + 1e-30

    # ------------------------------------------------------------- numerics

    def res_jacs_sparse(self, x, ctx, params=None, eps=None, dly=None):
        """(S, Q, Gv, Cv): residual vectors plus Jacobian *value vectors* in
        the filled sparse pattern — fused single walk per group."""
        compiled = self.compiled
        params = compiled.params0 if params is None else params
        x_pad = jnp.concatenate([x, jnp.zeros(1, x.dtype)])
        if eps is None:
            eps = jnp.zeros(max(compiled.n_eps, 1), x.dtype)
        if dly is None:
            dly = compiled._dly0(x)
        S = compiled._zeros_pad()
        Q = compiled._zeros_pad()
        Gv = jnp.zeros(self.nnz_f + 1, compiled.dtype)
        Cv = jnp.zeros(self.nnz_f + 1, compiled.dtype)
        ctx_e = compiled._ctx_eval(ctx)
        for key in compiled.group_order:
            g = compiled.groups[key]
            gp = params[key]
            lv = compiled._cast_eval(x_pad[g.var_idx])
            le = compiled._aux(g, eps, dly)
            pv = {k: compiled._cast_eval(v) for k, v in gp.items()
                  if k != "$mult"}
            sp = g.static_params

            def one(l, p, e):
                def f(ll):
                    s, q = g.model.eval(ll, {**sp, **p}, ctx_e, e)
                    return (s, q), (s, q)
                (Js, Jq), (sv, qv) = jax.jacfwd(f, has_aux=True)(l)
                return sv, qv, Js, Jq

            sv, qv, Js, Jq = jax.vmap(one)(lv, pv, le)
            scale_r = jnp.where(jnp.asarray(g.kcl_mask)[None, :],
                                gp["$mult"][:, None], 1.0)
            S = S.at[g.row_idx].add(sv.astype(compiled.dtype) * scale_r)
            Q = Q.at[g.row_idx].add(qv.astype(compiled.dtype) * scale_r)
            pos = self.group_pos[key]
            Gv = Gv.at[pos].add(Js.astype(compiled.dtype)
                                * scale_r[:, :, None])
            Cv = Cv.at[pos].add(Jq.astype(compiled.dtype)
                                * scale_r[:, :, None])
        return S[:-1], Q[:-1], Gv[:-1], Cv[:-1]

    def add_diag(self, vals, d):
        """vals + diag(d) on voltage rows (gmin shunts, d: [nv] or scalar)."""
        return vals.at[self.vdiag_pos].add(d)

    def factorize(self, vals):
        """Equilibrate + factor once; returns an opaque factorization for
        ``solve_factorized`` — the factor/solve split that lets a chord
        (modified) Newton freeze one factorization across iterations, the
        role KLU's klu_factor/klu_solve split plays in the reference stack.

        GESP static-pivoted recipe (SuperLU-DIST, static schedule):

        1. row+column equilibration A′ = D_r·A·D_c (MNA entries span ~20
           decades for compact models; scaling tames the element growth a
           no-numerical-pivoting factorization would otherwise suffer),
        2. factor with small pivots boosted to √ε (ops/sparse_lu.py)."""
        from cedarsim_tpu.ops import sparse_lu
        n = self.compiled.n_x
        arow = jnp.asarray(self.plan.pos_arow)
        acol = jnp.asarray(self.plan.pos_acol)
        tiny = jnp.finfo(vals.dtype).tiny
        rmax = jax.ops.segment_max(jnp.abs(vals), arow, num_segments=n)
        dr = 1.0 / jnp.maximum(rmax, tiny)
        vs = vals * dr[arow]
        cmax = jax.ops.segment_max(jnp.abs(vs), acol, num_segments=n)
        dc = 1.0 / jnp.maximum(cmax, tiny)
        vs = vs * dc[acol]
        tau = jnp.sqrt(jnp.finfo(vals.dtype).eps)   # ‖A′‖∞ = 1 by scaling
        f = sparse_lu.factor(self.plan, vs, boost=tau)
        return (f, dr, dc)

    def solve_factorized(self, fct, vals, rhs, refine: int = 1):
        """Solve A x = rhs with a factorization from ``factorize(vals)``;
        ``refine`` iterative-refinement passes against the unfactored values
        recover the digits the boosted static pivots perturbed."""
        from cedarsim_tpu.ops import sparse_lu
        f, dr, dc = fct

        def solve_scaled(b):
            # A x = b  ⇔  A′·(D_c⁻¹ x) = D_r b
            return dc * sparse_lu.solve_factored(self.plan, f, b * dr)

        x = solve_scaled(rhs)
        for _ in range(refine):
            r = rhs - self.matvec(vals, x)
            x = x + solve_scaled(r)
        return x

    def solve(self, vals, rhs, refine: int = 1):
        """One-shot factor + solve (see factorize/solve_factorized)."""
        return self.solve_factorized(self.factorize(vals), vals, rhs,
                                     refine=refine)

    def matvec(self, vals, v):
        """y = A·v for a value vector in the filled pattern (A-space
        indices; fill positions hold 0 for unassembled entries)."""
        contrib = vals * v[self.plan.pos_acol]
        return jax.ops.segment_sum(contrib, jnp.asarray(self.plan.pos_arow),
                                   num_segments=self.compiled.n_x)

    def mask_rows(self, vals, keep):
        """Scale every stored value by keep[row] (for .ic row overwrites)."""
        return vals * keep[self.plan.pos_arow]

    def add_a_diag(self, vals, d):
        """vals + diag(d) wherever A[i,i] is structurally present."""
        pos = self.plan.a_diag_pos
        ok = pos >= 0
        safe = np.where(ok, pos, 0)
        return vals.at[safe].add(jnp.where(jnp.asarray(ok), d, 0.0))


def get_sparse_ops(compiled) -> SparseOps:
    ops = compiled.__dict__.get("_sparse_ops")
    if ops is None:
        ops = SparseOps(compiled)
        compiled.__dict__["_sparse_ops"] = ops
    return ops

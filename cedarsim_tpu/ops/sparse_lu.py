"""Static-pattern sparse LU on the device — the KLU replacement for large circuits.

The reference Newton-solves through KLU (/root/reference/Project.toml:31,
SURVEY.md §2.10).  A device kernel needs static shapes and a static schedule, so
the factorization is split:

* **Plan (host, once per circuit)**: structural pivoting (bipartite matching
  for a zero-free diagonal), minimum-degree ordering on the symmetrized
  pattern (native C++ planner with Python fallback, ops/sparse.py), symbolic
  LU with fill, and a *leveled* elimination schedule — pivots grouped by
  elimination-tree depth execute together, so the numeric phase is a short
  static sequence of vectorized gather / divide / scatter-add steps instead
  of an n-step scalar loop.

* **Numeric (device, per solve)**: ``factor(plan, vals)`` runs the level
  schedule over a flat value vector in the filled pattern; ``solve`` does
  leveled forward/backward substitution.  Everything is index-gather based,
  so it jits, vmaps over sweep lanes, and runs in any dtype.

No numerical pivoting — MNA matrices get a zero-free diagonal from the
structural matching plus gmin shunts; optional iterative refinement recovers
the last digits (``refine=``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp


# ---------------------------------------------------------------- host plan

@dataclasses.dataclass(frozen=True)
class SparsePlan:
    n: int
    #: row/col of each stored position (original matrix indices, pre-perm)
    nnz: int                   # input pattern nonzeros
    nnz_f: int                 # filled pattern nonzeros
    #: input pattern → filled-value-vector position
    in_pos: np.ndarray         # [nnz] int32
    #: original (row, col) of each input-pattern entry, for assembly maps
    in_rows: np.ndarray
    in_cols: np.ndarray
    #: permutations: factorized M[i,j] = A[rperm[i], cperm[j]]
    rperm: np.ndarray          # [n] row of A supplying permuted row i
    cperm: np.ndarray          # [n] col of A supplying permuted col j
    #: value-vector position of each diagonal M[k,k]
    diag_pos: np.ndarray       # [n] int32
    #: position of A[i,i] in the value vector, -1 where absent
    a_diag_pos: np.ndarray     # [n] int32
    #: A-space row / col of every stored position
    pos_arow: np.ndarray       # [nnz_f] int32
    pos_acol: np.ndarray       # [nnz_f] int32
    #: per-level schedules (static python lists of index arrays)
    div_dst: tuple             # each [m_l] positions of L entries to scale
    div_piv: tuple             # each [m_l] positions of their pivots
    upd_dst: tuple             # each [u_l] positions receiving -L*U
    upd_l: tuple
    upd_u: tuple
    #: forward/backward substitution schedules (leveled)
    f_lev: tuple               # each level: (dst_rows [m], src_cols [m], pos [m])
    b_lev: tuple
    n_levels: int
    #: packed level schedules for the fori_loop numeric path (empty when
    #: n_levels <= UNROLL_LEVELS: small plans stay unrolled).  Each "run"
    #: is a contiguous band of levels padded to the band's max width, so
    #: the compiled program is O(#runs) instead of O(#levels) — the
    #: unrolled sweep made XLA compile time scale with circuit depth
    #: (measured: 452-unknown chain 67.9k HLO lines unrolled).
    fact_runs: tuple = ()      # (DD, DP, UD, UL, UU) per run, [L, w*] each
    fwd_runs: tuple = ()       # (ROWS, COLS, POS) per run
    bwd_runs: tuple = ()       # (ROWS, COLS, POS, DIAG_I, DIAG_P) per run

    def tree_flatten(self):
        return (), self

    def tree_unflatten(aux, _):
        return aux


#: level-count threshold below which the numeric phase stays unrolled
#: (small circuits: unrolling compiles fast anyway and avoids loop
#: dispatch overhead per level)
UNROLL_LEVELS = 40

#: padded-size/true-size budget when packing contiguous level bands — a
#: new level joins the current band only while total padding stays below
#: this factor (wide early levels and narrow late levels land in
#: different bands)
_PACK_WASTE = 2.0


def _pack_runs(levels, slot_groups):
    """Pack a list of per-level tuples-of-index-arrays into contiguous
    padded bands.  ``slot_groups``: [(slot_indices, pad_value), ...] —
    slots in one group share their natural length and are padded to the
    group's per-band max.  Returns a tuple of runs, each a tuple of
    [n_lev_in_run, w_group] int32 arrays in original slot order."""
    if not levels:
        return ()

    def cost(lv):
        return sum(len(lv[g[0][0]]) for g in slot_groups)

    widths = [cost(lv) for lv in levels]
    runs = []
    start = 0
    while start < len(levels):
        end = start + 1
        wmax = widths[start]
        tot = widths[start]
        while end < len(levels):
            w2 = max(wmax, widths[end])
            if w2 * (end - start + 1) > _PACK_WASTE * (tot + widths[end]) \
                    + 8 * (end - start + 1):
                break
            wmax = w2
            tot += widths[end]
            end += 1
        band = levels[start:end]
        n_slots = max(max(g[0]) for g in slot_groups) + 1
        packed = [None] * n_slots
        for slots, pads in slot_groups:
            gw = max(len(lv[slots[0]]) for lv in band)
            for slot, pad in zip(slots, pads):
                arrs = []
                for lv in band:
                    a = np.asarray(lv[slot], np.int32)
                    if len(a) < gw:
                        a = np.concatenate(
                            [a, np.full(gw - len(a), int(pad), np.int32)])
                    arrs.append(a)
                packed[slot] = np.stack(arrs)
        runs.append(tuple(packed))
        start = end
    return tuple(runs)


def _structural_matching(n, rows, cols, weights=None):
    """Kuhn's bipartite matching row->col so the permuted diagonal is
    structurally nonzero (static replacement for partial pivoting; KLU uses
    BTF+numeric pivoting, MNA + a weight-guided matching makes static
    pivoting sufficient).  ``weights``: representative |A| entries — rows
    greedily take their largest entry first, and entries below 1e-12 of
    their row max are used only as a last resort.

    With weights, an MC64-style max-product assignment (maximize
    Σ log|a_{i,σ(i)}| — the HSL MC64 objective Duff & Koster 2001, via
    scipy's sparse Jonker-Volgenant) replaces the greedy matching: static
    pivoting's element growth is governed by how large the matched
    diagonal is, and greedy-by-row leaves late rows stuck with tiny
    pivots (observed: BSIM4 DFF-chain Jacobians factor to NaN/1e16
    residuals under greedy, converge under max-product)."""
    if weights is not None:
        try:
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import (
                min_weight_full_bipartite_matching)
            w = np.maximum(np.asarray(weights, np.float64), 1e-300)
            rowmax = np.zeros(n)
            np.maximum.at(rowmax, np.asarray(rows, np.int64), w)
            cost = 1.0 + np.log(np.maximum(rowmax[rows], 1e-300) / w)
            A = csr_matrix((cost, (rows, cols)), shape=(n, n))
            rr, cc = min_weight_full_bipartite_matching(A)
            match_row = np.full(n, -1, np.int64)
            match_row[rr] = cc
            if (match_row >= 0).all():
                return match_row
        except Exception:
            pass     # structurally-deficient or scipy absent → greedy path
    adj = [[] for _ in range(n)]
    went = [[] for _ in range(n)]
    for t, (r, c) in enumerate(zip(rows, cols)):
        adj[int(r)].append(int(c))
        went[int(r)].append(1.0 if weights is None else float(weights[t]))
    for r in range(n):
        order = np.argsort(went[r])[::-1]
        rowmax = went[r][order[0]] if len(order) else 0.0
        # deprioritize structurally-present-but-numerically-tiny entries
        good = [adj[r][i] for i in order
                if went[r][i] > 1e-12 * rowmax]
        rest = [adj[r][i] for i in order
                if went[r][i] <= 1e-12 * rowmax]
        adj[r] = good + rest
    match_col = np.full(n, -1, np.int64)   # col -> row
    match_row = np.full(n, -1, np.int64)   # row -> col
    # greedy pass: each row takes its best unclaimed column
    for r in range(n):
        for c in adj[r][:1]:
            if match_col[c] < 0:
                match_row[r] = c
                match_col[c] = r

    def try_augment(r, seen):
        for c in adj[r]:
            if seen[c]:
                continue
            seen[c] = True
            if match_col[c] < 0 or try_augment(match_col[c], seen):
                match_col[c] = r
                match_row[r] = c
                return True
        return False

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 2 * n + 100))
    try:
        for r in range(n):
            if match_row[r] < 0:
                if not try_augment(r, np.zeros(n, bool)):
                    raise ValueError(
                        f"structurally singular matrix: row {r} cannot be "
                        "matched to any column")
    finally:
        sys.setrecursionlimit(old)
    return match_row  # row r of A goes with col match_row[r]


def build_plan(n, rows, cols, perm=None, weights=None,
               order="auto") -> SparsePlan:
    """Symbolic factorization. ``rows``/``cols``: the exact structural
    pattern of A (duplicates allowed).  Include diagonal entries only where
    they are numerically present (gmin shunts / integrator terms) — a forced
    full diagonal would let the pivot matching sit on numerically-zero
    positions (V-source branch rows).  ``weights``: representative |A[r,c]|
    per input entry to guide the static pivot matching.

    ``order``: fill-reducing ordering — "md" (minimum degree: best fill,
    long elimination path; the CPU/KLU-style choice), "nd" (nested
    dissection: O(log n)-depth elimination tree so the leveled on-device
    sweeps dispatch far fewer sequential steps), or "auto" (md, unless the
    CEDARSIM_SPARSE_ORDER environment variable names "md" or "nd")."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    key0 = rows * n + cols
    key, first, inv = np.unique(key0, return_index=True,
                                return_inverse=True)
    if weights is not None:
        w = np.zeros(len(key), np.float64)
        np.add.at(w, inv, np.abs(np.asarray(weights, np.float64)))
        weights = w
    rows, cols = rows[first], cols[first]

    # structural pivoting: row r supplies column match[r]; we want
    # M[i,j] = A[rperm[i], cperm[j]] with M diag nonzero.
    match_row = _structural_matching(n, rows, cols, weights)
    # choose cperm = identity on matched labels: permuted column j is A's
    # column j; permuted row holding its pivot is the row matched to col j.
    row_of_col = np.empty(n, np.int64)
    row_of_col[match_row] = np.arange(n)

    # pattern in "matched" space: Mrow i = A row row_of_col[i] → M[i, j]
    inv_row = np.empty(n, np.int64)
    inv_row[row_of_col] = np.arange(n)
    m_rows = inv_row[rows]
    m_cols = cols

    # fill-reducing ordering on symmetrized matched pattern
    if perm is None:
        from cedarsim_tpu.ops.sparse import md_order, nd_order
        sym_r = np.concatenate([m_rows, m_cols])
        sym_c = np.concatenate([m_cols, m_rows])
        kk = sym_r * n + sym_c
        kk, fi = np.unique(kk, return_index=True)
        if order == "auto":
            import os
            env = os.environ.get("CEDARSIM_SPARSE_ORDER")
            if env in ("md", "nd"):
                order = env
            else:
                # md everywhere: the packed fori_loop amortizes level
                # dispatch on-device, so per-solve cost follows FILL, and
                # nd's fill premium cancels its shorter level count.  nd
                # stays available for genuinely dispatch-bound setups.
                order = "md"
        fn = nd_order if order == "nd" else md_order
        perm = fn(n, sym_r[fi].astype(np.int32),
                  sym_c[fi].astype(np.int32))
    perm = np.asarray(perm, np.int64)
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)

    # final permutations back to A indices
    rperm = row_of_col[perm]           # A-row supplying permuted row i
    cperm = perm.copy()                # A-col supplying permuted col j

    p_rows = iperm[m_rows]
    p_cols = iperm[m_cols]

    # symbolic LU with fill on the permuted pattern (set-based left-looking)
    up_cols = [set() for _ in range(n)]   # U row k: columns j > k
    lo_rows = [set() for _ in range(n)]   # L col k: rows i > k
    diag_ok = np.zeros(n, bool)
    for r, c in zip(p_rows, p_cols):
        if r < c:
            up_cols[r].add(int(c))
        elif r > c:
            lo_rows[c].add(int(r))
        else:
            diag_ok[r] = True
    assert diag_ok.all(), "matching failed to produce a zero-free diagonal"
    for k in range(n):
        li = sorted(lo_rows[k])
        ui = sorted(up_cols[k])
        for i in li:
            for j in ui:
                if i == j:
                    continue
                if i > j:
                    lo_rows[j].add(i)
                else:
                    up_cols[i].add(j)

    # final filled pattern
    fr, fc = [], []
    for k in range(n):
        fr.append(k); fc.append(k)
        for j in up_cols[k]:
            fr.append(k); fc.append(j)
        for i in lo_rows[k]:
            fr.append(i); fc.append(k)
    fr = np.asarray(fr, np.int64)
    fc = np.asarray(fc, np.int64)
    fkey = fr * n + fc
    order = np.argsort(fkey)
    fr, fc, fkey = fr[order], fc[order], fkey[order]
    nnz_f = len(fr)
    pos_of = {int(k): i for i, k in enumerate(fkey)}

    # levels: pivot k's stage comes after every pivot j<k with L[k,j]≠0 or
    # U[j,k]≠0; compute depths from the filled pattern
    level = np.zeros(n, np.int64)
    for idx in range(nnz_f):
        i, j = int(fr[idx]), int(fc[idx])
        if i > j:        # L[i,j]: pivot j updates row i → stage i after j
            if level[j] + 1 > level[i]:
                level[i] = level[j] + 1
        elif i < j:      # U[i,j]: pivot i updates col j → stage j after i
            if level[i] + 1 > level[j]:
                level[j] = level[i] + 1
    # NOTE: single forward sweep is valid because updates only flow from
    # lower-numbered pivots to higher ones, and the pattern scan above visits
    # (i, j) in row-major order... which does NOT guarantee topological
    # order for L entries (i > j seen when scanning row i: level[j] is final
    # since j < i only for L; for U entries (i < j), level[i] final since
    # i < j).  Row-major scan visits row i after all rows < i, so for L[i,j]
    # (j < i) level[j] is final, and for U[i,j] (i < j) level[i] is final
    # within row i's scan — both final. OK.

    n_levels = int(level.max()) + 1 if n else 0

    # per-level div/update schedules
    div_dst, div_piv, upd_dst, upd_l, upd_u = [], [], [], [], []
    for lv in range(n_levels):
        dd, dp, ud, ul, uu = [], [], [], [], []
        for k in np.nonzero(level == lv)[0]:
            k = int(k)
            kpiv = pos_of[k * n + k]
            li = sorted(lo_rows[k])
            ui = sorted(up_cols[k])
            for i in li:
                dd.append(pos_of[i * n + k])
                dp.append(kpiv)
            for i in li:
                pl = pos_of[i * n + k]
                for j in ui:
                    ud.append(pos_of[i * n + j])
                    ul.append(pl)
                    uu.append(pos_of[k * n + j])
        div_dst.append(np.asarray(dd, np.int32))
        div_piv.append(np.asarray(dp, np.int32))
        upd_dst.append(np.asarray(ud, np.int32))
        upd_l.append(np.asarray(ul, np.int32))
        upd_u.append(np.asarray(uu, np.int32))

    # substitution levels (forward: y[i] -= L[i,j] y[j]; depth over L-dag)
    flev = np.zeros(n, np.int64)
    for idx in range(nnz_f):
        i, j = int(fr[idx]), int(fc[idx])
        if i > j and flev[j] + 1 > flev[i]:
            flev[i] = flev[j] + 1
    f_lev = []
    for lv in range(1, int(flev.max()) + 1 if n else 0):
        rows_l, cols_l, pos_l = [], [], []
        for idx in range(nnz_f):
            i, j = int(fr[idx]), int(fc[idx])
            if i > j and flev[i] == lv:
                rows_l.append(i); cols_l.append(j); pos_l.append(idx)
        f_lev.append((np.asarray(rows_l, np.int32),
                      np.asarray(cols_l, np.int32),
                      np.asarray(pos_l, np.int32)))
    # backward-substitution levels: x[i] needs x[j] for U[i,j]≠0 (j > i) —
    # depth over the U-dag, computed in reverse row order (topological)
    blev = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        for j in sorted(up_cols[i]):
            if blev[j] + 1 > blev[i]:
                blev[i] = blev[j] + 1
    b_lev = []
    maxb = int(blev.max()) if n else 0
    for lv in range(0, maxb + 1):
        rows_l, cols_l, pos_l = [], [], []
        for i in np.nonzero(blev == lv)[0]:
            i = int(i)
            for j in sorted(up_cols[i]):
                rows_l.append(i); cols_l.append(j)
                pos_l.append(pos_of[i * n + j])
        b_lev.append((np.asarray(rows_l, np.int32),
                      np.asarray(cols_l, np.int32),
                      np.asarray(pos_l, np.int32),
                      np.asarray([int(i) for i in np.nonzero(blev == lv)[0]],
                                 np.int32)))

    # input-pattern positions in the filled vector (for assembly)
    p_in_r = iperm[inv_row[rows]]
    p_in_c = iperm[cols]
    in_pos = np.asarray([pos_of[int(r) * n + int(c)]
                         for r, c in zip(p_in_r, p_in_c)], np.int32)
    diag_pos = np.asarray([pos_of[k * n + k] for k in range(n)], np.int32)

    # A-space helpers for solver-side matrix edits:
    # position of A[i,i] (−1 where structurally absent) and the A-row of
    # every stored position (for row masking, e.g. .ic row overwrites)
    irperm = np.empty(n, np.int64)
    irperm[rperm] = np.arange(n)
    icperm = np.empty(n, np.int64)
    icperm[cperm] = np.arange(n)
    a_diag_pos = np.full(n, -1, np.int64)
    for i in range(n):
        kk = int(irperm[i]) * n + int(icperm[i])
        if kk in pos_of:
            a_diag_pos[i] = pos_of[kk]
    pos_arow = rperm[fr]

    # packed fori_loop schedules for deep plans (program size O(#runs))
    fact_runs = fwd_runs = bwd_runs = ()
    if n_levels > UNROLL_LEVELS:
        pad_piv = int(diag_pos[0])
        fact_runs = _pack_runs(
            [(div_dst[lv], div_piv[lv], upd_dst[lv], upd_l[lv], upd_u[lv])
             for lv in range(n_levels)],
            [((0, 1), (nnz_f, pad_piv)),
             ((2, 3, 4), (nnz_f, nnz_f, nnz_f))])
        fwd_runs = _pack_runs(
            list(f_lev), [((0, 1, 2), (n, n, nnz_f))])
        bwd_runs = _pack_runs(
            [(r, c, p, d, diag_pos[d]) for r, c, p, d in b_lev],
            [((0, 1, 2), (n, n, nnz_f)), ((3, 4), (n, pad_piv))])

    return SparsePlan(
        n=n, nnz=len(rows), nnz_f=nnz_f,
        in_pos=in_pos, in_rows=rows.astype(np.int32),
        in_cols=cols.astype(np.int32),
        rperm=rperm.astype(np.int32), cperm=cperm.astype(np.int32),
        diag_pos=diag_pos,
        a_diag_pos=a_diag_pos.astype(np.int32),
        pos_arow=np.asarray(pos_arow, np.int32),
        pos_acol=np.asarray(cperm[fc], np.int32),
        div_dst=tuple(div_dst), div_piv=tuple(div_piv),
        upd_dst=tuple(upd_dst), upd_l=tuple(upd_l), upd_u=tuple(upd_u),
        f_lev=tuple(f_lev), b_lev=tuple(b_lev), n_levels=n_levels,
        fact_runs=fact_runs, fwd_runs=fwd_runs, bwd_runs=bwd_runs)


# ------------------------------------------------------------- device kernel

def vals_from_dense(plan: SparsePlan, A):
    """Gather the filled-pattern value vector from a dense matrix (testing /
    small-n path; circuit assembly scatters directly via ``in_pos``)."""
    v = jnp.zeros(plan.nnz_f, A.dtype)
    return v.at[plan.in_pos].add(A[plan.in_rows, plan.in_cols])


def matvec(plan: SparsePlan, vals, x):
    """A @ x from UNfactored filled values (fill positions hold zeros)."""
    return jax.ops.segment_sum(vals * x[plan.pos_acol], plan.pos_arow,
                               num_segments=plan.n)


def _boosted(p, tau):
    return jnp.where(jnp.abs(p) < tau,
                     jnp.where(p < 0, -tau, tau), p)


def factor(plan: SparsePlan, vals, boost: float | jax.Array = 0.0):
    """Numeric LU over the filled value vector (leveled static schedule).

    ``boost``: GESP-style small-pivot boosting threshold (SuperLU-DIST's
    static-pivoting recipe: τ = √ε·‖A‖).  The static matching can land on
    a position that is structurally fine but numerically ~0 at the current
    iterate (compact-model off-state conductances); without numerical
    pivoting a zero pivot turns the whole factorization to NaN.  Pivots
    with |p| < τ are replaced by sign(p)·τ — the boosted value is written
    back so factor and solve stay consistent — and iterative refinement
    (``solve(refine=)``) recovers the perturbed digits."""
    do_boost = not (isinstance(boost, float) and boost == 0.0)
    if plan.fact_runs:
        # deep plan: fori_loop over padded level bands (padding lanes
        # read/write the scratch slot nnz_f, which starts and stays 0)
        vals = jnp.concatenate([vals, jnp.zeros((1,), vals.dtype)])
        for DD, DP, UD, UL, UU in plan.fact_runs:
            DD, DP = jnp.asarray(DD), jnp.asarray(DP)
            UD, UL, UU = jnp.asarray(UD), jnp.asarray(UL), jnp.asarray(UU)

            def body(lv, v, DD=DD, DP=DP, UD=UD, UL=UL, UU=UU):
                dd, dp = DD[lv], DP[lv]
                pv = v[dp]
                if do_boost:
                    pv = _boosted(pv, boost)
                    v = v.at[dp].set(pv)
                v = v.at[dd].set(v[dd] / pv)
                ud, ul, uu = UD[lv], UL[lv], UU[lv]
                v = v.at[ud].add(-v[ul] * v[uu])
                return v

            vals = jax.lax.fori_loop(0, DD.shape[0], body, vals)
        vals = vals[:-1]
    else:
        for lv in range(plan.n_levels):
            dd, dp = plan.div_dst[lv], plan.div_piv[lv]
            if len(dd):
                if do_boost:
                    pb = _boosted(vals[dp], boost)
                    vals = vals.at[dp].set(pb)
                    vals = vals.at[dd].set(vals[dd] / pb)
                else:
                    vals = vals.at[dd].set(vals[dd] / vals[dp])
            ud, ul, uu = plan.upd_dst[lv], plan.upd_l[lv], plan.upd_u[lv]
            if len(ud):
                vals = vals.at[ud].add(-vals[ul] * vals[uu])
    if do_boost:
        # pivots never used by a division level (trailing columns) are
        # still divisors in back-substitution — boost them too (idempotent
        # for already-boosted values)
        d = vals[plan.diag_pos]
        vals = vals.at[plan.diag_pos].set(_boosted(d, boost))
    return vals


def solve_factored(plan: SparsePlan, f, b):
    """Solve A x = b given factored values ``f`` (L unit-diagonal)."""
    if plan.fwd_runs or plan.bwd_runs:
        # deep plan: fori_loop over padded bands; scratch slots x[n] and
        # f[nnz_f] absorb the padding lanes (f scratch = 0, so padded
        # multiplies contribute exactly 0 to real rows)
        n = plan.n
        fe = jnp.concatenate([f, jnp.zeros((1,), f.dtype)])
        y = jnp.concatenate([b[plan.rperm], jnp.zeros((1,), b.dtype)])
        for ROWS, COLS, POS in plan.fwd_runs:
            ROWS, COLS, POS = map(jnp.asarray, (ROWS, COLS, POS))

            def fbody(lv, y, ROWS=ROWS, COLS=COLS, POS=POS):
                r, c, p = ROWS[lv], COLS[lv], POS[lv]
                return y.at[r].add(-fe[p] * y[c])

            y = jax.lax.fori_loop(0, ROWS.shape[0], fbody, y)
        x = y
        for ROWS, COLS, POS, DI, DP in plan.bwd_runs:
            ROWS, COLS, POS, DI, DP = map(jnp.asarray,
                                          (ROWS, COLS, POS, DI, DP))

            def bbody(lv, x, ROWS=ROWS, COLS=COLS, POS=POS, DI=DI, DP=DP):
                r, c, p = ROWS[lv], COLS[lv], POS[lv]
                acc = jax.ops.segment_sum(fe[p] * x[c], r,
                                          num_segments=n + 1)
                x = x - acc
                di, dp = DI[lv], DP[lv]
                return x.at[di].set(x[di] / fe[dp])

            x = jax.lax.fori_loop(0, ROWS.shape[0], bbody, x)
        out = jnp.zeros((n,), x.dtype)
        out = out.at[plan.cperm].set(x[:n])
        return out
    y = b[plan.rperm]
    for rows_l, cols_l, pos_l in plan.f_lev:
        y = y.at[rows_l].add(-f[pos_l] * y[cols_l])
    x = y
    # ascending levels: level-0 rows have no U entries (finalized first)
    for lv in range(len(plan.b_lev)):
        rows_l, cols_l, pos_l, diag_i = plan.b_lev[lv]
        if len(rows_l):
            acc = jax.ops.segment_sum(
                f[pos_l] * x[cols_l], rows_l, num_segments=plan.n)
            x = x - acc
        x = x.at[diag_i].set(x[diag_i] / f[plan.diag_pos[diag_i]])
    out = jnp.zeros_like(x)
    out = out.at[plan.cperm].set(x)
    return out


def solve(plan: SparsePlan, vals, b, refine: int = 0, matvec=None,
          boost: float | jax.Array = 0.0):
    """Factor + solve.  ``refine`` extra iterative-refinement passes need a
    ``matvec(x)`` computing A@x (e.g. from the unfactored vals).
    ``boost``: GESP small-pivot threshold (see ``factor``)."""
    f = factor(plan, vals, boost=boost)
    x = solve_factored(plan, f, b)
    for _ in range(refine):
        r = b - matvec(x)
        x = x + solve_factored(plan, f, r)
    return x

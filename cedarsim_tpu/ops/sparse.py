"""Sparse structure planning for large circuits.

The dense batched LU (ops/linalg.py) is the right call below a few hundred
unknowns — it runs on the MXU and vmaps perfectly.  Beyond that, a sparse
factorization with a *precomputed symbolic structure* wins; device kernels need
static sparsity, so the planning happens once per circuit at compile time in
native code (cedarsim_tpu/native/symbolic.cpp — minimum-degree ordering +
elimination symbolic pass), with a pure-Python fallback.

This module provides the structural analysis; the on-device numeric
factorization kernel over the planned pattern is the next stage of the
sparse path.
"""

from __future__ import annotations

import numpy as np

from cedarsim_tpu.native import get_lib


def jacobian_sparsity(compiled):
    """Structural (row, col) pattern of G+C from the compiled circuit's
    gather/scatter index arrays — no numerics involved."""
    n = compiled.n_x
    rows, cols = [], []
    for key in compiled.group_order:
        g = compiled.groups[key]
        r = g.row_idx[:, :, None]
        c = g.var_idx[:, None, :]
        rr = np.broadcast_to(r, (r.shape[0], r.shape[1], c.shape[2]))
        cc = np.broadcast_to(c, rr.shape)
        rows.append(rr.ravel())
        cols.append(cc.ravel())
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    keep = (rows < n) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    # plus the diagonal (gmin shunts / integrator terms)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    dedup = np.ones(len(rows), bool)
    dedup[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
    return rows[dedup].astype(np.int32), cols[dedup].astype(np.int32)


def _to_csr(n, rows, cols):
    indptr = np.zeros(n + 1, np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return indptr, cols.astype(np.int32)


def md_order(n, rows, cols):
    """Minimum-degree fill-reducing ordering (native; python fallback)."""
    indptr, indices = _to_csr(n, rows, cols)
    lib = get_lib()
    if lib is not None:
        import ctypes
        perm = np.zeros(n, np.int32)
        lib.csim_md_order(
            n, indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return perm
    return _md_order_py(n, indptr, indices)


def nd_order(n, rows, cols, leaf=32):
    """Nested-dissection fill-reducing ordering (recursive bisection with
    BFS-level separators; min-degree on the leaves).

    Motivation is LATENCY, not fill: the leveled on-device LU executes one
    batched gather/scatter dispatch per elimination-tree level, so the
    sequential depth — not the flop count — prices a device solve.  Min-degree
    on a chain-shaped circuit yields a path elimination tree (n_levels ~ n:
    380 levels at 1992 unknowns, measured), while dissection cuts it to
    O(log n) levels of independent blocks.  This is the KLU/AMD role
    (/root/reference/Project.toml LinearSolve) re-decided for the hardware:
    AMD minimizes fill for a sequential CPU sweep; ND minimizes the
    critical path the device actually waits on."""
    indptr, indices = _to_csr(n, rows, cols)
    # symmetrize once (BFS needs undirected adjacency)
    adj = [set() for _ in range(n)]
    for r in range(n):
        for j in indices[indptr[r]:indptr[r + 1]]:
            if j != r:
                adj[r].add(int(j))
                adj[int(j)].add(r)
    order = []

    def bfs_levels(nodes, start, active):
        seen = {start}
        frontier = [start]
        levels = [[start]]
        while True:
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v in active and v not in seen:
                        seen.add(v)
                        nxt.append(v)
            if not nxt:
                return levels, seen
            levels.append(nxt)
            frontier = nxt

    def dissect(nodes):
        if len(nodes) <= leaf:
            # local min-degree: tiny, python is fine
            deg = {u: sum(1 for v in adj[u] if v in nodes) for u in nodes}
            rem = set(nodes)
            while rem:
                u = min(rem, key=lambda x: (deg[x], x))
                rem.discard(u)
                for v in adj[u]:
                    if v in rem:
                        deg[v] -= 1
                order.append(u)
            return
        active = set(nodes)
        start = next(iter(active))
        levels, seen = bfs_levels(nodes, start, active)
        # pseudo-peripheral: restart BFS from the far end for a longer,
        # better-balanced level structure
        levels, seen = bfs_levels(nodes, levels[-1][0], active)
        unreached = active - seen
        if len(levels) <= 2:
            # no useful separator (clique-ish component): eliminate as a
            # leaf block
            deg = {u: sum(1 for v in adj[u] if v in active) for u in active}
            order.extend(sorted(active, key=lambda x: (deg[x], x)))
            return
        # separator = the BFS level at the weighted middle
        half = (len(seen) + 1) // 2
        acc = 0
        for li, lev in enumerate(levels):
            acc += len(lev)
            if acc >= half and 0 < li < len(levels) - 1:
                sep = set(lev)
                break
        else:
            li = len(levels) // 2
            sep = set(levels[li])
        a = [u for lev in levels[:li] for u in lev]
        b = [u for lev in levels[li + 1:] for u in lev]
        if unreached:
            b.extend(unreached)      # disconnected part: order with side B
        if not a or not b:
            deg = {u: sum(1 for v in adj[u] if v in active) for u in active}
            order.extend(sorted(active, key=lambda x: (deg[x], x)))
            return
        dissect(a)
        dissect(b)
        # separator last: its elimination depends on both halves, which is
        # exactly what makes the halves independent levels
        deg = {u: sum(1 for v in adj[u] if v in sep) for u in sep}
        order.extend(sorted(sep, key=lambda x: (deg[x], x)))

    # peel global hubs (clock/supply nets touch EVERY cell: BFS levels
    # through them are two fat shells, so any "separator" is half the
    # graph and fill explodes 13x, measured on the DFF chain).  Hubs form
    # the outermost separator — eliminated last, after every independent
    # block — which is where dissection would put them with an exact
    # vertex-separator oracle anyway.
    deg = np.asarray([len(a) for a in adj], np.int64)
    if n > 4 * leaf:
        cut = max(16.0, 4.0 * float(deg.mean()))
        hubs = [u for u in range(n) if deg[u] > cut]
    else:
        hubs = []
    hubset = set(hubs)
    for u in hubs:
        for v in adj[u]:
            adj[v].discard(u)
        adj[u] = set()

    import sys as _sys
    old = _sys.getrecursionlimit()
    _sys.setrecursionlimit(max(old, 10000))
    try:
        # connected components of the peeled graph dissect independently
        # (their elimination levels interleave for free — leveling follows
        # actual dependencies, not emission order)
        seen_c = set(hubs)
        for s in range(n):
            if s in seen_c:
                continue
            compo = [s]
            seen_c.add(s)
            qi = 0
            while qi < len(compo):
                u = compo[qi]
                qi += 1
                for v in adj[u]:
                    if v not in seen_c:
                        seen_c.add(v)
                        compo.append(v)
            dissect(compo)
    finally:
        _sys.setrecursionlimit(old)
    # hubs last, min-degree among themselves on the original pattern
    order.extend(sorted(hubs, key=lambda u: (deg[u], u)))
    return np.asarray(order, np.int32)


def symbolic_fill(n, rows, cols, perm):
    """L-nnz (strict lower, symmetrized) when eliminating in perm order."""
    indptr, indices = _to_csr(n, rows, cols)
    lib = get_lib()
    if lib is not None:
        import ctypes
        return int(lib.csim_symbolic_fill(
            n, indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            np.asarray(perm, np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int)), None))
    return _symbolic_fill_py(n, indptr, indices, perm)


def plan(compiled):
    """Full structural plan: (perm, lnnz_md, lnnz_natural, pattern_nnz)."""
    rows, cols = jacobian_sparsity(compiled)
    n = compiled.n_x
    perm = md_order(n, rows, cols)
    lnnz = symbolic_fill(n, rows, cols, perm)
    lnnz_nat = symbolic_fill(n, rows, cols, np.arange(n, dtype=np.int32))
    return dict(perm=perm, lnnz=lnnz, lnnz_natural=lnnz_nat,
                nnz=len(rows), n=n, native=get_lib() is not None)


# ------------------------------------------------------- python fallbacks

def _adj(n, indptr, indices):
    adj = [set() for _ in range(n)]
    for i in range(n):
        for p in range(indptr[i], indptr[i + 1]):
            j = int(indices[p])
            if j != i:
                adj[i].add(j)
                adj[j].add(i)
    return adj


def _md_order_py(n, indptr, indices):
    adj = _adj(n, indptr, indices)
    alive = set(range(n))
    perm = np.zeros(n, np.int32)
    for k in range(n):
        v = min(alive, key=lambda u: len(adj[u] & alive))
        perm[k] = v
        alive.discard(v)
        nbrs = list(adj[v] & alive)
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                adj[nbrs[a]].add(nbrs[b])
                adj[nbrs[b]].add(nbrs[a])
    return perm


def _symbolic_fill_py(n, indptr, indices, perm):
    adj = _adj(n, indptr, indices)
    alive = set(range(n))
    total = 0
    for k in range(n):
        v = int(perm[k])
        alive.discard(v)
        nbrs = list(adj[v] & alive)
        total += len(nbrs)
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                adj[nbrs[a]].add(nbrs[b])
                adj[nbrs[b]].add(nbrs[a])
    return total

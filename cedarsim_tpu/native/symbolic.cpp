// Sparse symbolic-factorization planner for cedarsim_tpu.
//
// This is the host-side half of the KLU/UMFPACK replacement (the reference
// leans on SuiteSparse through Sundials/LinearSolve, SURVEY.md §2.10): a
// minimum-degree fill-reducing ordering and an elimination symbolic pass
// that computes the exact L+U sparsity under that ordering.  The numeric
// factorization runs on-device (JAX) against the *static* structure
// computed here once per circuit — device kernels need static sparsity, so the
// planning is naturally a compile-time, native-code job.
//
// Exported C ABI (ctypes):
//   int csim_md_order(int n, const int* indptr, const int* indices,
//                     int* perm_out);
//       Minimum-degree ordering of the symmetrized pattern. Returns 0.
//   long long csim_symbolic_fill(int n, const int* indptr,
//                                const int* indices, const int* perm,
//                                int* lnz_per_col_or_null);
//       Number of nonzeros in L (strict lower triangle, symmetrized
//       pattern) after eliminating in `perm` order. Column counts
//       optionally written per eliminated position.

#include <vector>
#include <algorithm>
#include <cstdint>

extern "C" {

static void symmetrize(int n, const int* indptr, const int* indices,
                       std::vector<std::vector<int>>& adj) {
    adj.assign(n, {});
    for (int i = 0; i < n; ++i) {
        for (int p = indptr[i]; p < indptr[i + 1]; ++p) {
            int j = indices[p];
            if (j == i || j < 0 || j >= n) continue;
            adj[i].push_back(j);
            adj[j].push_back(i);
        }
    }
    for (int i = 0; i < n; ++i) {
        std::sort(adj[i].begin(), adj[i].end());
        adj[i].erase(std::unique(adj[i].begin(), adj[i].end()),
                     adj[i].end());
    }
}

int csim_md_order(int n, const int* indptr, const int* indices,
                  int* perm_out) {
    std::vector<std::vector<int>> adj;
    symmetrize(n, indptr, indices, adj);
    std::vector<char> eliminated(n, 0);
    for (int k = 0; k < n; ++k) {
        // pick the remaining vertex of minimum degree
        int best = -1, best_deg = 1 << 30;
        for (int v = 0; v < n; ++v) {
            if (eliminated[v]) continue;
            int deg = 0;
            for (int u : adj[v]) if (!eliminated[u]) ++deg;
            if (deg < best_deg) { best_deg = deg; best = v; }
        }
        perm_out[k] = best;
        eliminated[best] = 1;
        // connect the remaining neighbors (clique of the eliminated vertex)
        std::vector<int> nbrs;
        for (int u : adj[best]) if (!eliminated[u]) nbrs.push_back(u);
        for (size_t a = 0; a < nbrs.size(); ++a) {
            for (size_t b = a + 1; b < nbrs.size(); ++b) {
                int x = nbrs[a], y = nbrs[b];
                if (!std::binary_search(adj[x].begin(), adj[x].end(), y)) {
                    adj[x].insert(std::lower_bound(adj[x].begin(),
                                                   adj[x].end(), y), y);
                    adj[y].insert(std::lower_bound(adj[y].begin(),
                                                   adj[y].end(), x), x);
                }
            }
        }
    }
    return 0;
}

long long csim_symbolic_fill(int n, const int* indptr, const int* indices,
                             const int* perm, int* lnz_per_col) {
    std::vector<std::vector<int>> adj;
    symmetrize(n, indptr, indices, adj);
    std::vector<char> eliminated(n, 0);
    long long total = 0;
    for (int k = 0; k < n; ++k) {
        int v = perm[k];
        eliminated[v] = 1;
        std::vector<int> nbrs;
        for (int u : adj[v]) if (!eliminated[u]) nbrs.push_back(u);
        if (lnz_per_col) lnz_per_col[k] = (int)nbrs.size();
        total += (long long)nbrs.size();
        for (size_t a = 0; a < nbrs.size(); ++a) {
            for (size_t b = a + 1; b < nbrs.size(); ++b) {
                int x = nbrs[a], y = nbrs[b];
                if (!std::binary_search(adj[x].begin(), adj[x].end(), y)) {
                    adj[x].insert(std::lower_bound(adj[x].begin(),
                                                   adj[x].end(), y), y);
                    adj[y].insert(std::lower_bound(adj[y].begin(),
                                                   adj[y].end(), x), x);
                }
            }
        }
    }
    return total;
}

}  // extern "C"

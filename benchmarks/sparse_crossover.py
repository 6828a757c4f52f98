"""Measure the dense/sparse Newton crossover on DFF chains.

The reference Newton-solves through KLU at every size
(/root/reference/Project.toml:31); our dispatch is size-based
(``CompiledCircuit.SPARSE_AUTO_THRESHOLD``).  This script times the full DC
continuation solve dense vs sparse over growing chains and reports
per-solve wall time + the measured crossover.

A crossover measured on one backend does not carry to another — the
leveled sparse sweeps serialize differently on a GPU than on the CPU:

    python benchmarks/sparse_crossover.py --backend cpu
    python benchmarks/sparse_crossover.py --backend gpu

Every row carries a ``backend`` field; the summary is printed as JSON.
"""

import argparse
import json
import os
import sys
import time

D = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(D))
sys.path.insert(0, os.path.join(D, "gf180_dff"))


def time_dc(n_cells, sparse, backend):
    from chain import build
    from cedarsim_tpu import solve_dc, SimSpec
    import jax
    c = build(n_cells, sparse=sparse)
    ctx = SimSpec.make(gmin=1e-15)
    t0 = time.perf_counter()
    r = solve_dc(c, ctx=ctx, mode="tranop", artifact_cache=False)
    jax.block_until_ready(r.x)
    compile_s = time.perf_counter() - t0
    assert bool(r.converged), (n_cells, sparse)
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        r = solve_dc(c, ctx=ctx, mode="tranop", artifact_cache=False)
        jax.block_until_ready(r.x)
    warm = (time.perf_counter() - t0) / reps
    return dict(n_x=c.n_x, compile_s=compile_s, solve_s=warm)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="2,6,12,24,48,90")
    ap.add_argument("--backend", choices=["cpu", "gpu"], default="cpu")
    args = ap.parse_args()
    import jax
    if args.backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit(f"asked for gpu, got {jax.default_backend()}")
    sizes = [int(s) for s in args.sizes.split(",")]
    rows = []
    for n in sizes:
        row = {"cells": n, "backend": args.backend}
        for sp in (False, True):
            try:
                r = time_dc(n, sp, args.backend)
                row["n_x"] = r["n_x"]
                tag = "sparse" if sp else "dense"
                row[f"{tag}_solve_s"] = r["solve_s"]
                row[f"{tag}_compile_s"] = r["compile_s"]
            except Exception as e:  # dense may OOM/blow up at large n
                row["sparse" if sp else "dense"] = f"{type(e).__name__}: {e}"[:160]
        if "dense_solve_s" in row and "sparse_solve_s" in row:
            row["speedup"] = row["dense_solve_s"] / row["sparse_solve_s"]
        rows.append(row)
        print(row, flush=True)
    cross = next((r["n_x"] for r in rows if r.get("speedup", 0) > 1.0), None)
    dev = jax.devices()[0]
    out = {"rows": rows, "crossover_n_x": cross, "platform": dev.platform,
           "device_kind": dev.device_kind,
           "note": "DC continuation solve, f64, warm (3-run mean)"}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

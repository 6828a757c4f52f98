"""End-to-end transient benchmark at compact-model scale through the sparse
Newton path: an N-cell BSIM4 shift register (40 cells = 452 unknowns).

The reference runs KLU inside IDA at every circuit size
(/root/reference/Project.toml:31 via Sundials/LinearSolve); our equivalent is
the static-pattern leveled sparse LU (ops/sparse_lu.py) planned by the native
min-degree planner, dispatched automatically above
``CompiledCircuit.SPARSE_AUTO_THRESHOLD`` unknowns.  This script proves and
times the full pipeline — DC continuation + adaptive transient — at a size
where the dense path's O(n^2) assembly / O(n^3) solves are the wall
(ROADMAP round-3 #2 workload; the correctness twin lives in
tests/test_sparse_circuit.py::test_bsim4_chain_40cell_sparse_transient).

Correctness gate: the d0 pulse must march down the chain one clock period per
stage (d1 high at 100 ns, d2 high at 150 ns, d3 high / d2 low at 199 ns).

Usage:
    python benchmarks/chain_transient.py                  # CPU, 40 cells
    python benchmarks/chain_transient.py --backend gpu    # local GPU
    python benchmarks/chain_transient.py --cells 24 --segments 2

``--segments k`` splits the span into k windows chained through the
integrator checkpoint state (one compiled program serves every window).
Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

D = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(D))
sys.path.insert(0, os.path.join(D, "gf180_dff"))

GATE = ((("d1", 1.00e-7), 5.0), (("d2", 1.50e-7), 5.0),
        (("d3", 1.99e-7), 5.0), (("d2", 1.99e-7), 0.0))
TOL = 0.1


def run(cells, backend, segments, sparse, tstop=2e-7, models="bsim4",
        max_steps=None):
    import jax
    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit(f"--backend gpu requested but JAX runs on "
                 f"{jax.default_backend()!r}")
    import jax.numpy as jnp
    import numpy as np
    from chain import build
    from cedarsim_tpu import SimSpec
    from cedarsim_tpu.analysis.dc import solve_dc, NewtonOptions
    from cedarsim_tpu.analysis.tran import (TranOptions, tran_core,
                                            _consistent_xdot,
                                            _differential_mask,
                                            blank_checkpoint,
                                            window_schedules)
    from cedarsim_tpu.core.compile import use_sparse_solver

    t_all = time.perf_counter()
    comp = build(cells, models=models, sparse=sparse)
    plan_s = time.perf_counter() - t_all
    ctx = SimSpec.make(gmin=1e-15)
    d = comp.dtype
    # chain DC at compact-model scale wants damped Newton.  jac_reuse=1 =
    # per-step chord Newton on the sparse factor/solve split (one
    # factorization per step attempt, exact residuals after — KLU's
    # klu_factor/klu_solve discipline; same step counts as full Newton)
    if max_steps is None:
        max_steps = 8192 if segments == 1 else 4096
    opts = TranOptions(max_steps=max_steps, jac_reuse=1)
    dc_o = NewtonOptions(max_step=1.0, gmin_steps=14)

    t_dc = time.perf_counter()
    op = solve_dc(comp, ctx=ctx, mode="tranop", opts=dc_o)
    assert bool(np.all(np.asarray(op.converged))), "DC failed"
    dc_s = time.perf_counter() - t_dc
    ctx_op = ctx.with_mode("tranop")
    xd0 = _consistent_xdot(comp, op.x, ctx_op, comp.params0)
    mask = _differential_mask(comp, op.x, ctx_op, comp.params0)

    # per-window breakpoint schedules padded to one shared length
    bps_all = comp.breakpoints(tstop)
    edges = np.linspace(0.0, tstop, segments + 1)
    win_bps = window_schedules(bps_all, edges)

    fn = jax.jit(lambda x, xd, ist, a, b, bps: tran_core(
        comp, comp.params0, ctx, x, xd, a, b, bps,
        jnp.asarray(2e-13, d), opts, mask, init_state=ist))

    def run_all():
        st = blank_checkpoint(op.x, xd0, 2e-13)
        rbs = []
        for k in range(segments):
            rb = fn(st["x"], st["xdot"], st, jnp.asarray(edges[k], d),
                    jnp.asarray(edges[k + 1], d),
                    jnp.asarray(win_bps[k], d))
            rbs.append(rb)
            st = rb[7]
        jax.block_until_ready(st["x"])
        return rbs

    rbs = run_all()
    compile_s = time.perf_counter() - t_all
    t0 = time.perf_counter()
    rbs = run_all()
    wall = time.perf_counter() - t0

    ts = np.concatenate([np.asarray(rb[0]) for rb in rbs])
    xs = np.concatenate([np.asarray(rb[1]) for rb in rbs])
    fin = all(bool(np.asarray(rb[4])) for rb in rbs)
    nnwt = sum(int(np.asarray(rb[6])) for rb in rbs)
    # element 3 counts accepted steps + the prepended initial point
    nacc = sum(int(np.asarray(rb[3])) - 1 for rb in rbs)
    nrej = sum(int(np.asarray(rb[5])) for rb in rbs)

    ok = fin
    worst = 0.0
    for (node, t_probe), want in GATE:
        v = float(np.interp(t_probe, ts, xs[:, comp.node_names.index(node)]))
        worst = max(worst, abs(v - want))
        if abs(v - want) > TOL:
            ok = False
    return dict(
        cells=cells, n_x=comp.n_x, models=models,
        path="sparse" if use_sparse_solver(comp) else "dense",
        platform=jax.devices()[0].platform,
        device_kind=jax.devices()[0].device_kind,
        segments=segments, ok=ok, worst_gate_err=worst,
        plan_s=plan_s, dc_s=dc_s, compile_s=compile_s, wall_s=wall,
        accepted=nacc, rejected=nrej, newton=nnwt,
        solves_per_sec=nnwt / wall, steps_per_sec=nacc / wall)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=40)
    ap.add_argument("--backend", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--segments", type=int, default=1)
    ap.add_argument("--sparse", default="auto")
    ap.add_argument("--models", default="bsim4", choices=["bsim4", "lv1"])
    ap.add_argument("--max-steps", type=int, default=None)
    args = ap.parse_args()
    segments = args.segments
    sparse = args.sparse
    if sparse in ("True", "true", "1"):
        sparse = True
    elif sparse in ("False", "false", "0"):
        sparse = False
    rec = run(args.cells, args.backend, segments, sparse,
              models=args.models, max_steps=args.max_steps)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

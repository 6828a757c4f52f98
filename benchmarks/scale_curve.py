"""Compile-time and solve-time vs circuit size (the >1k-unknown scaling
story, round-3 VERDICT item 4).

The reference leans on KLU precisely because real circuits are 1e3-1e5
unknowns; nothing there publishes a compile-vs-n curve (Julia compile
latency is its known weakness, /root/reference/README-CedarSim.md:28).
Here we measure, per chain size: elaboration+planning (host), transient
XLA trace+compile (process-fresh; the persistent compile cache stays on,
so the curve reports what a user sees), DC solve, and a short
golden-gated transient window.

    python benchmarks/scale_curve.py --backend cpu --sizes 90,180,320
    python benchmarks/scale_curve.py --backend gpu --sizes 90,180,384 --lanes 8

Prints one row per size (device on every row), then the JSON summary.
"""

import argparse
import json
import os
import subprocess
import sys
import time

D = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(D))
sys.path.insert(0, os.path.join(D, "gf180_dff"))


def run_one(cells, backend, tstop, segments=1, lanes=0):
    """One size, one process (so XLA compile is genuinely cold per size).

    ``segments``: chain the transient through k checkpoint-resumed window
    executions instead of one device call.  ``lanes``: also run that many
    vmapped copies of the window (the leveled LU's sequential sweeps
    amortize across lanes)."""
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

    rec = {"cells": cells, "platform": jax.devices()[0].platform,
           "device_kind": jax.devices()[0].device_kind, "models": "lv1"}

    t0 = time.perf_counter()
    comp = build(cells, sparse=True)
    rec["n_x"] = comp.n_x
    rec["build_s"] = round(time.perf_counter() - t0, 2)
    rec["path"] = "sparse" if use_sparse_solver(comp) else "dense"
    t0 = time.perf_counter()
    if rec["path"] == "sparse":
        # build the LU plan eagerly (host-side) so its cost lands in
        # plan_s, not inside the first DC trace
        from cedarsim_tpu.core.sparse_ops import get_sparse_ops
        get_sparse_ops(comp)
    rec["plan_s"] = round(time.perf_counter() - t0, 2)

    ctx = SimSpec.make(gmin=1e-15)
    # default Newton options: the damped recipe tuned for BSIM4 chains
    # (max_step=1.0, gmin_steps=14) is not needed by the lv1 chain
    dc_o = None
    t0 = time.perf_counter()
    op = solve_dc(comp, ctx=ctx, mode="tranop", opts=dc_o,
                  artifact_cache=False)
    jax.block_until_ready(op.x)
    rec["dc_compile_plus_solve_s"] = round(time.perf_counter() - t0, 2)
    rec["dc_converged"] = bool(np.all(np.asarray(op.converged)))
    t0 = time.perf_counter()
    op = solve_dc(comp, ctx=ctx, mode="tranop", opts=dc_o,
                  artifact_cache=False)
    jax.block_until_ready(op.x)
    rec["dc_solve_s"] = round(time.perf_counter() - t0, 3)

    # transient window [0, tstop]: cold wall includes trace+XLA compile.
    # Segmented: one compiled program serves every window; checkpoint
    # state chains device-to-device (bench.py's discipline).
    d = comp.dtype
    opts = TranOptions(max_steps=max(512, 4096 // segments), jac_reuse=1)
    ctx_op = ctx.with_mode("tranop")
    xd0 = _consistent_xdot(comp, op.x, ctx_op, comp.params0)
    mask = _differential_mask(comp, op.x, ctx_op, comp.params0)
    bps = comp.breakpoints(tstop)
    edges = np.linspace(0.0, tstop, segments + 1)
    win_bps = window_schedules(bps, edges)
    rec["segments"] = segments
    fn = jax.jit(lambda x, xd, ist, a, b, w: tran_core(
        comp, comp.params0, ctx, x, xd, a, b, w,
        jnp.asarray(2e-13, d), opts, mask, init_state=ist))

    def run_all():
        state = blank_checkpoint(op.x, xd0, 2e-13)
        rbs = []
        for k in range(segments):
            rb = fn(state["x"], state["xdot"], state,
                    jnp.asarray(edges[k], d), jnp.asarray(edges[k + 1], d),
                    jnp.asarray(win_bps[k], d))
            rbs.append(rb)
            state = rb[7]
        jax.block_until_ready(state["x"])
        return rbs

    t0 = time.perf_counter()
    rbs = run_all()
    rec["tran_cold_s"] = round(time.perf_counter() - t0, 2)
    t0 = time.perf_counter()
    rbs = run_all()
    wall = time.perf_counter() - t0
    rec["tran_warm_s"] = round(wall, 2)
    rec["tran_compile_s"] = round(rec["tran_cold_s"] - wall, 2)

    # golden gate on the solo run first; the parent keeps the LAST
    # complete row, so a failure in the batched leg keeps the solo row
    _finish_row(rec, rbs, comp, tstop)
    print("ROW " + json.dumps(rec), flush=True)

    nb = lanes
    if nb:
        fnb = jax.jit(jax.vmap(
            lambda x, xd, ist, a, b, w: tran_core(
                comp, comp.params0, ctx, x, xd, a, b, w,
                jnp.asarray(2e-13, d), opts, mask, init_state=ist),
            in_axes=(0, 0, 0, None, None, None)))
        xb = jnp.repeat(op.x[None], nb, 0)
        xdb = jnp.repeat(xd0[None], nb, 0)

        def run_all_b():
            st = blank_checkpoint(xb, xdb, 2e-13)
            rbs = []
            for k in range(segments):
                rb = fnb(st["x"], st["xdot"], st,
                         jnp.asarray(edges[k], d),
                         jnp.asarray(edges[k + 1], d),
                         jnp.asarray(win_bps[k], d))
                rbs.append(rb)
                st = rb[7]
            jax.block_until_ready(st["x"])
            return rbs

        t0 = time.perf_counter()
        rbsb = run_all_b()
        rec[f"batched{nb}_cold_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rbsb = run_all_b()
        wb = time.perf_counter() - t0
        naccb = sum(int(np.sum(np.asarray(rb[3]) - 1)) for rb in rbsb)
        rec[f"batched{nb}_finished"] = bool(
            all(bool(np.all(np.asarray(rb[4]))) for rb in rbsb))
        rec[f"batched{nb}_steps_per_sec_per_lane"] = naccb / wb / nb
        rec[f"batched{nb}_steps_per_sec_total"] = naccb / wb

    return rec


def _finish_row(rec, rbs, comp, tstop):
    """Fill acceptance counts + the golden gate from the solo windows:
    the d0 pulse (high 45-95 ns) is latched by cell 1 at the 70 ns falling
    clock edge -> d1 high at 95 ns; d2 still low.  Rails must be exact on
    every probed node."""
    import numpy as np
    ts_parts, xs_parts = [], []
    for rb in rbs:
        nk = int(np.asarray(rb[3]))
        ts_parts.append(np.asarray(rb[0])[:nk])
        xs_parts.append(np.asarray(rb[1])[:nk])
    ts = np.concatenate(ts_parts)
    xs = np.concatenate(xs_parts, axis=0)
    rec["finished"] = all(bool(np.asarray(rb[4])) for rb in rbs)
    nacc = sum(int(np.asarray(rb[3])) - 1 for rb in rbs)
    rec["accepted"] = nacc
    rec["newton"] = sum(int(np.asarray(rb[6])) for rb in rbs)
    rec["steps_per_sec"] = round(nacc / rec["tran_warm_s"], 1)
    ok = rec["finished"] and rec["dc_converged"]
    worst = 0.0
    for node, t_probe, want in (("d1", 0.95e-7, 5.0), ("d2", 0.95e-7, 0.0)):
        if t_probe <= tstop:
            v = float(np.interp(t_probe, ts,
                                xs[:, comp.node_names.index(node)]))
            worst = max(worst, abs(v - want))
    rec["worst_gate_err"] = round(worst, 4)
    rec["ok"] = bool(ok and worst < 0.1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default=None)
    ap.add_argument("--backend", choices=["cpu", "gpu"], default="cpu")
    ap.add_argument("--tstop", type=float, default=1e-7)
    ap.add_argument("--one", type=int, default=None,
                    help="internal: run a single size in THIS process")
    ap.add_argument("--segments", type=int, default=1,
                    help="checkpoint-chained window count")
    ap.add_argument("--lanes", type=int, default=0,
                    help="vmapped copies of the window to time as well")
    args = ap.parse_args()
    if args.one is not None:
        rec = run_one(args.one, args.backend, args.tstop, args.segments,
                      args.lanes)
        print("ROW " + json.dumps(rec), flush=True)
        return 0
    sizes = [int(s) for s in (args.sizes or "90,180,320").split(",")]
    rows = []
    for n in sizes:
        # per-size subprocess: genuinely cold trace/compile each time
        cmd = [sys.executable, os.path.abspath(__file__),
               "--backend", args.backend, "--tstop", str(args.tstop),
               "--segments", str(args.segments), "--lanes", str(args.lanes),
               "--one", str(n)]
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=3600)
        row = None
        for line in p.stdout.splitlines():
            if line.startswith("ROW "):
                row = json.loads(line[4:])
        if row is None:
            err = (p.stderr or p.stdout)
            row = {"cells": n, "backend": args.backend,
                   "error": err[-1500:]}
        rows.append(row)
        print(row, flush=True)
    out = {"rows": rows, "backend": args.backend,
           "tstop": args.tstop,
           "note": "lv1 DFF chain, sparse path, per-size fresh process "
                   "(cold XLA compile); tran window golden-gated on the "
                   "first latch edge"}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

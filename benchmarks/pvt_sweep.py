"""PVT sweep harness — the BASELINE.md north-star workload: a batched
process/voltage sweep of the gf180-topology BSIM4 DFF transient, vmapped
into ONE XLA program and sharded over the device mesh
(``tran_sweep_sharded``), replacing the reference's serial CircuitSweep
broadcast loop (/root/reference/src/sweeps.jl:471-502).

Axes: transistor width W scaled ±3% (process) × supply ±5% (voltage) —
temperature rides SimSpec and has its own sweep axis (analysis/sweeps.py).
Per-lane correctness gate: after the final clock edge the flop must drive
Q to ITS OWN rail (q ≈ vdd_lane), so a lane permutation, a clobbered
shard, or a physics break cannot pass.  A lane that fails the gate (or does
not finish) is reported in ``failed_lanes``; nothing re-runs it elsewhere.

    python benchmarks/pvt_sweep.py                    # 8-dev CPU mesh
    python benchmarks/pvt_sweep.py --points 64
    python benchmarks/pvt_sweep.py --backend gpu      # every local GPU
    python benchmarks/pvt_sweep.py --backend gpu --points 10000 --chunk 512

``--chunk`` streams the grid through one compiled program in chunk-sized
dispatches that store only the probed Q column (full waveforms at 10k lanes
would not fit device memory).  Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

D = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(D))
DFF = os.path.join(D, "gf180_dff")
RAIL_TOL = 0.1          # V
T_PROBE = 6.99e-7       # s, after the final clock edge


def setup(backend):
    import jax
    if backend == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        sys.exit(f"--backend gpu requested but JAX runs on "
                 f"{jax.default_backend()!r}")


def grid(points):
    """(vdd, w_scale) per lane over the W x VDD grid sized to ``points``."""
    import numpy as np
    nv = max(2, int(round(points ** 0.5)))
    nw = max(2, -(-points // nv))
    vdds = np.repeat(np.linspace(4.75, 5.25, nv), nw)[:points]
    wscs = np.tile(np.linspace(0.97, 1.03, nw), nv)[:points]
    return vdds, wscs


def run(points, backend, chunk=None):
    setup(backend)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from cedarsim_tpu import parse_spice, elaborate, compile_circuit, solve_dc
    from cedarsim_tpu.core.compile import ensure_dynamic, default_ctx
    from cedarsim_tpu.analysis.tran import TranOptions
    from cedarsim_tpu.parallel.mesh import make_mesh, tran_sweep_sharded

    t0 = time.perf_counter()
    with open(os.path.join(DFF, "dff_tb_bsim4.cir")) as f:
        nl = parse_spice(f.read(), file="dff_tb_bsim4.cir")
    comp = ensure_dynamic(
        compile_circuit(elaborate(nl, include_paths=[DFF])), ["vvdd.dc", "w"])
    ctx = default_ctx(comp)
    key = [k for k in comp.group_order if "bsim4" in k.lower()][0]
    iq = comp.node_names.index("q")
    mesh = make_mesh()
    vdds, wscs = grid(points)
    chunk = chunk or points
    n_pad = (-points) % chunk        # nominal lanes, gated but not counted
    vdds = np.concatenate([vdds, np.full(n_pad, 5.0)])
    wscs = np.concatenate([wscs, np.ones(n_pad)])

    # warm-start every lane from the NOMINAL operating point — the cold
    # continuation ladder is fragile at scattered PVT points on a
    # metastable-bias flop (see tran_sweep_sharded docstring)
    op = solve_dc(comp, ctx=ctx, mode="tranop")
    assert bool(np.asarray(op.converged)), "nominal op failed"
    opts = TranOptions(max_steps=8192, jac_reuse=1, store_vars=(iq,))
    kv, jv, pv = comp.param_loc("vvdd.dc")
    base = jax.tree.map(
        lambda a: jnp.broadcast_to(jnp.asarray(a)[None],
                                   (chunk,) + jnp.asarray(a).shape),
        comp.params0)

    def chunk_params(k0):
        pb = dict(base)
        gv = dict(pb[kv])
        gv[pv] = gv[pv].at[:, jv].set(jnp.asarray(vdds[k0:k0 + chunk]))
        if f"{pv}$given" in gv:
            gv[f"{pv}$given"] = gv[f"{pv}$given"].at[:, jv].set(1.0)
        pb[kv] = gv
        gk = dict(pb[key])
        gk["W"] = gk["W"] * jnp.asarray(wscs[k0:k0 + chunk])[:, None]
        pb[key] = gk
        return pb

    def run_chunk(k0):
        res = tran_sweep_sharded(comp, None, (0.0, 7e-7), mesh,
                                 params=chunk_params(k0), ctx=ctx, opts=opts,
                                 x0=op.x)
        jax.block_until_ready(res.xs)
        return res

    run_chunk(0)                     # compile + one full execution
    setup_s = time.perf_counter() - t0

    wall = 0.0
    newton = 0
    worst = 0.0
    failed = []
    for k0 in range(0, len(vdds), chunk):
        tc = time.perf_counter()
        res = run_chunk(k0)
        wall += time.perf_counter() - tc
        ts = np.asarray(res.ts)
        qs = np.asarray(res.xs)[:, :, 0]
        fin = np.asarray(res.finished)
        newton += int(np.asarray(res.n_newton).sum())
        for lane in range(min(chunk, points - k0)):
            j = k0 + lane
            err = abs(float(np.interp(T_PROBE, ts[lane], qs[lane])) - vdds[j])
            if err > RAIL_TOL or not fin[lane]:
                failed.append(dict(lane=j, vdd=float(vdds[j]),
                                   w_scale=float(wscs[j]),
                                   finished=bool(fin[lane]), rail_err=err))
            else:
                worst = max(worst, err)
    dev = jax.devices()[0]
    return dict(points=points, chunk=chunk, platform=dev.platform,
                device_kind=dev.device_kind, mesh_devices=int(mesh.size),
                ok=not failed, worst_rail_err=worst, failed_lanes=failed,
                setup_s=setup_s, wall_s=wall, points_per_sec=points / wall,
                newton=newton)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--backend", default="cpu", choices=["cpu", "gpu"])
    ap.add_argument("--chunk", type=int, default=None,
                    help="lanes per dispatch (default: the whole grid)")
    a = ap.parse_args()
    rec = run(a.points, a.backend, a.chunk)
    print(json.dumps(rec))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

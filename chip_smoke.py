"""End-to-end smoke run of the simulator on one GPU.

    python chip_smoke.py                # phases 0-6 on one card
    python chip_smoke.py --four-cards   # only the 4-card sharded sweep phase

Each phase drives the main path (netlist -> compile_circuit -> DC operating
point -> adaptive transient) through the public entry points, gates its
result against a closed form, the DFF goldens, or a host f64 reference, and
prints one JSON line with its compile and run seconds kept apart (compile =
first call minus the warm second call).  A failed phase raises, so the
script exits non-zero; the last line, printed only when every phase passed,
is the device record:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

There is no CPU fallback: without a GPU the script exits before any phase.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DFF_DIR = os.path.join(REPO, "benchmarks", "gf180_dff")
GOLDEN_TOL = 0.05          # V, on the DFF's logic levels
RACE_IDX = (2, 3)          # 450/550 ns: downstream of the 401 ns CLKN/D race
SPARSE_TOL = 1e-6          # V, sparse vs dense LU on one transient
RESID_TOL = 1e-10          # normwise backward error of the f64 solves
FOUR_CARD_TOL = 1e-6       # V, 4-card mesh vs one card, lane for lane
W_SCATTER = 0.01           # +-1 % W, middle lane pinned to nominal
CHAIN_DC = dict(max_step=1.0, gmin_steps=14)   # damped chain DC recipe


def emit(rec):
    print(json.dumps(rec), flush=True)


def require_gpu():
    """Device record of the run; exits non-zero unless JAX's default device
    is a GPU."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU (found {devs[0].platform!r})\n")
        sys.exit(2)
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))


def nvidia_smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def load_golden(name):
    with open(os.path.join(DFF_DIR, name)) as f:
        return json.load(f)


def golden_gate(golden, ts, qs, nominal):
    """The DFF gate of ``bench.py``: the nominal lane must match all five
    golden samples, every other lane the three samples away from the race.

    ``ts``/``qs``: [lanes, T] time and Q waveforms.  Returns (ok, worst
    gated error, share of scattered lanes that also match at the race)."""
    ts, qs = np.atleast_2d(ts), np.atleast_2d(qs)
    ok, worst, race_hits = True, 0.0, 0
    for lane in range(ts.shape[0]):
        for j, (t_ns, g) in enumerate(zip(golden["samples_ns"], golden["q"])):
            err = abs(float(np.interp(t_ns * 1e-9, ts[lane], qs[lane])) - g)
            if j in RACE_IDX and lane != nominal:
                race_hits += err <= GOLDEN_TOL
                continue
            worst = max(worst, err)
            ok = ok and err <= GOLDEN_TOL
    n_race = (ts.shape[0] - 1) * len(RACE_IDX)
    return ok, worst, (race_hits / n_race if n_race else 1.0)


def result_line(dev):
    """The last line of a passing run: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def timed_twice(fn):
    """(result, compile_s, run_s): the first call compiles and runs, the
    second only runs."""
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    run = time.perf_counter() - t0
    return out, max(first - run, 0.0), run


def build_dff(tb, sparse="auto"):
    from cedarsim_tpu import parse_spice, elaborate, compile_circuit
    with open(os.path.join(DFF_DIR, tb)) as f:
        nl = parse_spice(f.read(), file=tb)
    return compile_circuit(elaborate(nl, include_paths=[DFF_DIR]),
                           sparse=sparse)


# ---------------------------------------------------------------- phases

def phase_closed_form():
    """RC step through tran(): one tau after a 3.3 V step, vout must read
    3.3 (1 - e^-1)."""
    from cedarsim_tpu import (Circuit, Resistor, Capacitor, VSourcePULSE,
                              TranOptions, compile_circuit, tran)
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    c = compile_circuit(ckt)
    opts = TranOptions(hmax_frac=1e-3)
    sol, comp_s, run_s = timed_twice(lambda: tran(c, (0.0, 20e-6),
                                                  opts=opts))
    # the ramp's midpoint is the step's effective start
    v_tau = float(sol.interp("vout", 1e-6 + 0.5e-9 + 1e-6))
    want = 3.3 * (1.0 - np.exp(-1.0))
    rec = dict(phase="closed_form", vout_at_tau=v_tau, want=want,
               err=abs(v_tau - want), converged=bool(sol.converged),
               compile_s=comp_s, run_s=run_s)
    emit(rec)
    check(sol.converged and rec["err"] <= 1e-3, f"RC step: {rec}")
    return rec


def phase_single(tb="dff_tb_bsim4.cir", golden="golden_bsim4.json",
                 name="flagship_single"):
    """simulate() on the DFF netlist, gated on all five golden points.

    The first call parses, elaborates, traces, compiles and runs; the run
    is then repeated through tran() on the same compiled circuit and
    options (operating point + transient on warm programs), and compile_s
    is the difference."""
    from cedarsim_tpu import simulate, tran
    with open(os.path.join(DFF_DIR, tb)) as f:
        text = f.read()
    g = load_golden(golden)
    t0 = time.perf_counter()
    sol0 = simulate(text, include_paths=[DFF_DIR], file=tb)["tran"]
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = tran(sol0.compiled, (0.0, float(sol0.ts[-1])), params=sol0.params,
               ctx=sol0.ctx, opts=sol0.opts)
    run_s = time.perf_counter() - t0
    comp_s = max(first - run_s, 0.0)
    ok, worst, _ = golden_gate(g, sol.ts, sol["q"], nominal=0)
    ok0, _, _ = golden_gate(g, sol0.ts, sol0["q"], nominal=0)
    ok = ok and ok0
    rec = dict(phase=name, tb=tb, n_x=sol.compiled.n_x,
               golden_ok=bool(ok), worst_golden_err=worst,
               converged=bool(sol.converged), accepted=int(sol.n_accepted),
               rejected=int(sol.n_rejected), newton=int(sol.n_newton),
               compile_s=comp_s, run_s=run_s)
    emit(rec)
    check(sol.converged and ok, f"{name} golden gate: {rec}")
    return rec


def w_scatter_params(comp, nb):
    """The bench's +-1 % W scatter over the BSIM4 group; the middle lane is
    exactly nominal."""
    import jax
    import jax.numpy as jnp
    key = [k for k in comp.group_order if "bsim4" in k.lower()][0]
    pb = jax.tree.map(lambda a: jnp.repeat(a[None], nb, 0), comp.params0)
    sc = np.linspace(1.0 - W_SCATTER, 1.0 + W_SCATTER, nb)
    sc[nb // 2] = 1.0
    pb[key] = dict(pb[key])
    pb[key]["W"] = pb[key]["W"] * jnp.asarray(sc)[:, None]
    return pb


def dff_sweep(comp, nb, mesh):
    """tran_sweep_sharded over nb W-scattered lanes, each lane's operating
    point warm-started from the nominal one."""
    import dataclasses
    from cedarsim_tpu import solve_dc, TranOptions
    from cedarsim_tpu.analysis.dc import default_newton_options
    from cedarsim_tpu.core.compile import default_ctx
    from cedarsim_tpu.parallel.mesh import tran_sweep_sharded
    ctx = default_ctx(comp)
    op = solve_dc(comp, ctx=ctx, mode="tranop")
    light = dataclasses.replace(default_newton_options(comp), gmin_steps=2,
                                src_steps=2, restarts=0, gmin_start=1e-6)
    opts = TranOptions(max_steps=8192, jac_reuse=1, accept_slack=1.5)
    pb = w_scatter_params(comp, nb)
    return tran_sweep_sharded(comp, None, (0.0, 7e-7), mesh=mesh, params=pb,
                              ctx=ctx, opts=opts, dc_opts=light, x0=op.x)


def q_at_samples(comp, res, golden):
    iq = comp.node_names.index("q")
    ts = np.asarray(res.ts)
    qs = np.asarray(res.xs[:, :, iq])
    t = np.asarray(golden["samples_ns"]) * 1e-9
    return ts, qs, np.stack([np.interp(t, ts[k], qs[k])
                             for k in range(ts.shape[0])])


def gate_sweep(comp, res, nb):
    g = load_golden("golden_bsim4.json")
    ts, qs, q5 = q_at_samples(comp, res, g)
    fin = np.asarray(res.finished)
    ok, worst, race = golden_gate(g, ts, qs, nominal=nb // 2)
    return dict(golden_ok=bool(ok and fin.all()), worst_golden_err=worst,
                race_lane_agreement=race, unfinished=int((~fin).sum()),
                accepted=int(np.sum(res.n_accepted)),
                rejected=int(np.sum(res.n_rejected)),
                newton=int(np.sum(res.n_newton))), q5


def phase_batched(nb=128):
    """128 W-scattered DFF lanes through tran_sweep_sharded on one card."""
    import jax
    from cedarsim_tpu.parallel.mesh import make_mesh
    comp = build_dff("dff_tb_bsim4.cir")
    mesh = make_mesh(1)

    def run():
        res = dff_sweep(comp, nb, mesh)
        jax.block_until_ready(res.xs)
        return res
    res, comp_s, run_s = timed_twice(run)
    gate, _ = gate_sweep(comp, res, nb)
    rec = dict(phase="flagship_batched", nb=nb, **gate,
               transients_per_sec=nb / run_s, compile_s=comp_s, run_s=run_s)
    emit(rec)
    check(gate["golden_ok"], f"batched golden gate: {rec}")
    # final per-lane states (padded rows repeat the last accepted point)
    return rec, comp, np.asarray(res.xs[:, -1, :])


def rail_error(comp, x, n_cells, vdd=5.0):
    """Largest distance of any cell output d1..dN from the nearer rail."""
    d = np.asarray([x[comp.node_names.index(f"d{k}")]
                    for k in range(1, n_cells + 1)])
    return float(np.max(np.minimum(np.abs(d), np.abs(d - vdd))))


def phase_sparse(n_cells=40, tstop=2e-8, sparse="auto"):
    """The BSIM4 shift register above the sparse threshold: the sparse LU
    path against the same circuit on the dense path, both in f64.

    The chain's latches make its operating point bistable and, under the
    default 5 V Newton step, the gmin ladder's convergence hangs on the
    rounding of the first steps.  So the operating point is solved once, on
    the sparse path, with the damped recipe the chain's own tests use
    (1 V steps, 14 gmin rungs), gated on every cell output sitting at a
    rail, and both transients start from it."""
    from cedarsim_tpu import solve_dc, tran, TranOptions
    from cedarsim_tpu.analysis.dc import NewtonOptions
    from cedarsim_tpu.core.compile import default_ctx, use_sparse_solver
    sys.path.insert(0, DFF_DIR)
    from chain import build
    sp = build(n_cells, models="bsim4", sparse=sparse)
    de = build(n_cells, models="bsim4", sparse=False)
    check(use_sparse_solver(sp) and not use_sparse_solver(de),
          f"{n_cells}-cell chain: expected the sparse path (n_x={sp.n_x})")
    ctx = default_ctx(sp)
    dc_opts = NewtonOptions(**CHAIN_DC)
    op, dc_c, dc_r = timed_twice(lambda: solve_dc(
        sp, ctx=ctx, mode="tranop", opts=dc_opts, artifact_cache=False))
    rail = rail_error(sp, np.asarray(op.x), n_cells)
    check(bool(op.converged) and rail <= GOLDEN_TOL,
          f"chain operating point: converged={bool(op.converged)} "
          f"iters={int(op.iters)} rail_err={rail}")
    opts = TranOptions(max_steps=4096)
    sols = {}
    times = {}
    for name, comp in (("sparse", sp), ("dense", de)):
        sol, c_s, r_s = timed_twice(
            lambda comp=comp: tran(comp, (0.0, tstop), ctx=ctx, opts=opts,
                                   x0=op.x))
        check(sol.converged, f"chain {name} transient did not converge")
        sols[name], times[name] = sol, (c_s, r_s)
    t = np.linspace(0.0, tstop, 201)
    vs = sols["sparse"].interp_state(t)[:, :sp.n_nodes]
    vd = sols["dense"].interp_state(t)[:, :de.n_nodes]
    dv = float(np.max(np.abs(vs - vd)))
    rec = dict(phase="sparse_chain", cells=n_cells, n_x=sp.n_x,
               tstop=tstop, max_abs_dv=dv, tol=SPARSE_TOL,
               dc_iters=int(op.iters), dc_rail_err=rail,
               compile_s_dc=dc_c, run_s_dc=dc_r,
               steps_sparse=int(sols["sparse"].n_accepted),
               steps_dense=int(sols["dense"].n_accepted),
               compile_s_sparse=times["sparse"][0],
               run_s_sparse=times["sparse"][1],
               compile_s_dense=times["dense"][0],
               run_s_dense=times["dense"][1])
    emit(rec)
    check(dv <= SPARSE_TOL, f"sparse vs dense: {rec}")
    return rec, de, sols["dense"].xs[-1]


def newton_matrix(comp, xs, h=1e-11):
    """Trapezoidal Newton matrices C/h + G/2 at states ``xs`` [B, n_x] and
    matching right-hand sides, assembled by the circuit's own Jacobians."""
    import jax
    import jax.numpy as jnp
    from cedarsim_tpu.core.compile import default_ctx
    ctx = default_ctx(comp).with_mode("tran").at_time(1e-7)

    def one(x):
        G, C = comp.jacobians(x, ctx, comp.params0)
        S, _ = comp.residuals(x, ctx, comp.params0)
        return C / h + 0.5 * G, S
    J, b = jax.jit(jax.vmap(one))(jnp.asarray(xs))
    return np.asarray(J), np.asarray(b)


def backward_error(J, x, b):
    r = np.einsum("...ij,...j->...i", J, x) - b
    den = (np.abs(J).sum(-1).max(-1) * np.abs(x).max(-1)
           + np.abs(b).max(-1))
    return np.abs(r).max(-1) / den


def phase_solve(dff_comp, dff_x, chain_comp, chain_x):
    """The main path's dense f64 LU against numpy/scipy on the host."""
    import jax
    import scipy.linalg
    from cedarsim_tpu.ops import linalg
    Jd, bd = newton_matrix(dff_comp, dff_x)
    Jc, bc = newton_matrix(chain_comp, np.asarray(chain_x)[None])
    fac = jax.jit(jax.vmap(lambda J, b: linalg.chord_solve(
        linalg.chord_factor(J), b)))
    once = jax.jit(linalg.solve)
    rec = dict(phase="linear_solve", dtype=str(Jd.dtype),
               shapes=[list(Jd.shape), list(Jc.shape)], tol=RESID_TOL)
    for name, J, b in (("dff", Jd, bd), ("chain", Jc, bc)):
        x_chord = np.asarray(fac(J, b))
        x_solve = np.asarray(once(J, b))
        x_np = np.linalg.solve(J, b[..., None])[..., 0]
        x_sp = np.stack([scipy.linalg.lu_solve(scipy.linalg.lu_factor(Jk), bk)
                         for Jk, bk in zip(J, b)])
        rec[f"{name}_resid_chord"] = float(backward_error(J, x_chord, b).max())
        rec[f"{name}_resid_solve"] = float(backward_error(J, x_solve, b).max())
        rec[f"{name}_resid_numpy"] = float(backward_error(J, x_np, b).max())
        rec[f"{name}_rel_diff_vs_scipy"] = float(
            (np.abs(x_chord - x_sp).max(-1)
             / np.maximum(np.abs(x_sp).max(-1), 1e-300)).max())
        rec[f"{name}_cond_max"] = float(np.linalg.cond(J).max())
    emit(rec)
    check(Jd.dtype == np.float64 and Jc.dtype == np.float64, "solves not f64")
    for k, v in rec.items():
        if "_resid_" in k:
            check(v <= RESID_TOL, f"{k}={v} > {RESID_TOL}")
    return rec


def phase_four_cards(nb=512):
    """512 W-scattered lanes on a 4-card mesh, gated like the batched phase,
    then the same lanes on one card, compared lane for lane."""
    import jax
    from cedarsim_tpu.parallel.mesh import make_mesh
    comp = build_dff("dff_tb_bsim4.cir")
    g = load_golden("golden_bsim4.json")
    out = {}
    for cards in (4, 1):
        mesh = make_mesh(cards)

        def run(mesh=mesh):
            res = dff_sweep(comp, nb, mesh)
            jax.block_until_ready(res.xs)
            return res
        res, comp_s, run_s = timed_twice(run)
        gate, q5 = gate_sweep(comp, res, nb)
        rec = dict(phase="four_cards_sweep", cards=cards, nb=nb, **gate,
                   transients_per_sec=nb / run_s, compile_s=comp_s,
                   run_s=run_s)
        emit(rec)
        check(gate["golden_ok"], f"{cards}-card golden gate: {rec}")
        out[cards] = q5
    dv = float(np.max(np.abs(out[4] - out[1])))
    rec = dict(phase="four_vs_one_card", nb=nb, samples_ns=g["samples_ns"],
               max_abs_dv=dv, tol=FOUR_CARD_TOL)
    emit(rec)
    check(dv <= FOUR_CARD_TOL, f"4-card vs 1-card: {rec}")


def main(argv):
    four = "--four-cards" in argv
    dev = require_gpu()
    smi = nvidia_smi()
    import jax
    from cedarsim_tpu import config
    emit(dict(phase="device", **dev, jax=jax.__version__,
              xla_flags=os.environ.get("XLA_FLAGS", ""),
              compile_cache=jax.config.jax_compilation_cache_dir
              or config.CACHE_DIR,
              nvidia_smi=smi,
              f32_matmuls="none: evaluation and solves are f64 throughout"))
    if four:
        check(dev["count"] >= 4, f"--four-cards needs 4 GPUs, found {dev}")
        phase_four_cards()
    else:
        phase_closed_form()
        phase_single()
        _, dff_comp, dff_x = phase_batched()
        phase_single("dff_tb_cmg.cir", "golden_cmg.json", "bsim_cmg")
        _, chain_comp, chain_x = phase_sparse()
        phase_solve(dff_comp, dff_x, chain_comp, chain_x)
    print(smi, flush=True)
    print(result_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

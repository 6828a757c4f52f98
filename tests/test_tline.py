"""Lossless transmission line (SPICE T element): Branin's method of
characteristics over the integrator's exact-history delay channel for
DC/transient, exact two-port Y(f) stamps for AC.  Neither the reference
simulator nor its parsers support T elements — capability beyond parity.
Every check is closed-form transmission-line physics."""

import numpy as np

from cedarsim_tpu import (Circuit, Resistor, VSource, VSourcePULSE, TLine,
                          compile_circuit, solve_dc, tran, ac, simulate,
                          TranOptions)

Z0, TD = 50.0, 25e-9


def _link(rl, pulse=True):
    """Matched-source line: V1 --RS(Z0)-- a ==line== b --RL-- gnd."""
    ckt = Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    if pulse:
        ckt.add(VSourcePULSE, "V1", (vin, ckt.gnd),
                dict(v1=0.0, v2=2.0, td=10e-9, tr=0.2e-9, tf=0.2e-9,
                     pw=200e-9, per=1e-3))
    else:
        ckt.add(VSource, "V1", (vin, ckt.gnd), dict(dc=2.0, ac=1.0))
    ckt.add(Resistor, "RS", (vin, a), dict(r=Z0))
    ckt.add(TLine, "T1", (a, ckt.gnd, b, ckt.gnd), dict(z0=Z0, td=TD))
    ckt.add(Resistor, "RL", (b, ckt.gnd), dict(r=rl))
    return compile_circuit(ckt)


def test_tline_dc_is_short():
    comp = _link(Z0, pulse=False)
    r = solve_dc(comp)
    assert bool(r.converged)
    x = np.asarray(r.x)
    assert abs(x[comp.node_names.index("a")] - 1.0) < 1e-9
    assert abs(x[comp.node_names.index("b")] - 1.0) < 1e-9


def test_tline_matched_pure_delay():
    """Matched load: the 1 V incident step arrives at b exactly TD after
    launch, with no reflection back at a."""
    comp = _link(Z0)
    sol = tran(comp, (0.0, 120e-9),
               opts=TranOptions(rtol=1e-4, atol=1e-7, max_steps=16384))
    assert sol.converged
    # before arrival / after arrival at the far end (edge at 10n + 25n)
    assert abs(float(sol.interp("b", 30e-9))) < 0.02
    assert abs(float(sol.interp("b", 45e-9)) - 1.0) < 0.02
    assert abs(float(sol.interp("b", 110e-9)) - 1.0) < 0.02
    # matched: a holds the 1 V incident level past the 2*TD echo time
    assert abs(float(sol.interp("a", 70e-9)) - 1.0) < 0.02


def test_tline_open_end_reflection():
    """Open far end: v(b) doubles to 2 V on arrival; the reflection returns
    to a at 2*TD after launch, stepping v(a) from 1 V to 2 V."""
    comp = _link(1e9)
    sol = tran(comp, (0.0, 120e-9),
               opts=TranOptions(rtol=1e-4, atol=1e-7, max_steps=16384))
    assert sol.converged
    assert abs(float(sol.interp("b", 45e-9)) - 2.0) < 0.04
    assert abs(float(sol.interp("a", 50e-9)) - 1.0) < 0.04   # before echo
    assert abs(float(sol.interp("a", 70e-9)) - 2.0) < 0.04   # after 60 ns


def test_tline_ac_quarter_wave_transformer():
    """Exact Y(f) stamps: at f0 = 1/(4*TD) the line is a quarter-wave
    transformer, Zin = Z0^2/RL; at 1/(2*TD) a half-wave repeater,
    Zin = RL.  Closed-form dividers against the matched source."""
    rl = 25.0
    comp = _link(rl, pulse=False)
    f0, f1 = 1.0 / (4 * TD), 1.0 / (2 * TD)
    sol = ac(comp, np.array([f0, f1]))
    va = np.asarray(sol["a"])
    zin_q, zin_h = Z0 ** 2 / rl, rl
    assert abs(abs(va[0]) - zin_q / (zin_q + Z0)) < 1e-6
    assert abs(abs(va[1]) - zin_h / (zin_h + Z0)) < 1e-6


def test_tline_ac_bias_is_dc_short():
    """Regression: the AC analysis biases in DCOP mode, where the line is a
    DC short — a capacitive far-end load has no other DC path, so an
    AC-mode bias (line open there: small-signal physics lives in the Y(f)
    stamps) would leave node b floating/at 0 instead of at the source."""
    from cedarsim_tpu import Capacitor
    ckt = Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    ckt.add(VSource, "V1", (vin, ckt.gnd), dict(dc=2.0, ac=1.0))
    ckt.add(Resistor, "RS", (vin, a), dict(r=Z0))
    ckt.add(TLine, "T1", (a, ckt.gnd, b, ckt.gnd), dict(z0=Z0, td=TD))
    ckt.add(Capacitor, "CL", (b, ckt.gnd), dict(c=1e-12))
    comp = compile_circuit(ckt)
    sol = ac(comp, np.array([1e6]))
    xb = float(np.asarray(sol.op_x)[comp.node_names.index("b")])
    assert abs(xb - 2.0) < 1e-6, xb           # biased through the line
    assert np.all(np.isfinite(np.asarray(sol.v)))


def test_tline_netlist_card():
    """T card end-to-end through the SPICE frontend, incl. F=/NL= timing."""
    out = simulate("""* tline card
V1 vin 0 PULSE(0 2 10n 0.2n 0.2n 200n 1m)
RS vin a 50
T1 a 0 b 0 Z0=50 TD=25n
RL b 0 50
.tran 1n 60n
""")
    sol = out["tran"]
    assert abs(float(sol.interp("b", 45e-9)) - 1.0) < 0.02
    # F=10MEG -> quarter wave default NL=0.25: td = 0.25/10e6 = 25 ns
    from cedarsim_tpu import parse_spice, elaborate
    nl = parse_spice("""* tline f card
V1 vin 0 DC 1
RS vin a 50
T1 a 0 b 0 Z0=50 F=10MEG
RL b 0 50
.end
""", file="t2.cir")
    comp = elaborate(nl)
    comp = compile_circuit(comp)
    g = [comp.groups[k] for k in comp.group_order
         if "tline" in k.lower()][0]
    assert abs(float(g.static_params.get(
        "td", g.instances[0].params["td"])) - 25e-9) < 1e-15


def test_tline_multiple_echo_staircase():
    """Mismatched source (Rs=10, gamma_s=-2/3) + open end (gamma_L=1): the
    far-end voltage is a ringing staircase with exact closed-form levels
    v(b) after the k-th arrival = 2*(1 - (-2/3)^k ... ) — computed by the
    bounce diagram below.  Stresses the breakpoint echo closure and the
    h <= td/2 cap across many in-flight reflections."""
    rs = 10.0
    ckt = Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    ckt.add(VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=2.0, td=10e-9, tr=0.2e-9, tf=0.2e-9,
                 pw=1e-3, per=2e-3))
    ckt.add(Resistor, "RS", (vin, a), dict(r=rs))
    ckt.add(TLine, "T1", (a, ckt.gnd, b, ckt.gnd), dict(z0=Z0, td=TD))
    ckt.add(Resistor, "RL", (b, ckt.gnd), dict(r=1e9))
    comp = compile_circuit(ckt)
    sol = tran(comp, (0.0, 150e-9),
               opts=TranOptions(rtol=1e-4, atol=1e-7, max_steps=32768))
    assert sol.converged
    # bounce diagram: launch 2*Z0/(Z0+rs) = 5/3; gamma_s = -2/3, gamma_L = 1
    gs = (rs - Z0) / (rs + Z0)
    w = 2.0 * Z0 / (Z0 + rs)         # first forward wave
    vb = 0.0
    arrivals = []                     # v(b) level after each odd multiple
    for _ in range(3):
        vb += 2.0 * w                 # open end doubles the incident wave
        arrivals.append(vb)
        w *= gs                       # reflect off the source
    # edges at 10n + 25n, +75n, +125n; probe mid-interval
    for t_probe, want in zip((45e-9, 95e-9, 145e-9), arrivals):
        got = float(sol.interp("b", t_probe))
        assert abs(got - want) < 0.05, (t_probe, got, want)


def test_tline_mixed_precision_eval():
    """The mixed-precision mode (f32 model evals, f64 states/solves, cap-form
    BDF2, chord Newton) through the delay channel: matched line stays a
    pure delay.  Catches dtype bugs in the aux-input cast path."""
    import jax.numpy as jnp
    ckt = Circuit()
    vin, a, b = ckt.net("vin"), ckt.net("a"), ckt.net("b")
    ckt.add(VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=2.0, td=10e-9, tr=0.5e-9, tf=0.5e-9,
                 pw=200e-9, per=1e-3))
    ckt.add(Resistor, "RS", (vin, a), dict(r=Z0))
    ckt.add(TLine, "T1", (a, ckt.gnd, b, ckt.gnd), dict(z0=Z0, td=TD))
    ckt.add(Resistor, "RL", (b, ckt.gnd), dict(r=Z0))
    comp = compile_circuit(ckt, eval_dtype=jnp.float32)
    assert comp.eval_dtype == jnp.float32
    sol = tran(comp, (0.0, 120e-9),
               opts=TranOptions(max_steps=16384, jac_reuse=1,
                                newton_reltol=1e-4, newton_abstol=5e-7,
                                res_tol=1e-3, jac_shunt=1e-7, res_rel=3e-5,
                                rtol=1e-3, atol=1e-5))
    assert sol.converged
    assert abs(float(sol.interp("b", 30e-9))) < 0.02
    assert abs(float(sol.interp("b", 60e-9)) - 1.0) < 0.02
    assert abs(float(sol.interp("a", 70e-9)) - 1.0) < 0.02

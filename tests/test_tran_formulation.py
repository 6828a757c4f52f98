"""Corrector formulations: charge-form vs capacitance-form equivalence.

The cap form exists because f32 transcendentals carry ~1e-6 relative
error, and the charge-form
corrector divides that noise by h — Newton then floors at ~1e-5 A residuals
for small steps and the run aborts (observed on the BSIM4 DFF at t=1.3 ps).
The cap form S(x) + C(x)·ẋ(x) keeps eval noise relative.  Both forms must
agree on physics.
"""

import math

import numpy as np

from cedarsim_tpu import (Circuit, Resistor, Capacitor, Diode, VSourcePULSE,
                          compile_circuit, tran, TranOptions)


def _rc():
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=3.3, td=1e-6, tr=1e-9, tf=1e-9, pw=4e-6,
                 per=10e-6))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    return compile_circuit(ckt)


def test_cap_form_rc_matches_analytic():
    c = _rc()
    sol = tran(c, (0.0, 20e-6), opts=TranOptions(formulation="cap"))
    assert sol.converged
    v = float(sol.interp("vout", 2e-6))
    exact = 3.3 * (1 - math.exp(-(2e-6 - 1.0005e-6) / 1e-6))
    assert abs(v - exact) < 0.02, (v, exact)


def test_cap_vs_charge_nonlinear_capacitance():
    """Diode junction capacitance (voltage-dependent C): the two
    formulations differ by O(LTE) only."""
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=0.0, v2=0.6, td=1e-9, tr=1e-10, tf=1e-10, pw=40e-9,
                 per=100e-9))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=10e3))
    ckt.add(Diode, "D1", (vout, ckt.gnd),
            {"is": 1e-14, "n": 1.5, "cj0": 5e-12, "vj": 0.7, "m": 0.4,
             "tt": 1e-9})
    c = compile_circuit(ckt)
    sols = {f: tran(c, (0.0, 60e-9), opts=TranOptions(formulation=f))
            for f in ("charge", "cap")}
    assert all(s.converged for s in sols.values())
    tgrid = np.linspace(2e-9, 58e-9, 40)
    va = np.interp(tgrid, sols["charge"].ts, sols["charge"]["vout"])
    vb = np.interp(tgrid, sols["cap"].ts, sols["cap"]["vout"])
    assert np.abs(va - vb).max() < 5e-3, np.abs(va - vb).max()

"""Full-Newton rescue of a failed per-step chord certify (advisor r2 #4).

The per-step chord Newton (TranOptions.jac_reuse=1) iterates with a frozen
predictor-point Jacobian; on a hard step (here: a diode rectifier driven
across its knee by ±5 V edges, with max_newton squeezed to 4) the linear
chord iteration fails to certify where the quadratic full-Newton rescue
(TranOptions.chord_fallback) converges.  These tests pin that the rescue
actually rescues — fewer rejected step attempts than a fallback-disabled
control, with the waveform unchanged vs a full-Newton reference — so a
regression in the second while_loop's seed plumbing (the round-2
flaky-lane fix, analysis/tran.py newton_step ``seed=``) cannot pass
silently.  Robustness bar: the reference's per-solve retry discipline,
/root/reference/src/dcop.jl:53-94, applied per-step.
"""

import dataclasses

import numpy as np
import pytest

from cedarsim_tpu import (Circuit, Resistor, Capacitor, Diode, VSourcePULSE,
                          compile_circuit, tran, TranOptions)


def _rectifier():
    """Half-wave rectifier: ±5 V pulse through 100 Ω into a diode — each
    edge drags the operating point across the exponential knee, the worst
    case for a frozen-Jacobian chord iteration."""
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSourcePULSE, "Vin", (vin, ckt.gnd),
            dict(v1=-5.0, v2=5.0, td=1e-7, tr=1e-9, tf=1e-9, pw=4e-7,
                 per=1e-6))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=100.0))
    ckt.add(Diode, "D1", (vout, ckt.gnd), dict(**{"is": 1e-14}, n=1.0))
    ckt.add(Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-12))
    return compile_circuit(ckt)


TSPAN = (0.0, 2e-6)
#: max_newton=4: enough for the quadratic rescue, starvation for the
#: linear chord on the knee-crossing steps (probed 2026-08-19: fallback
#: 34 rejections / control 66 on this circuit)
#: rescue_after=0: engage the rescue on ANY chord certify failure so the
#: seed plumbing is exercised deterministically; the production default
#: (rescue_after=2) only engages on failure streaks — see
#: test_rescue_gate_semantics.
BASE = TranOptions(jac_reuse=1, max_newton=4, rtol=1e-2, atol=1e-4,
                   max_steps=8192, rescue_after=0)


def test_rescue_accepts_where_chord_alone_rejects():
    comp = _rectifier()
    fb = tran(comp, TSPAN, opts=dataclasses.replace(BASE,
                                                    chord_fallback=True))
    ctl = tran(comp, TSPAN, opts=dataclasses.replace(BASE,
                                                     chord_fallback=False))
    assert fb.converged and ctl.converged
    # the control must actually exercise the failure mode (chord certify
    # fails → h-collapse retries), else this test tests nothing
    assert ctl.n_rejected >= fb.n_rejected + 10, \
        (ctl.n_rejected, fb.n_rejected)
    # and the rescue must convert those failures into accepted steps, not
    # merely shuffle work: strictly fewer rejections AND fewer total
    # Newton iterations than grinding through h-collapse
    assert fb.n_rejected < ctl.n_rejected
    assert fb.n_newton < ctl.n_newton, (fb.n_newton, ctl.n_newton)


def test_rescue_waveform_matches_full_newton_reference():
    """The rescue changes the iteration path only — a converged point
    satisfies the same corrector equation, so the waveform must agree
    with a full-Newton (jac_reuse=0, generous budget) reference."""
    comp = _rectifier()
    ref = tran(comp, TSPAN, opts=TranOptions(rtol=1e-3, atol=1e-5,
                                             max_steps=16384))
    fb = tran(comp, TSPAN, opts=dataclasses.replace(BASE,
                                                    chord_fallback=True))
    assert ref.converged and fb.converged
    for t in np.linspace(1.5e-7, 1.9e-6, 9):
        want = float(ref.interp("vout", t))
        got = float(fb.interp("vout", t))
        assert abs(got - want) < 0.03, (t, got, want)


@pytest.mark.parametrize("form", ["cap", "charge"])
def test_rescue_engages_on_both_formulations(form):
    """The seed plumbing differs per formulation (cap form seeds ic from
    the predictor's C·v; charge form from (S, Q)) — exercise both."""
    comp = _rectifier()
    base = dataclasses.replace(BASE, formulation=form)
    fb = tran(comp, TSPAN, opts=dataclasses.replace(base,
                                                    chord_fallback=True))
    ctl = tran(comp, TSPAN, opts=dataclasses.replace(base,
                                                     chord_fallback=False))
    assert fb.converged
    assert fb.n_rejected < ctl.n_rejected, (form, fb.n_rejected,
                                            ctl.n_rejected)


def test_rescue_gate_semantics():
    """TranOptions.rescue_after gates engagement on a consecutive-Newton-
    failure streak (the h-collapse spiral signature): an unreachable
    threshold must behave exactly like chord_fallback=False on a circuit
    whose chord misses are one-offs, and 0 must engage immediately.  The
    gate exists because an ungated rescue under vmap runs its body for
    the whole batch on any lane's miss, a several-fold batched-throughput
    cost on the DFF bench."""
    comp = _rectifier()
    off = tran(comp, TSPAN, opts=dataclasses.replace(
        BASE, chord_fallback=False))
    gated_out = tran(comp, TSPAN, opts=dataclasses.replace(
        BASE, rescue_after=1 << 20))
    eager = tran(comp, TSPAN, opts=dataclasses.replace(
        BASE, rescue_after=0))
    assert gated_out.converged and eager.converged
    # unreachable gate == fallback disabled: identical step accounting
    assert (gated_out.n_rejected, gated_out.n_newton) \
        == (off.n_rejected, off.n_newton)
    # immediate engagement rescues: strictly fewer rejections
    assert eager.n_rejected < gated_out.n_rejected

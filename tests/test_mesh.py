"""Mesh-sharded sweep execution on the 8-device virtual CPU mesh (conftest
forces ``--xla_force_host_platform_device_count=8``) — the multi-chip
data-parallel axis of SURVEY.md §2.11, replacing the reference's serial
``remake`` broadcast loop (/root/reference/src/sweeps.jl:471-502).  Physics
is gated per lane against closed forms, so a sharding bug that permutes or
clobbers lanes cannot pass."""

import numpy as np

import jax

from cedarsim_tpu import (Circuit, Resistor, Capacitor, VSource, VSourcePULSE,
                          compile_circuit, Sweep, SimSpec)
from cedarsim_tpu.parallel.mesh import (make_mesh, dc_sweep_sharded,
                                        tran_sweep_sharded)


def _divider():
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSource, "V1", (vin, ckt.gnd), dict(dc=5.0))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(Resistor, "R2", (vout, ckt.gnd), dict(r=1000.0))
    return compile_circuit(ckt, dynamic_params=["r"])


def test_dc_sweep_sharded_divider_physics():
    mesh = make_mesh()
    assert mesh.size == 8, mesh
    comp = _divider()
    r2s = np.linspace(500.0, 4000.0, 11)  # 11 deliberately not % 8
    res = dc_sweep_sharded(comp, Sweep("R2.r", r2s), mesh)
    assert np.asarray(res.converged).all()
    iv = comp.node_names.index("vout")
    got = np.asarray(res.x)[:, iv]
    want = 5.0 * r2s / (1000.0 + r2s)
    assert np.abs(got - want).max() < 1e-7


def test_tran_sweep_sharded_rc_physics():
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=2.0, td=1e-6, tr=1e-9, tf=1e-9, pw=8e-6,
                 per=20e-6))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    comp = compile_circuit(ckt, dynamic_params=["r"])
    mesh = make_mesh()
    rs = np.linspace(500.0, 2200.0, 8)
    res = tran_sweep_sharded(comp, Sweep("R1.r", rs), (0.0, 6e-6), mesh)
    assert np.asarray(res.finished).all()
    iv = comp.node_names.index("vout")
    ts = np.asarray(res.ts)
    vs = np.asarray(res.xs)[:, :, iv]
    t_probe = 3e-6   # 2 us into the charge, per-lane tau = r*1n
    for lane, r in enumerate(rs):
        got = np.interp(t_probe, ts[lane], vs[lane])
        want = 2.0 * (1 - np.exp(-(t_probe - 1e-6 - 0.5e-9) / (r * 1e-9)))
        assert abs(got - want) < 5e-3, (lane, r, got, want)
    # lanes genuinely differ (distinct taus -> distinct trajectories)
    assert np.abs(np.interp(t_probe, ts[0], vs[0])
                  - np.interp(t_probe, ts[-1], vs[-1])) > 0.05


def test_tran_sweep_sharded_respects_new_tspan():
    """Regression: tspan/h0 must be runtime data to the cached sharded
    program.  A DC-only circuit has the same breakpoint-schedule length
    ([tstop, inf]) for every span, so a cache key missing tstop would
    silently replay the first call's program for the second span."""
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSource, "V1", (vin, ckt.gnd), dict(dc=1.0))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    comp = compile_circuit(ckt, dynamic_params=["r"])
    mesh = make_mesh()
    rs = np.linspace(800.0, 1200.0, 8)
    r1 = tran_sweep_sharded(comp, Sweep("R1.r", rs), (0.0, 1e-6), mesh)
    r2 = tran_sweep_sharded(comp, Sweep("R1.r", rs), (0.0, 5e-6), mesh)
    assert np.asarray(r1.finished).all() and np.asarray(r2.finished).all()
    # the padded time buffers end at each call's own tstop
    assert abs(np.asarray(r1.ts).max() - 1e-6) < 1e-12
    assert abs(np.asarray(r2.ts).max() - 5e-6) < 1e-12


def test_tran_sweep_sharded_8_devices_equals_one_device():
    """The CPU twin of the 4-card run: the same lanes on the 8-device mesh
    and on a 1-device mesh agree lane for lane."""
    ckt = Circuit()
    vin, vout = ckt.net("vin"), ckt.net("vout")
    ckt.add(VSourcePULSE, "V1", (vin, ckt.gnd),
            dict(v1=0.0, v2=2.0, td=1e-6, tr=1e-9, tf=1e-9, pw=2e-6,
                 per=20e-6))
    ckt.add(Resistor, "R1", (vin, vout), dict(r=1000.0))
    ckt.add(Capacitor, "C1", (vout, ckt.gnd), dict(c=1e-9))
    comp = compile_circuit(ckt, dynamic_params=["r"])
    rs = np.linspace(500.0, 2200.0, 12)       # padded to 16 on 8 devices
    sw = Sweep("R1.r", rs)
    r8 = tran_sweep_sharded(comp, sw, (0.0, 5e-6), make_mesh(8))
    r1 = tran_sweep_sharded(comp, sw, (0.0, 5e-6), make_mesh(1))
    assert np.asarray(r8.finished).all() and np.asarray(r1.finished).all()
    np.testing.assert_array_equal(np.asarray(r8.n_accepted),
                                  np.asarray(r1.n_accepted))
    iv = comp.node_names.index("vout")
    t = np.linspace(0.0, 5e-6, 51)
    for lane in range(len(rs)):
        v8 = np.interp(t, np.asarray(r8.ts[lane]),
                       np.asarray(r8.xs[lane, :, iv]))
        v1 = np.interp(t, np.asarray(r1.ts[lane]),
                       np.asarray(r1.xs[lane, :, iv]))
        assert np.max(np.abs(v8 - v1)) <= 1e-9, lane

"""Built-in SPICE device models, batched vectorized stamps.

Behavioral reference: /root/reference/src/simpledevices.jl — SimpleResistor
(:49-77, value-or-sheet resistance + 4kT/R thermal noise), SimpleCapacitor
(:99-109), SimpleInductor (:122-132), SimpleDiode (:134-271, Berkeley-style
exp/breakdown regions + junction & diffusion capacitance), Voltage/Current
sources with mode-switched dc/tran/ac values (:274-339), controlled sources
(:341-373).  The math is re-derived from standard SPICE semantics; only the
observable behavior matches.
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from cedarsim_tpu import config
from cedarsim_tpu.core.context import Modes
from cedarsim_tpu.devices.base import DeviceModel
from cedarsim_tpu.devices import waveforms as wf


def _limexp(x, lim=40.0):
    """exp with linear continuation beyond ``lim`` — keeps Newton finite for
    large junction voltages (standard SPICE limexp; reference relies on
    NaNMath-safe exp, /root/reference/src/va_env.jl:35-75)."""
    xe = jnp.exp(jnp.minimum(x, lim))
    return jnp.where(x <= lim, xe, jnp.exp(lim) * (1.0 + (x - lim)))


class Resistor(DeviceModel):
    terminals = ("p", "n")
    n_noise = 1
    params = dict(r=None, rsh=0.0, l=0.0, w=1e-6, short=0.0, narrow=0.0,
                  tc1=0.0, tc2=0.0, tnom=27.0)
    given_params = ("r",)

    @staticmethod
    def resistance(p, ctx=None):
        den = p["w"] - p["narrow"]
        den = jnp.where(jnp.abs(den) < 1e-15, 1e-15, den)
        r_sheet = p["rsh"] * (p["l"] - p["short"]) / den
        r = jnp.where(p["r$given"] > 0, p["r"], r_sheet)
        if ctx is not None:
            dt = (ctx.temp - config.T_ZERO_C) - p["tnom"]
            r = r * (1.0 + p["tc1"] * dt + p["tc2"] * dt * dt)
        # Sign-preserving floor: tiny negative resistances stay negative
        # instead of silently flipping into tiny positive ones.
        floor = jnp.where(r < 0, -1e-12, 1e-12)
        return jnp.where(jnp.abs(r) < 1e-12, floor, r)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn = lv[0], lv[1]
        g = 1.0 / Resistor.resistance(p, ctx)
        i = g * (vp - vn) + eps[0]
        static = jnp.stack([i, -i])
        return static, jnp.zeros_like(static)

    @classmethod
    def noise(cls, lv, p, ctx):
        r = cls.resistance(p, ctx)
        pwr = 4.0 * config.K_BOLTZMANN * ctx.temp / jnp.abs(r)
        return jnp.stack([pwr]), jnp.zeros((1,))

    @classmethod
    def prepare(cls, raw):
        raw = dict(raw)
        if raw.get("r") is None:
            raw.pop("r", None)
        if "r" not in raw and not raw.get("rsh"):
            raise ValueError(
                "resistor needs either r= or a sheet resistance rsh=")
        p = super().prepare(raw)
        if p["r"] is None:
            p["r"] = 0.0
        return p


class Capacitor(DeviceModel):
    terminals = ("p", "n")
    params = dict(c=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn = lv[0], lv[1]
        q = p["c"] * (vp - vn)
        zero = jnp.zeros_like(q)
        return jnp.stack([zero, zero]), jnp.stack([q, -q])


class Inductor(DeviceModel):
    terminals = ("p", "n")
    n_branch = 1
    params = dict(l=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, il = lv[0], lv[1], lv[2]
        zero = jnp.zeros_like(il)
        # branch eq: (vp - vn) - d/dt (L·i) = 0
        static = jnp.stack([il, -il, vp - vn])
        dynamic = jnp.stack([zero, zero, -p["l"] * il])
        return static, dynamic


class CoupledInductors(DeviceModel):
    """Two magnetically coupled inductors (SPICE K element): the elaborator
    replaces the two L instances with one 4-terminal device.
    v1 = d/dt(L1·i1 + M·i2), v2 = d/dt(M·i1 + L2·i2), M = k·sqrt(L1·L2)."""
    terminals = ("p1", "n1", "p2", "n2")
    n_branch = 2
    params = dict(l1=0.0, l2=0.0, k=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp1, vn1, vp2, vn2, i1, i2 = lv[0], lv[1], lv[2], lv[3], lv[4], lv[5]
        m = p["k"] * jnp.sqrt(p["l1"] * p["l2"])
        zero = jnp.zeros_like(i1)
        static = jnp.stack([i1, -i1, i2, -i2,
                            vp1 - vn1, vp2 - vn2])
        dynamic = jnp.stack([zero, zero, zero, zero,
                             -(p["l1"] * i1 + m * i2),
                             -(m * i1 + p["l2"] * i2)])
        return static, dynamic


# ------------------------------------------------------------------- sources

def _source_value(p, ctx, wave):
    """Mode-dependent source value (reference sim_mode switching,
    /root/reference/src/simpledevices.jl:274-300).  ``wave`` is None for pure
    DC sources, else a function of t."""
    dc = p["dc"]
    if wave is None:
        val = dc
    elif ctx.mode in (Modes.DCOP, Modes.AC):
        val = jnp.where(p["dc$given"] > 0, dc, wave(jnp.zeros_like(ctx.time)))
    elif ctx.mode == Modes.TRANOP:
        val = wave(jnp.zeros_like(ctx.time))
    else:  # TRAN
        val = wave(ctx.time)
    return val * ctx.sourcefac


class _VSourceBase(DeviceModel):
    terminals = ("p", "n")
    n_branch = 1
    wave_params: tuple = ()

    @classmethod
    def _wave(cls, p):
        return None

    @classmethod
    def eval_with_wave(cls, lv, p, ctx, eps):
        vp, vn, ib = lv[0], lv[1], lv[2]
        v = _source_value(p, ctx, cls._wave(p))
        static = jnp.stack([ib, -ib, vp - vn - v])
        return static, jnp.zeros_like(static)

    @classmethod
    def ac_rhs(cls, p):
        mag = p["ac"]
        ph = p["acphase"] * (jnp.pi / 180.0)
        b = mag * jnp.exp(1j * ph)
        zero = jnp.zeros_like(b)
        return jnp.stack([zero, zero, b])


class VSource(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0)
    given_params = ("dc",)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSource.eval_with_wave(lv, p, ctx, eps)


class VSourcePWL(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, ts=(), ys=())
    given_params = ("dc",)

    @classmethod
    def group_key(cls, inst_params):
        return f"{cls.__name__}[{len(inst_params['ts'])}]"

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.pwl_value(p["ts"], p["ys"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourcePWL.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.pwl_breakpoints(p["ts"], tstop)


class VSourcePULSE(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, v1=0.0, v2=0.0, td=0.0,
                  tr=1e-15, tf=1e-15, pw=jnp.inf, per=jnp.inf)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.pulse_value(
            p["v1"], p["v2"], p["td"], p["tr"], p["tf"], p["pw"], p["per"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourcePULSE.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        import numpy as np
        return wf.pulse_breakpoints(
            float(p["v1"]), float(p["v2"]), float(p["td"]), float(p["tr"]),
            float(p["tf"]), float(np.minimum(p["pw"], 1e30)),
            float(np.minimum(p["per"], 1e30)) if np.isfinite(p["per"]) else np.inf,
            tstop)


class VSourceSIN(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, vo=0.0, va=0.0, freq=0.0,
                  td=0.0, theta=0.0, phase=0.0)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.sin_value(
            p["vo"], p["va"], p["freq"], p["td"], p["theta"], p["phase"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourceSIN.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.sin_breakpoints(float(p["td"]), tstop)


class VSourceEXP(_VSourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, v1=0.0, v2=0.0, td1=0.0,
                  tau1=1e-9, td2=1e30, tau2=1e-9)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.exp_value(p["v1"], p["v2"], p["td1"], p["tau1"],
                                      p["td2"], p["tau2"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return VSourceEXP.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.exp_breakpoints(float(p["td1"]), float(p["td2"]), tstop)


class _ISourceBase(DeviceModel):
    terminals = ("p", "n")

    @classmethod
    def _wave(cls, p):
        return None

    @classmethod
    def eval_with_wave(cls, lv, p, ctx, eps):
        i = _source_value(p, ctx, cls._wave(p))
        static = jnp.stack([i, -i])
        return static, jnp.zeros_like(static)

    @classmethod
    def ac_rhs(cls, p):
        mag = p["ac"]
        ph = p["acphase"] * (jnp.pi / 180.0)
        b = mag * jnp.exp(1j * ph)
        return jnp.stack([-b, b])


class ISource(_ISourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0)
    given_params = ("dc",)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISource.eval_with_wave(lv, p, ctx, eps)


class ISourcePWL(_ISourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, ts=(), ys=())
    given_params = ("dc",)

    @classmethod
    def group_key(cls, inst_params):
        return f"{cls.__name__}[{len(inst_params['ts'])}]"

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.pwl_value(p["ts"], p["ys"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourcePWL.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.pwl_breakpoints(p["ts"], tstop)


class ISourcePULSE(_ISourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, v1=0.0, v2=0.0, td=0.0,
                  tr=1e-15, tf=1e-15, pw=jnp.inf, per=jnp.inf)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.pulse_value(
            p["v1"], p["v2"], p["td"], p["tr"], p["tf"], p["pw"], p["per"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourcePULSE.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return VSourcePULSE.breakpoints.__func__(cls, p, tstop)


class ISourceEXP(_ISourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, v1=0.0, v2=0.0, td1=0.0,
                  tau1=1e-9, td2=1e30, tau2=1e-9)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.exp_value(p["v1"], p["v2"], p["td1"], p["tau1"],
                                      p["td2"], p["tau2"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourceEXP.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.exp_breakpoints(float(p["td1"]), float(p["td2"]), tstop)


class ISourceSIN(_ISourceBase):
    params = dict(dc=0.0, ac=0.0, acphase=0.0, vo=0.0, va=0.0, freq=0.0,
                  td=0.0, theta=0.0, phase=0.0)
    given_params = ("dc",)

    @classmethod
    def _wave(cls, p):
        return lambda t: wf.sin_value(
            p["vo"], p["va"], p["freq"], p["td"], p["theta"], p["phase"], t)

    @staticmethod
    def eval(lv, p, ctx, eps):
        return ISourceSIN.eval_with_wave(lv, p, ctx, eps)

    @classmethod
    def breakpoints(cls, p, tstop):
        return wf.sin_breakpoints(float(p["td"]), tstop)


# --------------------------------------------------------- controlled sources

class VCVS(DeviceModel):
    """E element: V(p,n) = gain·V(cp,cn)
    (/root/reference/src/simpledevices.jl:341-356)."""
    terminals = ("p", "n", "cp", "cn")
    n_branch = 1
    params = dict(gain=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, vcp, vcn, ib = lv[0], lv[1], lv[2], lv[3], lv[4]
        zero = jnp.zeros_like(ib)
        static = jnp.stack([ib, -ib, zero, zero, vp - vn - p["gain"] * (vcp - vcn)])
        return static, jnp.zeros_like(static)


class VCCS(DeviceModel):
    """G element: I(p→n) = gm·V(cp,cn)."""
    terminals = ("p", "n", "cp", "cn")
    params = dict(gm=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vcp, vcn = lv[2], lv[3]
        i = p["gm"] * (vcp - vcn)
        zero = jnp.zeros_like(i)
        static = jnp.stack([i, -i, zero, zero])
        return static, jnp.zeros_like(static)


class CCVS(DeviceModel):
    """H element: V(p,n) = r·I(ctrl_vsource).  The control is a gathered
    branch-current unknown (n_control=1, resolved by the compiler)."""
    terminals = ("p", "n")
    n_branch = 1
    n_control = 1
    params = dict(r=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, ib, ictrl = lv[0], lv[1], lv[2], lv[3]
        static = jnp.stack([ib, -ib, vp - vn - p["r"] * ictrl])
        return static, jnp.zeros_like(static)


class CCCS(DeviceModel):
    """F element: I(p→n) = f·I(ctrl_vsource)."""
    terminals = ("p", "n")
    n_control = 1
    params = dict(f=1.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        ictrl = lv[2]
        i = p["f"] * ictrl
        static = jnp.stack([i, -i])
        return static, jnp.zeros_like(static)


class VSwitch(DeviceModel):
    """S element: voltage-controlled switch (.model sw ron/roff/vt/vh) with
    ngspice-style smooth log-resistance interpolation between states (the
    reference declares Switch but leaves it unimplemented,
    /root/reference/src/simpledevices.jl:375-408)."""
    terminals = ("p", "n", "cp", "cn")
    params = dict(ron=1.0, roff=1e12, vt=0.0, vh=0.0)

    @staticmethod
    def _g(ctrl, p):
        vh = jnp.maximum(p["vh"], 1e-6)
        x = jnp.clip((ctrl - p["vt"]) / (2.0 * vh) + 0.5, 0.0, 1.0)
        # smoothstep in log-conductance
        t = x * x * (3.0 - 2.0 * x)
        ln_g = jnp.log(1.0 / p["roff"]) + t * (
            jnp.log(1.0 / p["ron"]) - jnp.log(1.0 / p["roff"]))
        return jnp.exp(ln_g)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, vcp, vcn = lv[0], lv[1], lv[2], lv[3]
        i = VSwitch._g(vcp - vcn, p) * (vp - vn)
        zero = jnp.zeros_like(i)
        static = jnp.stack([i, -i, zero, zero])
        return static, jnp.zeros_like(static)


class ISwitch(DeviceModel):
    """W element: current-controlled switch (control = a V-source branch
    current)."""
    terminals = ("p", "n")
    n_control = 1
    params = dict(ron=1.0, roff=1e12, it=0.0, ih=0.0)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, ictrl = lv[0], lv[1], lv[2]
        g = VSwitch._g(ictrl, dict(ron=p["ron"], roff=p["roff"],
                                   vt=p["it"], vh=p["ih"]))
        i = g * (vp - vn)
        static = jnp.stack([i, -i])
        return static, jnp.zeros_like(static)


# --------------------------------------------------------------------- diode

class Diode(DeviceModel):
    """Berkeley-style junction diode (behavior per
    /root/reference/src/simpledevices.jl:134-271): exponential forward region,
    saturation reverse region, exponential breakdown beyond -bv; depletion
    (cj0/vj/m/fc) + diffusion (tt) charge; shot noise 2qI."""
    terminals = ("p", "n")
    n_noise = 1
    params = dict(**{"is": 1e-14}, n=1.0, cj0=0.0, vj=1.0, m=0.5, fc=0.5,
                  tt=0.0, bv=jnp.inf, ibv=1e-3, area=1.0,
                  eg=1.11, xti=3.0, tnom=27.0)
    given_params = ("bv",)

    @staticmethod
    def isat_t(p, ctx):
        """Saturation-current temperature scaling (Berkeley):
        IS(T) = IS·(T/Tnom)^(XTI/N)·exp(EG/(N·Vt)·(T/Tnom − 1))."""
        tnom = p["tnom"] + config.T_ZERO_C
        tr = ctx.temp / tnom
        vt = ctx.vt
        return (p["is"] * p["area"] * jnp.power(tr, p["xti"] / p["n"])
                * jnp.exp(p["eg"] / (p["n"] * vt) * (tr - 1.0)))

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn = lv[0], lv[1]
        v = vp - vn
        vte = p["n"] * ctx.vt
        isat = Diode.isat_t(p, ctx)
        # forward / reverse-saturation
        i_fwd = isat * (_limexp(v / vte) - 1.0)
        # breakdown (only if bv given): current pulls v back above -bv
        i_brk = -isat * _limexp(-(p["bv"] + v) / vte)
        use_brk = jnp.logical_and(p["bv$given"] > 0, v < -p["bv"])
        i = jnp.where(use_brk, i_brk, i_fwd) + ctx.gmin * v + eps[0]

        # depletion charge, linearized beyond fc·vj (standard SPICE)
        cj0 = p["cj0"] * p["area"]
        vj, mj, fc = p["vj"], p["m"], p["fc"]
        qdep_below = cj0 * vj / (1.0 - mj) * (
            1.0 - jnp.power(jnp.maximum(1.0 - v / vj, 1e-6), 1.0 - mj))
        f1 = vj / (1.0 - mj) * (1.0 - jnp.power(1.0 - fc, 1.0 - mj))
        f2 = jnp.power(1.0 - fc, -(1.0 + mj))
        qdep_above = cj0 * (f1 + f2 * ((1.0 - fc * (1.0 + mj)) * (v - fc * vj)
                                       + 0.5 * mj / vj * (v * v - fc * fc * vj * vj)))
        qdep = jnp.where(v < fc * vj, qdep_below, qdep_above)
        # diffusion charge
        qdiff = p["tt"] * i_fwd
        q = qdep + qdiff
        return jnp.stack([i, -i]), jnp.stack([q, -q])

    @classmethod
    def noise(cls, lv, p, ctx):
        v = lv[0] - lv[1]
        vte = p["n"] * ctx.vt
        i = cls.isat_t(p, ctx) * (_limexp(v / vte) - 1.0)
        pwr = 2.0 * config.Q_CHARGE * jnp.abs(i)
        return jnp.stack([pwr]), jnp.zeros((1,))


# ------------------------------------------------------- functional devices

class OpenCircuit(DeviceModel):
    """Two terminals, no contribution (reference OpenCircuit,
    /root/reference/src/simpledevices.jl:92-97 role) — placeholder for
    stubbed-out elements without touching the netlist topology."""
    terminals = ("p", "n")
    params = {}

    @staticmethod
    def eval(lv, p, ctx, eps):
        zero = jnp.zeros((2,), lv.dtype)
        return zero, zero


class ShortCircuit(DeviceModel):
    """Ideal short: V(p) − V(n) = 0 enforced through a branch-current
    unknown (reference ShortCircuit role) — merges two nets without
    editing connectivity."""
    terminals = ("p", "n")
    n_branch = 1
    params = {}

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp, vn, i = lv[0], lv[1], lv[2]
        static = jnp.stack([i, -i, vp - vn])
        return static, jnp.zeros_like(static)


def nonlinear_resistor(f, name="NonlinearResistor"):
    """Device-class factory: two-terminal element with I = f(V(p,n))
    (reference NonlinearResistor, /root/reference/src/simpledevices.jl:79-86
    — there a closure over `branch!`; here a pure traceable function whose
    Jacobian comes from the same per-class jacfwd as every device)."""
    class _NLR(DeviceModel):
        terminals = ("p", "n")
        params = {}

        @staticmethod
        def eval(lv, p, ctx, eps):
            i = f(lv[0] - lv[1])
            static = jnp.stack([i, -i])
            return static, jnp.zeros_like(static)

    _NLR.__name__ = _NLR.__qualname__ = name
    return _NLR


def nonlinear_capacitor(f, name="NonlinearCapacitor"):
    """Device-class factory: two-terminal element with charge Q = f(V(p,n))
    (reference NonlinearCapacitor, simpledevices.jl:88-90)."""
    class _NLC(DeviceModel):
        terminals = ("p", "n")
        params = {}

        @staticmethod
        def eval(lv, p, ctx, eps):
            q = f(lv[0] - lv[1])
            zero = jnp.zeros_like(q)
            return jnp.stack([zero, zero]), jnp.stack([q, -q])

    _NLC.__name__ = _NLC.__qualname__ = name
    return _NLC


class TLine(DeviceModel):
    """Lossless transmission line (SPICE T element) by Branin's method of
    characteristics — each port is a Thevenin Z0 source driven by the far
    port's incident wave one line delay ago:

        V1 − Z0·I1 = E1,  E1(t) = V2(t−td) + Z0·I2(t−td)
        V2 − Z0·I2 = E2,  E2(t) = V1(t−td) + Z0·I1(t−td)

    The delayed waves ride the integrator's exact-history delay channel
    (``n_delay`` aux inputs, analysis/tran.py) — the same machinery as VA
    ``absdelay(…, delay_mode="history")``, so the transient is exact to the
    ring's interpolation error rather than a lumped-LC approximation.  In
    the operating point the line is a DC short (E waves read the live far
    port).  AC/noise use the exact two-port admittance Y(f) of the lossless
    line via the frequency-dependent stamp path (analysis/ac.py); the
    eval-level branch rows pin I=0 there so the physics isn't double
    stamped.  Neither the reference nor its parsers support T elements —
    capability beyond parity."""
    terminals = ("p1", "n1", "p2", "n2")
    n_branch = 2
    n_delay = 2
    params = dict(z0=50.0, td=1e-9)

    @staticmethod
    def eval(lv, p, ctx, eps):
        vp1, vn1, vp2, vn2, i1, i2 = (lv[0], lv[1], lv[2], lv[3],
                                      lv[4], lv[5])
        z0 = p["z0"]
        zero = jnp.zeros_like(i1)
        if ctx.mode == Modes.AC:
            # small-signal physics comes from the exact Y(f) stamp
            return jnp.stack([zero, zero, zero, zero, i1, i2]), \
                jnp.zeros((6,), lv.dtype)
        if ctx.mode in (Modes.DCOP, Modes.TRANOP):
            e1 = (vp2 - vn2) + z0 * i2       # steady state: td irrelevant
            e2 = (vp1 - vn1) + z0 * i1
        else:
            e1, e2 = eps[0], eps[1]          # delayed waves from the ring
        static = jnp.stack([i1, -i1, i2, -i2,
                            (vp1 - vn1) - z0 * i1 - e1,
                            (vp2 - vn2) - z0 * i2 - e2])
        return static, jnp.zeros_like(static)

    @classmethod
    def delays(cls, lv, p, ctx):
        """(u_now, td): the waves the far ports will see one delay later."""
        vp1, vn1, vp2, vn2, i1, i2 = (lv[0], lv[1], lv[2], lv[3],
                                      lv[4], lv[5])
        z0 = p["z0"]
        u = jnp.stack([(vp2 - vn2) + z0 * i2, (vp1 - vn1) + z0 * i1])
        td = jnp.stack([p["td"] + 0 * u[0], p["td"] + 0 * u[0]])
        return u, td

    @classmethod
    def echo_delays(cls, p):
        """Breakpoint echo periods: a waveform corner re-emerges (and
        re-reflects) every line delay — the step controller must expect it
        (SPICE schedules exactly these T-element breakpoints)."""
        return [float(p["td"])]

    @classmethod
    def ac_admittance(cls, p):
        """Exact lossless-line two-port Y(f), expanded to the 4-terminal
        (p1,n1,p2,n2) stamp:  with θ = ω·td,
        Y11 = Y22 = −j·cot(θ)/Z0, Y12 = Y21 = j/(Z0·sin(θ))."""
        z0 = float(p["z0"])
        td = float(p["td"])

        def yfun(f):
            th = 2.0 * jnp.pi * f * td
            s = jnp.sin(th)
            # keep resonances finite: |sin| floored (equivalent to a tiny
            # loss); cot from the same floored sin
            s = jnp.where(jnp.abs(s) < 1e-9, jnp.where(s < 0, -1e-9, 1e-9),
                          s)
            y11 = -1j * jnp.cos(th) / (s * z0)
            y12 = 1j / (s * z0)
            Y2 = jnp.array([[y11, y12], [y12, y11]])
            # 2-port (V1, V2) → 4-node (p1, n1, p2, n2) expansion
            T = jnp.array([[1.0, 0.0], [-1.0, 0.0],
                           [0.0, 1.0], [0.0, -1.0]])
            return (T @ Y2 @ T.T).astype(Y2.dtype)

        return yfun


class LTRALine(DeviceModel):
    """Lossy RLCG transmission-line section (the SPICE O element / ngspice
    LTRA model; the reference *lexes* the O letter,
    /root/reference/SpectreNetlistParser.jl/src/SPICE/tokenize/lexer.jl:581,
    but never implements a runtime — working lossy lines are capability
    beyond parity).

    One instance models a section with series totals R=rtot, L=ltot and
    shunt totals G=gtot, C=ctot (the elaborator cascades K sections for
    heavily lossy lines; each section carries its own share).  Transient =
    lossy method of characteristics: Branin's traveling waves (the exact
    lossless machinery of :class:`TLine`, riding the integrator's
    exact-history delay channel) extended with

      * wave attenuation  α = exp(−R/(2·Z0) − G·Z0/2)  — the exact
        high-frequency transit attenuation of an RLCG line;
      * DC-exactness correction: at steady state the attenuated wave pair
        is a leaky π two-port (series z0(1−α²)/(2α), shunt
        gc = (1−α)/(z0(1+α)) at each wave node).  A −gc shunt folded into
        each branch equation *at the wave node* cancels the π shunts
        exactly, and a series lump ρ = (R − z0(1−α²)/(2α))/2 at each port
        tops the series part up so the DC path resistance is *exactly* R;
      * physical shunt conductance lumps G/2 across each port.

    What a single section does NOT model is the dispersive wave distortion
    inside the section (the RC-diffusion tail of the true impulse response,
    which ngspice obtains by convolution); cascading sections converges to
    it, and the elaborator picks the section count from the per-section
    loss.  DC is exact by construction, and AC/noise bypass the MoC model
    entirely: ``ac_admittance`` stamps the *exact* frequency-domain RLCG
    two-port  Y11 = coth(γ)/Zc, Y12 = −1/(Zc·sinh γ) with
    γ = √((R+jωL)(G+jωC)), Zc = √((R+jωL)/(G+jωC)) — a cascade of exact
    section two-ports is the exact full line at every frequency."""
    terminals = ("p1", "n1", "p2", "n2")
    n_branch = 2
    n_delay = 2
    params = dict(rtot=0.0, ltot=250e-9, gtot=0.0, ctot=100e-12)

    @staticmethod
    def _derived(p):
        z0 = jnp.sqrt(p["ltot"] / p["ctot"])
        alpha = jnp.exp(-p["rtot"] / (2.0 * z0) - p["gtot"] * z0 / 2.0)
        # DC π-equivalent of the attenuated wave pair
        rs_w = z0 * (1.0 - alpha * alpha) / (2.0 * alpha)
        gc = (1.0 - alpha) / (z0 * (1.0 + alpha))
        rho = jnp.maximum(0.0, (p["rtot"] - rs_w) / 2.0)
        return z0, alpha, rho, gc

    @staticmethod
    def _waves(lv, p):
        """U_k (wave-node voltages behind the ρ lumps), iL_k (line currents
        incl. the −gc wave-node compensation shunt), and the outgoing waves
        w_k = U_k + z0·iL_k."""
        vp1, vn1, vp2, vn2, i1, i2 = (lv[0], lv[1], lv[2], lv[3],
                                      lv[4], lv[5])
        z0, alpha, rho, gc = LTRALine._derived(p)
        u1 = (vp1 - vn1) - rho * i1
        u2 = (vp2 - vn2) - rho * i2
        il1 = i1 + gc * u1
        il2 = i2 + gc * u2
        return z0, alpha, u1, u2, il1, il2

    @staticmethod
    def eval(lv, p, ctx, eps):
        i1, i2 = lv[4], lv[5]
        zero = jnp.zeros_like(i1)
        if ctx.mode == Modes.AC:
            # small-signal physics comes from the exact Y(f) stamp
            return jnp.stack([zero, zero, zero, zero, i1, i2]), \
                jnp.zeros((6,), lv.dtype)
        z0, alpha, u1, u2, il1, il2 = LTRALine._waves(lv, p)
        g2 = p["gtot"] / 2.0
        if ctx.mode in (Modes.DCOP, Modes.TRANOP):
            e1 = alpha * (u2 + z0 * il2)
            e2 = alpha * (u1 + z0 * il1)
        else:
            e1, e2 = alpha * eps[0], alpha * eps[1]
        vd1 = lv[0] - lv[1]
        vd2 = lv[2] - lv[3]
        static = jnp.stack([
            i1 + g2 * vd1, -(i1 + g2 * vd1),
            i2 + g2 * vd2, -(i2 + g2 * vd2),
            u1 - z0 * il1 - e1,
            u2 - z0 * il2 - e2])
        return static, jnp.zeros_like(static)

    @classmethod
    def delays(cls, lv, p, ctx):
        """(u_now, td): the un-attenuated outgoing waves at each wave node
        (far port's wave feeds this port one delay later; eval applies α)."""
        z0, _alpha, u1, u2, il1, il2 = cls._waves(lv, p)
        td = jnp.sqrt(p["ltot"] * p["ctot"])
        u = jnp.stack([u2 + z0 * il2, u1 + z0 * il1])
        return u, jnp.stack([td + 0 * u[0], td + 0 * u[0]])

    @classmethod
    def echo_delays(cls, p):
        return [math.sqrt(float(p["ltot"]) * float(p["ctot"]))]

    @classmethod
    def ac_admittance(cls, p):
        """Exact RLCG two-port Y(f) (4-terminal expansion)."""
        r, l = float(p["rtot"]), float(p["ltot"])
        g, c = float(p["gtot"]), float(p["ctot"])

        def yfun(f):
            s = 2j * jnp.pi * f
            zs = r + s * l
            yp = g + s * c
            gl = jnp.sqrt(zs * yp)
            # keep the real part bounded so sinh/cosh never overflow
            # (attenuation e^-300 is zero in every dtype anyway), and keep
            # the lossless resonances finite like TLine
            gl = jnp.clip(jnp.real(gl), 0.0, 300.0) + 1j * jnp.imag(gl)
            sh = jnp.sinh(gl)
            sh = jnp.where(jnp.abs(sh) < 1e-12, 1e-12 + 0j, sh)
            th = jnp.tanh(gl)
            th = jnp.where(jnp.abs(th) < 1e-12, 1e-12 + 0j, th)
            yc = jnp.sqrt(yp / zs)  # 1/Zc
            y11 = yc / th
            y12 = -yc / sh
            Y2 = jnp.array([[y11, y12], [y12, y11]])
            T = jnp.array([[1.0, 0.0], [-1.0, 0.0],
                           [0.0, 1.0], [0.0, -1.0]])
            return (T @ Y2 @ T.T).astype(Y2.dtype)

        return yfun

"""Source waveforms (PWL / PULSE / SIN) — branchless JAX evaluations plus
host-side breakpoint enumeration.

Reference behavior: /root/reference/src/spectre_env.jl —
``pwl_at_time`` (:15-69, binary search + linear interp, ends held),
``pulse`` (:153-166, periodic via right-semi-open remainder),
``spsin`` (:169-176), and breakpoint notification via
``time_periodic_singularities!`` (:71-77, 144-151).  In this build the
breakpoints become a *static sorted array* merged into the transient stepper's
schedule (SURVEY.md §5 "Long-context": static break lists).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def pwl_value(ts, ys, t):
    """Piecewise-linear value at time t; holds end values.  ``jnp.interp``
    implements exactly the reference's hold-ends semantics
    (/root/reference/src/spectre_env.jl:15-69)."""
    return jnp.interp(t, ts, ys)


def pulse_value(v1, v2, td, tr, tf, pw, per, t):
    """SPICE PULSE(v1 v2 td tr tf pw per) at time t, periodic.

    The instant of a discontinuity belongs to the *next* segment
    (right-semi-open remainder, /root/reference/src/spectre_env.jl:29-32).
    """
    tiny = jnp.asarray(1e-15, t.dtype) if hasattr(t, "dtype") else 1e-15
    tr = jnp.maximum(tr, tiny)
    tf = jnp.maximum(tf, tiny)
    tc = jnp.where(per > 0, jnp.mod(t - td, jnp.where(per > 0, per, 1.0)), t - td)
    rise = v1 + (v2 - v1) * tc / tr
    fall = v2 + (v1 - v2) * (tc - tr - pw) / tf
    val = jnp.where(
        tc < tr, rise,
        jnp.where(tc < tr + pw, v2, jnp.where(tc < tr + pw + tf, fall, v1)))
    return jnp.where(t < td, v1, val)


def sin_value(vo, va, freq, td, theta, phase_deg, t):
    """SPICE SIN(vo va freq td theta phase): damped sine after delay td."""
    ph = phase_deg * (np.pi / 180.0)
    active = vo + va * jnp.exp(-(t - td) * theta) * jnp.sin(
        2.0 * np.pi * freq * (t - td) + ph)
    quiescent = vo + va * jnp.sin(ph)
    return jnp.where(t < td, quiescent, active)


def exp_value(v1, v2, td1, tau1, td2, tau2, t):
    """SPICE EXP(v1 v2 td1 tau1 td2 tau2)."""
    rise = v1 + (v2 - v1) * (1.0 - jnp.exp(-(t - td1) / tau1))
    fall = rise + (v1 - v2) * (1.0 - jnp.exp(-(t - td2) / tau2))
    return jnp.where(t < td1, v1, jnp.where(t < td2, rise, fall))


# ---------------------------------------------------------------- breakpoints

def pwl_breakpoints(ts, tstop):
    ts = np.asarray(ts, dtype=np.float64)
    return ts[(ts > 0) & (ts < tstop)]

def pulse_breakpoints(v1, v2, td, tr, tf, pw, per, tstop):
    edges = np.array([0.0, tr, tr + pw, tr + pw + tf])
    if not np.isfinite(per) or per <= 0:
        pts = td + edges
    else:
        n = int(np.floor((tstop - td) / per)) + 1 if tstop > td else 0
        pts = (td + np.arange(max(n, 0) + 1)[:, None] * per + edges[None, :]).ravel()
    return pts[(pts > 0) & (pts < tstop)]

def sin_breakpoints(td, tstop):
    return np.array([td]) if 0 < td < tstop else np.empty(0)


def exp_breakpoints(td1, td2, tstop):
    pts = np.array([td1, td2])
    return pts[(pts > 0) & (pts < tstop)]

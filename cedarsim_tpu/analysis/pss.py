"""Periodic steady state (PSS) of driven circuits by single shooting.

A capability beyond the reference (its long-term list): find x₀ with
Φ(x₀) = x₀ where Φ integrates one drive period T with the adaptive
transient core.  Newton on r(x₀) = Φ(x₀) − x₀ with the monodromy
M = ∂Φ/∂x₀ obtained by FORWARD differentiation through the whole
adaptive integrator (`jax.jacfwd` over ``tran_core`` — the same
jvp-through-the-loop machinery as analysis/sensitivity.py), so the
shooting Jacobian is exact for the realized step sequence.

Batched shape: the n tangent integrations inside jacfwd batch like a
vmap — one XLA program computes Φ and M together.  Typical use: switched
/ RF-driven circuits where the transient to steady state spans thousands
of periods but shooting converges in a handful of Newton iterations.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from cedarsim_tpu.core.compile import CompiledCircuit
from cedarsim_tpu.core.context import SimSpec, Modes
from cedarsim_tpu.ops import linalg
from cedarsim_tpu.analysis.dc import solve_dc
from cedarsim_tpu.analysis.tran import (TranOptions, tran_core,
                                        _consistent_xdot,
                                        _differential_mask, TranSolution)


@dataclasses.dataclass
class PSSResult:
    x0: np.ndarray            # state on the periodic orbit at t = 0
    converged: bool
    iters: int
    resnorm: float            # max |Phi(x0) - x0|
    period: float
    solution: TranSolution    # one steady-state period, starting at x0


def pss(compiled: CompiledCircuit, period: float, params=None,
        ctx: SimSpec = None, opts: TranOptions = None, max_iter: int = 10,
        tol: float = 1e-9, damping: float = 1.0) -> PSSResult:
    """Shooting PSS for a circuit driven at a known ``period``."""
    if getattr(compiled, "n_dly", 0):
        raise NotImplementedError(
            "shooting PSS does not support exact-history delay elements "
            "(TLine / absdelay delay_mode='history'): the shooting state "
            "x0 does not include the in-flight wave history, so the fixed "
            "point would correspond to a flat-history integrator rather "
            "than the true periodic orbit.  Use delay_mode='pade' (state-"
            "based) for PSS.")
    params = compiled.params0 if params is None else params
    if ctx is None:
        from cedarsim_tpu.core.compile import default_ctx
        ctx = default_ctx(compiled)
    opts = opts or TranOptions()
    d = compiled.dtype
    T = float(period)

    op = solve_dc(compiled, params, ctx, mode=Modes.TRANOP)
    ctx_op = ctx.with_mode(Modes.TRANOP)
    mask = _differential_mask(compiled, op.x, ctx_op, params)
    bps = compiled.breakpoints(T)
    bps = np.concatenate([bps, [T], [np.inf]])
    h0 = opts.h0 if opts.h0 is not None else T * 1e-4

    def phi(x0):
        xd0 = _consistent_xdot(compiled, x0, ctx_op, params)
        out = tran_core(compiled, params, ctx, x0, xd0,
                        jnp.asarray(0.0, d), jnp.asarray(T, d),
                        jnp.asarray(bps, d), jnp.asarray(h0, d), opts, mask)
        return out[7]["x"], out[4]

    phi_jit = jax.jit(phi)
    # Phi and monodromy in ONE program: jacfwd carries n tangents through
    # the adaptive loop alongside the primal
    mono_jit = jax.jit(lambda x0: jax.jacfwd(
        lambda xx: phi(xx)[0])(x0))

    x0 = op.x
    converged = False
    resnorm = np.inf
    it = 0
    for it in range(1, max_iter + 1):
        xT, fin = phi_jit(x0)
        r = xT - x0
        resnorm = float(jnp.max(jnp.abs(r)))
        scale = float(jnp.max(jnp.abs(x0))) + 1.0
        if not bool(fin):
            break
        if resnorm <= tol * scale:
            converged = True
            break
        M = mono_jit(x0)
        J = M - jnp.eye(compiled.n_x, dtype=d)
        dx = linalg.solve(J, -r)
        if not bool(jnp.all(jnp.isfinite(dx))):
            break
        x0 = x0 + damping * dx

    # final check + one steady-state period for the caller
    xT, fin = phi_jit(x0)
    resnorm = float(jnp.max(jnp.abs(xT - x0)))
    converged = converged and bool(fin)
    from cedarsim_tpu.analysis.tran import tran
    sol = tran(compiled, (0.0, T), params=params, ctx=ctx, opts=opts, x0=x0)
    return PSSResult(x0=np.asarray(x0), converged=converged, iters=it,
                     resnorm=resnorm, period=T, solution=sol)

"""DC operating point: damped Newton with gmin-stepping and source-stepping
continuation, plus randomized-restart bootstrap.

Reference behavior: CedarDCOp/CedarTranOp initialization
(/root/reference/src/dcop.jl:24-155) — a NonlinearSolve RobustMultiNewton with
up to 10 restarts from 1e-7·randn perturbations (``bootstrapped_nlsolve``,
dcop.jl:53-94).  This build adds the classic SPICE continuation ladders
(gmin / source stepping) and keeps everything inside ``lax`` control flow so a
whole PVT/Monte-Carlo sweep of operating points runs as one ``vmap``-batched
XLA program — the parallel initialization the reference's TODO asks for
(dcop.jl:57).

Compile-latency design: the entire strategy — plain attempt, gmin ladder,
source-stepping ladder, randomized restarts — is ONE ``lax.scan`` over a
static schedule of (gshunt, sourcefac, reset-kind, is-final) rows, with a
single Newton-loop instantiation in the scan body.  XLA compile time scales
with the number of distinct subgraphs, and the naive version (separate
ladders + conds) instantiated the Newton loop once per rung for identical
semantics.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cedarsim_tpu.core.compile import CompiledCircuit
from cedarsim_tpu.core.context import SimSpec, Modes
from cedarsim_tpu.ops import linalg


@dataclasses.dataclass(frozen=True)
class NewtonOptions:
    max_iter: int = 60
    #: per-unknown update tolerance: |dx| <= reltol·|x| + abstol
    reltol: float = 1e-4
    abstol: float = 1e-9
    #: residual tolerance (KCL in amps / branch eq in volts)
    res_tol: float = 1e-9
    #: max Newton update per unknown per iteration (voltage limiting)
    max_step: float = 5.0
    #: global iterate bound |x_i| <= x_limit (SPICE-style node limiting):
    #: keeps wandering continuation iterates inside the model's finite range
    #: (essential with eval_dtype=float32, where exp overflows at ~88)
    x_limit: float = 1e3
    #: Jacobian-only diagonal shunt (inexact Newton damping): added to J but
    #: NOT to the residual, so the converged solution is exact while rows
    #: whose true conductance sits below the eval-noise floor can't produce
    #: runaway updates.  Needed for eval_dtype=float32, where jacfwd noise
    #: (~1e-11 absolute) swamps off-state conductances (~1e-12).
    jac_shunt: float = 0.0
    #: gmin continuation ladder length (decades from gmin_start)
    gmin_steps: int = 10
    gmin_start: float = 1e-2
    #: source stepping points
    src_steps: int = 8
    #: randomized restarts (reference bootstrapped_nlsolve: 10)
    restarts: int = 4


#: sentinel for "params are a single (unbatched) tree" in DCResult._obs
_UNBATCHED = object()


@partial(jax.tree_util.register_dataclass,
         data_fields=["x", "converged", "iters", "resnorm"], meta_fields=[])
@dataclasses.dataclass
class DCResult:
    x: jax.Array
    converged: jax.Array
    iters: jax.Array
    resnorm: jax.Array

    def __getitem__(self, name):
        """Named observable access at the operating point (``res["vout"]``,
        ``res["x1.m1.I"]``) — the reference's ``sol[sys.vout]`` UX.
        Available on results returned by ``solve_dc``/``dc_sweep``/``mc_dc``/
        ``simulate`` (which attach the circuit context after the jitted
        solve; the raw pytree crossing a jit/vmap boundary carries arrays
        only).  Batched results return one value per lane."""
        obs = getattr(self, "_obs", None)
        if obs is None:
            raise TypeError(
                "this DCResult carries no circuit context (it crossed a "
                "jit/vmap boundary raw) — index into .x, or use a result "
                "returned by solve_dc()/dc_sweep()/simulate()")
        compiled, ctx, params, ctx_axes = obs
        fn = compiled.observe(name)
        x = jnp.asarray(self.x)

        def one(xx, pp, cc):
            return fn(xx, jnp.zeros_like(xx), cc, pp)

        if x.ndim == 1:
            out = one(x, params, ctx)
        else:
            p_ax = 0 if ctx_axes is not _UNBATCHED else None
            c_ax = None if ctx_axes in (None, _UNBATCHED) else ctx_axes
            out = jax.vmap(one, in_axes=(0, p_ax, c_ax))(x, params, ctx)
        return np.asarray(out)


def default_newton_options(compiled) -> NewtonOptions:
    """Defaults matched to the circuit's eval precision: with
    ``eval_dtype=float32`` Newton converges into an f32 noise ball
    (dx ~ 5e-8·|x|, f ~ |G|·dx_noise) that the f64 tolerances can never
    certify, so the criteria loosen to just above that floor."""
    if compiled.eval_dtype != compiled.dtype and \
            compiled.eval_dtype == jnp.float32:
        # x_limit 100: f32 model evals measured finite to |x| ~ 300
        return NewtonOptions(reltol=1e-3, abstol=5e-7, res_tol=1e-3,
                             x_limit=100.0, jac_shunt=1e-7)
    return NewtonOptions()


# reset kinds in the continuation schedule
_KEEP, _FROM_X0, _FROM_ZERO, _FROM_RANDOM = 0, 1, 2, 3


def _schedule(opts: NewtonOptions):
    """Static continuation schedule: (gshunt, srcfac, reset, final)."""
    rows = [(0.0, 1.0, _FROM_X0, 1.0)]                       # plain attempt
    for g in np.logspace(np.log10(opts.gmin_start), -14.0, opts.gmin_steps):
        rows.append((g, 1.0, _KEEP, 0.0))                    # gmin ladder
    rows.append((0.0, 1.0, _KEEP, 1.0))                      # polish
    lams = np.linspace(0.1, 1.0, opts.src_steps)
    for i, lam in enumerate(lams):
        rows.append((0.0, lam, _FROM_ZERO if i == 0 else _KEEP, 0.0))
    rows.append((0.0, 1.0, _KEEP, 1.0))                      # polish
    for _ in range(opts.restarts):
        rows.append((0.0, 1.0, _FROM_RANDOM, 1.0))           # bootstraps
    a = np.asarray(rows)
    return a[:, 0], a[:, 1], a[:, 2].astype(np.int32), a[:, 3] > 0.5


def dc_core(compiled: CompiledCircuit, params, ctx: SimSpec, x0,
            opts: NewtonOptions, ic_mask=None, ic_vals=None):
    """Jit-traceable DC solve with continuation. vmap-safe."""
    dtype = compiled.dtype
    n = compiled.n_x
    nv = compiled.n_nodes + compiled.n_internal
    vmask = (jnp.arange(n) < nv).astype(dtype)
    # permanent gmin shunt on every voltage node (SPICE gmin semantics,
    # reference SimSpec.gmin /root/reference/src/simulate_ir.jl:12-20) —
    # keeps floating-node DC matrices nonsingular
    base_g = ctx.gmin

    from cedarsim_tpu.core.compile import use_sparse_solver
    use_sparse = use_sparse_solver(compiled)
    if use_sparse:
        from cedarsim_tpu.core.sparse_ops import get_sparse_ops
        sops = get_sparse_ops(compiled)
        lin_solve = sops.solve
    else:
        lin_solve = linalg.solve

    def res_jac(x, gshunt, srcfac):
        """(f, J) in one fused model walk — one subgraph instantiation and
        one model evaluation per Newton iteration instead of two.  J is a
        dense matrix or a sparse value vector depending on the circuit's
        solver mode; both assemble with the same expressions."""
        c = ctx.replace(sourcefac=ctx.sourcefac * srcfac)
        if use_sparse:
            S, _, Gv, _ = sops.res_jacs_sparse(x, c, params)
            f = S + (gshunt + base_g) * vmask * x
            J = sops.add_diag(Gv, gshunt + base_g + opts.jac_shunt)
            if ic_mask is not None:
                f = f * (1.0 - ic_mask) + ic_mask * (x - ic_vals)
                J = sops.add_a_diag(sops.mask_rows(J, 1.0 - ic_mask),
                                    ic_mask)
            return f, J
        S, _, G, _ = compiled.res_jacs_fwd(x, c, params)
        f = S + (gshunt + base_g) * vmask * x
        J = G + jnp.diag((gshunt + base_g + opts.jac_shunt) * vmask)
        if ic_mask is not None:
            f = f * (1.0 - ic_mask) + ic_mask * (x - ic_vals)
            J = J * (1.0 - ic_mask)[:, None] + jnp.diag(ic_mask)
        return f, J

    def newton(x_init, gshunt, srcfac):
        f0, J0 = res_jac(x_init, gshunt, srcfac)

        def body(carry):
            x, f, J, _, it = carry
            dx = lin_solve(J, -f)
            bad = jnp.logical_not(jnp.all(jnp.isfinite(dx)))
            dx = jnp.where(bad, jnp.zeros_like(dx), dx)
            mx = jnp.max(jnp.abs(dx))
            dx = dx * jnp.where(mx > opts.max_step, opts.max_step / mx, 1.0)
            xn = jnp.clip(x + dx, -opts.x_limit, opts.x_limit)
            fn, Jn = res_jac(xn, gshunt, srcfac)
            done = jnp.logical_and(
                jnp.all(jnp.abs(dx) <= opts.reltol * jnp.abs(xn)
                        + opts.abstol),
                jnp.logical_and(jnp.all(jnp.abs(fn) <= opts.res_tol),
                                jnp.logical_not(bad)))
            return xn, fn, Jn, done, it + 1

        def cond(carry):
            _, _, _, done, it = carry
            return jnp.logical_and(jnp.logical_not(done), it < opts.max_iter)

        x, f, _, done, it = jax.lax.while_loop(
            cond, body, (x_init, f0, J0, jnp.asarray(False),
                         jnp.asarray(0, jnp.int32)))
        ok = jnp.logical_and(done, jnp.all(jnp.isfinite(x)))
        return x, ok, it, jnp.max(jnp.abs(f))

    g_s, lam_s, reset_s, final_s = _schedule(opts)
    keys = jax.random.split(jax.random.PRNGKey(1234), len(g_s))

    def rung(carry, sched):
        x, best_x, best_ok, best_fn, iters = carry
        g, lam, reset, final, key = sched

        def run(args):
            x, iters = args
            xr = jax.random.normal(key, x.shape, dtype) * 1e-7
            x_init = jax.lax.switch(
                reset, [lambda: x, lambda: x0, lambda: jnp.zeros_like(x),
                        lambda: xr])
            xn, ok, it, fn = newton(x_init, jnp.asarray(g, dtype),
                                    jnp.asarray(lam, dtype))
            # never carry a diverged iterate into the next rung — a non-
            # finite / runaway x wedges every later rung (the model can't
            # evaluate there, especially with f32 evals)
            sane = jnp.logical_and(jnp.all(jnp.isfinite(xn)),
                                   jnp.max(jnp.abs(xn)) < opts.x_limit)
            xn = jnp.where(jnp.logical_or(ok, sane), xn, x_init)
            return xn, ok, it, fn

        def skip(args):
            x, iters = args
            return x, jnp.asarray(False), jnp.asarray(0, jnp.int32), \
                jnp.asarray(jnp.inf, dtype)

        xn, ok, it, fn = jax.lax.cond(best_ok, skip, run, (x, iters))
        win = jnp.logical_and(final, jnp.logical_and(ok,
                                                     jnp.logical_not(best_ok)))
        best_x = jnp.where(win, xn, best_x)
        best_fn = jnp.where(win, fn, best_fn)
        best_ok = jnp.logical_or(best_ok, win)
        return (xn, best_x, best_ok, best_fn, iters + it), None

    init = (x0, x0, jnp.asarray(False), jnp.asarray(jnp.inf, dtype),
            jnp.asarray(0, jnp.int32))
    (x_last, best_x, best_ok, best_fn, iters), _ = jax.lax.scan(
        rung, init, (jnp.asarray(g_s, dtype), jnp.asarray(lam_s, dtype),
                     jnp.asarray(reset_s), jnp.asarray(final_s), keys))
    x_out = jnp.where(best_ok, best_x, x_last)
    return DCResult(x_out, best_ok, iters, best_fn)


def ic_arrays(compiled: CompiledCircuit):
    """(mask, vals) arrays for the circuit's ``.ic`` pins (zeros if none)."""
    mask = np.zeros(compiled.n_x)
    vals = np.zeros(compiled.n_x)
    for name, v in compiled.circuit.ics.items():
        net = compiled.circuit._nets[name]
        if not net.is_ground:
            mask[net.index] = 1.0
            vals[net.index] = v
    return (jnp.asarray(mask, compiled.dtype),
            jnp.asarray(vals, compiled.dtype))


def solve_dc(compiled: CompiledCircuit, params=None, ctx: SimSpec = None,
             x0=None, opts: NewtonOptions = None, mode=Modes.DCOP,
             use_ics=None, artifact_cache=True) -> DCResult:
    """Solve the DC operating point.  ``params`` is the (possibly overridden /
    vmapped) parameter pytree; defaults to the compiled nominal values.

    ``use_ics``: pin ``.ic``'d nodes during the solve (default: only for the
    transient operating point, SPICE ``.ic`` semantics).

    ``artifact_cache``: consult the netlist-keyed artifact cache
    (utils/artifacts.py) for a warm-start x0 and store the converged point —
    a cache hit converges on the plain-attempt rung instead of walking the
    continuation ladder.  Skipped automatically for traced/batched inputs
    and when ``x0`` is given."""
    opts = opts or default_newton_options(compiled)
    params = compiled.params0 if params is None else params
    if ctx is None:
        from cedarsim_tpu.core.compile import default_ctx
        ctx = default_ctx(compiled).with_mode(mode)
    else:
        ctx = ctx.with_mode(mode)
    if use_ics is None:
        use_ics = mode == Modes.TRANOP
    use_ics = use_ics and bool(compiled.circuit.ics)
    mask, vals = ic_arrays(compiled)
    if not use_ics:
        mask = jnp.zeros_like(mask)
    akey = None
    if x0 is None:
        x0 = jnp.zeros(compiled.n_x, compiled.dtype)
        # .nodeset initial guesses (guess only, not pinned)
        for name, v in compiled.circuit.nodesets.items():
            net = compiled.circuit._nets.get(name)
            if net is not None and not net.is_ground:
                x0 = x0.at[net.index].set(v)
        x0 = jnp.where(mask > 0, vals, x0)
        if artifact_cache:
            from cedarsim_tpu.utils import artifacts
            akey = artifacts.op_key(compiled, params, ctx, mode)
            warm = artifacts.load_op(akey)
            if warm is not None and warm.shape == (compiled.n_x,):
                x0 = jnp.asarray(warm, compiled.dtype)
    fn = _get_dc_jit(compiled, opts)
    res = fn(params, ctx, x0, mask, vals)
    if akey is not None and not isinstance(res.x, jax.core.Tracer):
        from cedarsim_tpu.utils import artifacts
        if bool(np.all(np.asarray(res.converged))):
            artifacts.store_op(akey, res.x)
    if not isinstance(res.x, jax.core.Tracer):
        res._obs = (compiled, ctx, params, _UNBATCHED)
    return res


def _get_dc_jit(compiled: CompiledCircuit, opts: NewtonOptions):
    cache = compiled.__dict__.setdefault("_dc_jit_cache", {})
    if opts not in cache:
        cache[opts] = jax.jit(
            lambda params, ctx, x0, m, v: dc_core(
                compiled, params, ctx, x0, opts, m, v))
    return cache[opts]

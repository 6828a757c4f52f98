"""Device-mesh execution of batched sweeps.

The reference's sweep execution is a serial host loop over ``remake``d
problems (/root/reference/src/sweeps.jl:471-502).  Here a sweep is a stacked
parameter pytree (leading batch axis); this module shards that axis over a
``jax.sharding.Mesh`` so each chip Newton-solves its slice of the sweep
concurrently — per-point solves are embarrassingly parallel, so the only
collective is the result gather (SURVEY.md §2.11).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cedarsim_tpu.core.compile import CompiledCircuit
from cedarsim_tpu.core.context import SimSpec, Modes
from cedarsim_tpu.analysis.dc import dc_core, NewtonOptions, DCResult
from cedarsim_tpu.analysis.sweeps import batch_params


def make_mesh(n_devices=None, axis="batch") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def pad_batch(tree, multiple: int):
    """Pad every leaf's leading axis up to a multiple (sharding needs equal
    shards); returns (padded_tree, original_n)."""
    n = jax.tree.leaves(tree)[0].shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return tree, n
    def _pad(x):
        return jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)], axis=0)
    return jax.tree.map(_pad, tree), n


def dc_sweep_sharded(compiled: CompiledCircuit, sweep, mesh: Mesh = None,
                     params=None, ctx: SimSpec = None,
                     opts: NewtonOptions = None, mode=Modes.DCOP) -> DCResult:
    """Batched DC sweep sharded across the mesh's batch axis."""
    from cedarsim_tpu.analysis.dc import default_newton_options
    opts = opts or default_newton_options(compiled)
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    if ctx is None:
        from cedarsim_tpu.core.compile import default_ctx
        ctx = default_ctx(compiled).with_mode(mode)
    else:
        ctx = ctx.with_mode(mode)
    compiled, bp, _ = batch_params(compiled, sweep, params)
    bp, n = pad_batch(bp, mesh.size)
    npad = jax.tree.leaves(bp)[0].shape[0]
    x0 = jnp.zeros((npad, compiled.n_x), compiled.dtype)

    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    bp = jax.tree.map(lambda a: jax.device_put(a, shard), bp)
    x0 = jax.device_put(x0, shard)

    fn = _get_sharded_jit(compiled, opts, mesh)
    res = fn(bp, jax.tree.map(lambda a: jax.device_put(a, repl), ctx), x0)
    return DCResult(res.x[:n], res.converged[:n], res.iters[:n],
                    res.resnorm[:n])


def _get_sharded_jit(compiled, opts, mesh):
    cache = compiled.__dict__.setdefault("_dcsweep_shard_cache", {})
    key = (opts, id(mesh))
    if key not in cache:
        f = jax.vmap(lambda p, c, x: dc_core(compiled, p, c, x, opts),
                     in_axes=(0, None, 0))
        cache[key] = jax.jit(f)
    return cache[key]


@partial(jax.tree_util.register_dataclass,
         data_fields=["ts", "xs", "xdots", "finished", "n_accepted",
                      "n_rejected", "n_newton"], meta_fields=[])
@dataclasses.dataclass
class TranSweepResult:
    """Batched transient sweep output: leading axis = sweep point.

    ``ts``/``xs``/``xdots`` are the raw fixed-size chunk buffers from
    ``tran_core`` (padded rows repeat the final state, so ``np.interp``
    against ``ts[lane]`` stays monotone); per-lane valid step counts are
    ``n_accepted``."""
    ts: jax.Array          # [n, steps+1]
    xs: jax.Array          # [n, steps+1, n_x]
    xdots: jax.Array       # [n, steps+1, n_x]
    finished: jax.Array    # [n] bool
    n_accepted: jax.Array  # [n]
    n_rejected: jax.Array  # [n]
    n_newton: jax.Array    # [n]


def tran_sweep_sharded(compiled: CompiledCircuit, sweep, tspan,
                       mesh: Mesh = None, params=None, ctx: SimSpec = None,
                       opts=None, dc_opts: NewtonOptions = None,
                       x0=None) -> TranSweepResult:
    """Batched transient sweep sharded across the mesh's batch axis: the
    per-lane DC operating points and the full adaptive time loops run as ONE
    sharded XLA program each — the multi-chip version of the reference's
    serial ``tran!.(CircuitSweep(...))`` broadcast
    (/root/reference/src/sweeps.jl:471-502).

    Swept parameters must not move source breakpoint times (the breakpoint
    schedule is static, computed from the elaborated nominal values).

    ``sweep=None`` accepts a prebuilt batched parameter pytree via
    ``params`` (every leaf with a leading points axis — e.g. a custom PVT
    grid assembled with ``set_param``) instead of a sweep object.

    ``x0``: warm-start guess for the per-lane operating points — usually
    the NOMINAL op (``solve_dc(compiled).x``).  Strongly recommended for
    metastable-bias circuits (latches/flops): the cold continuation ladder
    from zeros is genuinely fragile at some sweep points (the reference's
    initialization-fragility probe documents this), while a few Newton
    steps from the nominal op converge across the whole perturbation
    range."""
    from cedarsim_tpu.analysis.tran import TranOptions, tran_core
    from cedarsim_tpu.analysis.dc import default_newton_options
    from cedarsim_tpu.core.context import Modes as M

    opts = opts or TranOptions()
    dc_opts = dc_opts or default_newton_options(compiled)
    mesh = mesh or make_mesh()
    axis = mesh.axis_names[0]
    if ctx is None:
        from cedarsim_tpu.core.compile import default_ctx
        ctx = default_ctx(compiled)
    t0, tstop = float(tspan[0]), float(tspan[1])
    span = tstop - t0

    if sweep is None:
        if params is None:
            raise ValueError("sweep=None needs a prebuilt batched params "
                             "tree via params=")
        bp = params
    else:
        compiled, bp, _ = batch_params(compiled, sweep, params)
    bp, n = pad_batch(bp, mesh.size)
    npad = jax.tree.leaves(bp)[0].shape[0]

    bps = compiled.breakpoints(tstop)
    bps = np.concatenate([bps[bps > t0], [tstop], [np.inf]])
    h0 = opts.h0 if opts.h0 is not None else span * 1e-6
    if len(bps) > 2:
        h0 = min(h0, max(float(bps[0] - t0) * 0.1, span * 1e-9))

    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    bp = jax.tree.map(lambda a: jax.device_put(a, shard), bp)
    ctx_r = jax.tree.map(lambda a: jax.device_put(a, repl), ctx)
    if x0 is None:
        x0b = jnp.zeros((npad, compiled.n_x), compiled.dtype)
    else:
        x0 = jnp.asarray(x0, compiled.dtype)
        if x0.ndim == 1:
            x0b = jnp.broadcast_to(x0, (npad, compiled.n_x))
        else:
            x0b, _ = pad_batch(x0, mesh.size)
    x0 = jax.device_put(x0b, shard)

    d = compiled.dtype
    cache = compiled.__dict__.setdefault("_transweep_shard_cache", {})
    # t0/tstop/h0 are traced arguments (same discipline as tran's
    # _get_tran_jit), so a cache hit can never replay a program compiled
    # for a different span; the program doesn't depend on the mesh (jax.jit
    # re-lowers per input sharding), so the mesh stays out of the key
    key = (opts, dc_opts, len(bps))
    if key not in cache:
        def lane(p, c, x0_l, bps_l, t0_, tstop_, h0_):
            op = dc_core(compiled, p, c.with_mode(M.TRANOP), x0_l, dc_opts)
            ctx_t = c.with_mode(M.TRAN)
            # consistent ẋ0 AND the differential-variable LTE mask from ONE
            # model walk at the operating point
            from cedarsim_tpu.analysis.tran import xdot0_and_mask_impl
            xd0, mask = xdot0_and_mask_impl(compiled, op.x, ctx_t, p)
            out = tran_core(compiled, p, c, op.x, xd0, t0_, tstop_,
                            bps_l, h0_, opts, mask)
            ts, xs, xd, k, fin, nrej, nnwt, _ = out
            return (ts, xs, xd, k,
                    jnp.logical_and(fin, op.converged), nrej, nnwt)
        cache[key] = jax.jit(jax.vmap(
            lane, in_axes=(0, None, 0, None, None, None, None)))
    ts, xs, xd, k, fin, nrej, nnwt = cache[key](
        bp, ctx_r, x0, jnp.asarray(bps, d), jnp.asarray(t0, d),
        jnp.asarray(tstop, d), jnp.asarray(h0, d))
    return TranSweepResult(ts[:n], xs[:n], xd[:n], fin[:n], k[:n],
                           nrej[:n], nnwt[:n])

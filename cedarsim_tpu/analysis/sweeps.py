"""Sweep combinators and batched execution.

Iterator semantics mirror the reference (/root/reference/src/sweeps.jl:40-354,
test/sweep.jl): ``Sweep`` is one parameter × value list; ``ProductSweep`` is
the cartesian product; ``TandemSweep`` zips; ``SerialSweep`` concatenates
(missing params fall back to defaults, the reference's ``nothing`` fill).

Execution is where this build departs: instead of the reference's serial
``remake`` broadcast loop (sweeps.jl:471-502 — compiled once, solved one at a
time), the sweep points are stacked into a batched parameter pytree and the
whole batch solves as ONE ``vmap``-ed XLA program, optionally sharded over a
device mesh (see cedarsim_tpu.parallel.mesh).
"""

from __future__ import annotations

import itertools

import numpy as np
import jax
import jax.numpy as jnp

from cedarsim_tpu.core.compile import CompiledCircuit
from cedarsim_tpu.core.context import SimSpec, Modes
from cedarsim_tpu.analysis.dc import dc_core, NewtonOptions, DCResult


class AbstractSweep:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    @property
    def names(self):
        raise NotImplementedError


class Sweep(AbstractSweep):
    def __init__(self, name, values):
        self.name = name
        self.values = list(values)

    def __iter__(self):
        for v in self.values:
            yield {self.name: v}

    def __len__(self):
        return len(self.values)

    @property
    def names(self):
        return [self.name]


class ProductSweep(AbstractSweep):
    def __init__(self, *sweeps):
        self.sweeps = [sweepify(s) for s in sweeps]

    def __iter__(self):
        for combo in itertools.product(*self.sweeps):
            d = {}
            for c in combo:
                d.update(c)
            yield d

    def __len__(self):
        n = 1
        for s in self.sweeps:
            n *= len(s)
        return n

    @property
    def names(self):
        return [n for s in self.sweeps for n in s.names]


class TandemSweep(AbstractSweep):
    def __init__(self, *sweeps):
        self.sweeps = [sweepify(s) for s in sweeps]
        lens = {len(s) for s in self.sweeps}
        if len(lens) != 1:
            raise ValueError("TandemSweep requires equal-length sweeps")

    def __iter__(self):
        for combo in zip(*self.sweeps):
            d = {}
            for c in combo:
                d.update(c)
            yield d

    def __len__(self):
        return len(self.sweeps[0])

    @property
    def names(self):
        return [n for s in self.sweeps for n in s.names]


class SerialSweep(AbstractSweep):
    def __init__(self, *sweeps):
        self.sweeps = [sweepify(s) for s in sweeps]

    def __iter__(self):
        for s in self.sweeps:
            yield from s

    def __len__(self):
        return sum(len(s) for s in self.sweeps)

    @property
    def names(self):
        seen = []
        for s in self.sweeps:
            for n in s.names:
                if n not in seen:
                    seen.append(n)
        return seen


def sweepify(obj):
    """Shorthand coercion (reference ``sweepify``, sweeps.jl:349-354):
    dict of name→values → ProductSweep of Sweeps; (name, values) tuple →
    Sweep; AbstractSweep passes through."""
    if isinstance(obj, AbstractSweep):
        return obj
    if isinstance(obj, dict):
        return ProductSweep(*[Sweep(k, v) for k, v in obj.items()])
    if isinstance(obj, tuple) and len(obj) == 2:
        return Sweep(obj[0], obj[1])
    raise TypeError(f"cannot sweepify {obj!r}")


# ------------------------------------------------------------------ batching

def batch_params(compiled: CompiledCircuit, sweep, params=None):
    """Stack a sweep into a batched parameter pytree: every leaf gains a
    leading axis of len(sweep).  Returns (compiled, batched_params, points) —
    ``compiled`` may be a recompiled variant with the swept params dynamic.
    The reserved name "temp" is skipped (it batches the SimSpec, not the
    device params — see dc_sweep)."""
    from cedarsim_tpu.core.compile import ensure_dynamic
    sweep = sweepify(sweep)
    compiled = ensure_dynamic(
        compiled, [n for n in sweep.names if n.lower() != "temp"])
    base = compiled.params0 if params is None else params
    points = list(sweep)
    trees = []
    for pt in points:
        p = base
        for name, v in pt.items():
            if v is None or name.lower() == "temp":
                continue
            p = compiled.set_param(p, name, v)
        trees.append(p)
    batched = jax.tree.map(lambda *leaves: jnp.stack(leaves), *trees)
    return compiled, batched, points


def dc_sweep(compiled: CompiledCircuit, sweep, params=None,
             ctx: SimSpec = None, opts: NewtonOptions = None,
             mode=Modes.DCOP) -> DCResult:
    """Batched DC sweep: all points solve concurrently in one vmapped XLA
    program (the reference's ``dc!.(CircuitSweep(...))`` made parallel).
    The reserved sweep name "temp" sweeps temperature (Celsius) by batching
    the SimSpec — the T axis of PVT."""
    import dataclasses as _dc
    from cedarsim_tpu import config as _config
    from cedarsim_tpu.analysis.dc import default_newton_options
    opts = opts or default_newton_options(compiled)
    if ctx is None:
        from cedarsim_tpu.core.compile import default_ctx
        ctx = default_ctx(compiled).with_mode(mode)
    else:
        ctx = ctx.with_mode(mode)
    compiled, bp, points = batch_params(compiled, sweep, params)
    n_pts = len(points)
    x0 = jnp.zeros((n_pts, compiled.n_x), compiled.dtype)

    has_temp = any("temp" in (k.lower() for k in pt) for pt in points)
    if has_temp:
        temps = jnp.asarray(
            [next((v for k, v in pt.items() if k.lower() == "temp"),
                  float(ctx.temp) - _config.T_ZERO_C) + _config.T_ZERO_C
             for pt in points], compiled.dtype)
        ctx = ctx.replace(temp=temps)
    fn = _get_sweep_jit(compiled, opts, has_temp)
    res = fn(bp, ctx, x0)
    if not isinstance(res.x, jax.core.Tracer):
        res._obs = (compiled, ctx, bp, _ctx_axes(has_temp, ctx.mode))
    return res


def _ctx_axes(temp_batched, mode):
    return SimSpec(time=None, temp=0 if temp_batched else None, gmin=None,
                   scale=None, sourcefac=None, mc_key=None, mode=mode)


def _get_sweep_jit(compiled, opts, temp_batched=False):
    cache = compiled.__dict__.setdefault("_dcsweep_jit_cache", {})
    key = (opts, temp_batched)
    if key not in cache:
        def f(p, c, x):
            return dc_core(compiled, p, c, x, opts)
        def wrapped(bp, ctx, x0):
            axes = _ctx_axes(temp_batched, ctx.mode)
            return jax.vmap(f, in_axes=(0, axes, 0))(bp, ctx, x0)
        cache[key] = jax.jit(wrapped)
    return cache[key]


def split_axes(sweep, outer_names):
    """Split a sweep into (outer, inner) sweeps by parameter name — the
    reference's split for host-level outer loops vs batched inner sweeps
    (/root/reference/src/sweeps.jl:80-128).  Returns (outer, inner) where
    either may be None if it would be empty."""
    sweep = sweepify(sweep)
    outer_names = {n.lower() for n in outer_names}

    def collect(s):
        if isinstance(s, Sweep):
            return [s]
        if not isinstance(s, ProductSweep):
            # Splitting a zip (Tandem) or concat (Serial) by axis would
            # silently turn it into a cartesian product — the reference's
            # split only accepts products (sweeps.jl:98-105).
            raise ValueError(
                f"split_axes requires a ProductSweep of plain Sweeps, "
                f"got {type(s).__name__}")
        return [x for sub in s.sweeps for x in collect(sub)]

    leaves = collect(sweep)
    outer = [s for s in leaves if s.name.lower() in outer_names]
    inner = [s for s in leaves if s.name.lower() not in outer_names]
    mk = lambda ls: (None if not ls
                     else ls[0] if len(ls) == 1 else ProductSweep(*ls))
    return mk(outer), mk(inner)


def data_sweep(circuit, name=None):
    """TandemSweep over a netlist .data block's rows (reference DataStatement,
    SPICE/parse/forms.jl). Parameter columns address netlist .param names —
    use with re-elaboration (simulate(..., params=point))."""
    for cmd, args, kw in circuit.directives:
        if cmd == "data" and (name is None or args[0].lower() == str(name).lower()):
            _, cols, rows = args
            return TandemSweep(*[
                Sweep(c, [r[i] for r in rows]) for i, c in enumerate(cols)])
    raise KeyError(f".data block {name!r} not found")


def find_param_ranges(sweep):
    """{parameter name: (min, max, count)} over every leaf Sweep — the
    reference's sweep summary (/root/reference/src/sweeps.jl:507-546)."""
    sweep = sweepify(sweep)
    out = {}

    def walk(s):
        if isinstance(s, Sweep):
            vals = list(s.values)
            key = s.name
            if key in out:
                lo, hi, n = out[key]
                out[key] = (min(lo, min(vals)), max(hi, max(vals)),
                            n + len(vals))
            else:
                out[key] = (min(vals), max(vals), len(vals))
            return
        for sub in s.sweeps:
            walk(sub)

    walk(sweep)
    return out

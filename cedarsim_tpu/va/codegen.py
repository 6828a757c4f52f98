"""Verilog-A → JAX device compiler.

The reference emits a Julia ``@kwdef`` struct + functor per VA module
(/root/reference/src/vasim.jl:663-875).  Here the analog block is interpreted
*at trace time* into pure JAX: the result of ``make_device`` is a
``DeviceModel`` subclass whose ``eval`` walks the VA AST with an environment
of traced values, so every instance of the model evaluates vectorized
(vmapped) like the built-in devices.

Key semantics (reference cites):
- contributions ``I(a,b) <+ expr`` accumulate (resistive, ddt-charge) pairs;
  ``V(a,b) <+`` allocates a branch-current unknown with constraint
  V(a,b) − expr = 0 (vasim.jl:128-180).  Mixed I/V ("switch") branches are
  supported, including runtime-switched ones: the branch always carries a
  current unknown and the residual selects the V-constraint or I-relation
  per evaluation (see ``switch_branches`` collection below and
  tests/test_va.py's switch-branch cases) — the static
  resolution vasim.jl's per-branch state machine does at codegen time,
  generalized to a ``jnp.where`` select so a condition on bias works.
- ddt() splits expressions into (static, dynamic) parts; linear combinations
  only (charge-based compact models satisfy this).
- conditionals with traced conditions evaluate both branches and
  ``jnp.where``-merge every assigned variable and contribution accumulator
  (replaces DAECompiler's IR-level handling).
- ``$param_given`` → per-instance given-masks (vasim.jl:339-343);
  ``$temperature``/``$vt`` from SimSpec (va_env.jl:123); analog functions
  with output args return (ret, outs...) (vasim.jl:503-569);
  white_noise/flicker_noise become eps-column sources with operating-point
  PSD expressions (va_env.jl:82-90).
- parameter defaults may reference other parameters — evaluated per instance
  at prepare() time; SPICE's case-insensitive netlists map onto VA's
  case-sensitive names via a lowercase alias table (the reference's
  case_adjust_kwargs, spectre.jl:1113-1149).
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from cedarsim_tpu.core.context import Modes
from cedarsim_tpu.devices.base import DeviceModel
from cedarsim_tpu.va.ast import Module, AnalogFunction
from cedarsim_tpu.va.parser import parse_va


class VACodegenError(ValueError):
    pass


# ------------------------------------------------- (s, q, d) value channels
# Every interpreter value is (static, charge, dtangents):
#   static  — the resistive value
#   charge  — coefficient of ddt() (None = zero)
#   dtangents — dict probe-node-name -> d(static)/dV(probe), for ddx()
#               (None = no dependence).  Mirrors the reference's ForwardDiff
#               duals with a dedicated SimTag (/root/reference/src/vasim.jl:
#               29-35,337-412); contributions drop the tangent channel
#               (vasim.jl:649-661).

def _flatten_muldiv(e, num, den):
    """Flatten a */ expression tree into numerator/denominator factor lists
    (AST nodes, unevaluated)."""
    if isinstance(e, tuple) and e[0] == "bin" and e[1] == "*":
        _flatten_muldiv(e[2], num, den)
        _flatten_muldiv(e[3], num, den)
    elif isinstance(e, tuple) and e[0] == "bin" and e[1] == "/":
        _flatten_muldiv(e[2], num, den)
        _flatten_muldiv(e[3], den, num)
    else:
        num.append(e)


def _pair(v):
    if isinstance(v, tuple):
        if len(v) == 2:
            return (v[0], v[1], None)
        return v
    return (v, None, None)


def _dmerge(da, db, f):
    if da is None and db is None:
        return None
    keys = set(da or ()) | set(db or ())
    return {k: f((da or {}).get(k, 0.0), (db or {}).get(k, 0.0))
            for k in keys}


def _dscale(d, c):
    if d is None:
        return None
    return {k: v * c for k, v in d.items()}


def _padd(a, b):
    a, b = _pair(a), _pair(b)
    q = a[1] if b[1] is None else (b[1] if a[1] is None else a[1] + b[1])
    return (a[0] + b[0], q, _dmerge(a[2], b[2], lambda x, y: x + y))


def _psub(a, b):
    a, b = _pair(a), _pair(b)
    if b[1] is None:
        q = a[1]
    elif a[1] is None:
        q = -b[1]
    else:
        q = a[1] - b[1]
    return (a[0] - b[0], q, _dmerge(a[2], b[2], lambda x, y: x - y))


def _pneg(a):
    a = _pair(a)
    return (-a[0], None if a[1] is None else -a[1], _dscale(a[2], -1.0))


def _pmul(a, b):
    a, b = _pair(a), _pair(b)
    if a[1] is not None and b[1] is not None:
        raise VACodegenError("product of two ddt() expressions is not a "
                             "valid charge formulation")
    if a[1] is not None:
        q = a[1] * b[0]
    elif b[1] is not None:
        q = b[1] * a[0]
    else:
        q = None
    d = _dmerge(_dscale(a[2], b[0]), _dscale(b[2], a[0]),
                lambda x, y: x + y)
    return (a[0] * b[0], q, d)


def _pdiv(a, b):
    a, b = _pair(a), _pair(b)
    if b[1] is not None:
        raise VACodegenError("division by a ddt() expression")
    q = None if a[1] is None else a[1] / b[0]
    # d(a/b) = da/b - a db/b^2
    d = _dmerge(_dscale(a[2], 1.0 / b[0]),
                _dscale(b[2], -a[0] / (b[0] * b[0])), lambda x, y: x + y)
    return (a[0] / b[0], q, d)


def _scalar(a, what="expression"):
    a = _pair(a)
    if a[1] is not None:
        raise VACodegenError(f"ddt() result used inside nonlinear {what}")
    return a[0]


def _dual(a):
    """(value, dtangents) view of a value."""
    a = _pair(a)
    return a[0], a[2]


def _limexp_cap(x):
    # f32 evals: e^80 = 5.5e34, so the linear tail e^80·(1+x−80) overflows
    # f32 (max 3.4e38) once x ≳ 6000 — reachable by wandering continuation
    # iterates inside x_limit.  Cap lower so the tail stays finite across
    # the whole clipped iterate range.
    return 55.0 if jnp.result_type(x) == jnp.float32 else 80.0


def _limexp(x, lim=None):
    lim = _limexp_cap(x) if lim is None else lim
    xe = jnp.exp(jnp.minimum(x, lim))
    return jnp.where(x <= lim, xe, jnp.exp(lim) * (1.0 + (x - lim)))


# NaN-safe derivatives for the VA math set — compact models routinely hit
# pow(0, m), sqrt(0), ln(0) at region boundaries, where the *value* is fine
# but the default derivative is inf/NaN and kills Newton.  Same fix as the
# reference's NaNMath custom frules (/root/reference/src/va_env.jl:35-75).
import jax as _jax


@_jax.custom_jvp
def _safe_pow(a, b):
    return jnp.power(a, b)


@_safe_pow.defjvp
def _safe_pow_jvp(primals, tangents):
    a, b = primals
    da, db = tangents
    y = jnp.power(a, b)
    # d/da: b·a^(b−1), zeroed where a == 0 (0^m boundary)
    ga = jnp.where(a != 0, b * jnp.power(jnp.where(a != 0, a, 1.0), b - 1.0),
                   0.0)
    # d/db: ln(a)·a^b, zeroed where a <= 0
    gb = jnp.where(a > 0, jnp.log(jnp.where(a > 0, a, 1.0)) * y, 0.0)
    return y, ga * da + gb * db


@_jax.custom_jvp
def _safe_sqrt(a):
    return jnp.sqrt(a)


@_safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (a,), (da,) = primals, tangents
    y = jnp.sqrt(a)
    g = jnp.where(a > 0, 0.5 / jnp.where(a > 0, y, 1.0), 0.0)
    return y, g * da


@_jax.custom_jvp
def _safe_log(a):
    return jnp.log(a)


@_safe_log.defjvp
def _safe_log_jvp(primals, tangents):
    (a,), (da,) = primals, tangents
    g = jnp.where(a > 0, 1.0 / jnp.where(a > 0, a, 1.0), 0.0)
    return jnp.log(a), g * da


def _safe_log10(a):
    return _safe_log(a) * (1.0 / math.log(10.0))


def _concrete(*vs):
    """True if none of the values is a *traced* value — concrete Python/numpy
    scalars (and committed jax scalars) stay concrete through the interpreter
    so parameter-only computation folds at trace time on the HOST in real
    f64 (the const-prop the reference gets from the Julia compiler,
    /root/reference/test/compiler_sanity.jl).  Host folding matters beyond
    speed: it keeps eager device round trips out of tracing, and the folded
    values are exact host f64 whatever the model's eval dtype."""
    from jax.core import Tracer
    return not any(isinstance(v, Tracer) for v in vs)


def _ieee(pyf, npf):
    """IEEE-semantics host fold: out-of-domain/overflow give inf/nan like the
    traced jnp path instead of raising (math.exp(1000) raises, np gives inf)."""
    def g(*a):
        try:
            return pyf(*a)
        except (OverflowError, ZeroDivisionError, ValueError):
            with np.errstate(all="ignore"):
                return float(npf(*map(np.float64, a)))
    return g


_HOST_MATH1 = {
    "exp": _ieee(math.exp, np.exp), "ln": _ieee(math.log, np.log),
    "log": _ieee(math.log10, np.log10), "log10": _ieee(math.log10, np.log10),
    "sqrt": _ieee(math.sqrt, np.sqrt), "abs": abs,
    "limexp": lambda x: math.exp(x) if x <= 80 else math.exp(80.0)*(1+x-80),
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": _ieee(math.asin, np.arcsin), "acos": _ieee(math.acos, np.arccos),
    "atan": math.atan,
    "sinh": _ieee(math.sinh, np.sinh), "cosh": _ieee(math.cosh, np.cosh),
    "tanh": math.tanh,
    "asinh": math.asinh, "acosh": _ieee(math.acosh, np.arccosh),
    "atanh": _ieee(math.atanh, np.arctanh),
    "floor": math.floor, "ceil": math.ceil,
}
_HOST_MATH2 = {
    # math.pow (not **): neg**frac raises (→ np nan) instead of going complex
    "pow": _ieee(math.pow, np.power), "min": min, "max": max,
    "atan2": math.atan2, "hypot": math.hypot,
    "fmod": _ieee(math.fmod, np.fmod),
}

_MATH1 = {
    "exp": jnp.exp, "ln": _safe_log, "log": _safe_log10,
    "log10": _safe_log10,
    "sqrt": _safe_sqrt, "abs": jnp.abs, "limexp": _limexp,
    "sin": jnp.sin, "cos": jnp.cos, "tan": jnp.tan,
    "asin": jnp.arcsin, "acos": jnp.arccos, "atan": jnp.arctan,
    "sinh": jnp.sinh, "cosh": jnp.cosh, "tanh": jnp.tanh,
    "asinh": jnp.arcsinh, "acosh": jnp.arccosh, "atanh": jnp.arctanh,
    "floor": jnp.floor, "ceil": jnp.ceil,
}
_MATH2 = {
    "pow": _safe_pow,
    "min": jnp.minimum, "max": jnp.maximum,
    "atan2": jnp.arctan2, "hypot": jnp.hypot,
    "fmod": jnp.fmod,
}

#: f -> f' for the ddx tangent chain rule
_DMATH1 = {
    "exp": jnp.exp,
    "ln": lambda x: 1.0 / x,
    "log": lambda x: 1.0 / (x * math.log(10.0)),
    "log10": lambda x: 1.0 / (x * math.log(10.0)),
    "sqrt": lambda x: 0.5 / jnp.sqrt(jnp.maximum(x, 1e-300)),
    "abs": jnp.sign,
    "limexp": lambda x: jnp.where(
        x <= _limexp_cap(x), jnp.exp(jnp.minimum(x, _limexp_cap(x))),
        jnp.exp(_limexp_cap(x))),
    "sin": jnp.cos, "cos": lambda x: -jnp.sin(x),
    "tan": lambda x: 1.0 + jnp.tan(x) ** 2,
    "asin": lambda x: 1.0 / jnp.sqrt(jnp.maximum(1 - x * x, 1e-300)),
    "acos": lambda x: -1.0 / jnp.sqrt(jnp.maximum(1 - x * x, 1e-300)),
    "atan": lambda x: 1.0 / (1 + x * x),
    "sinh": jnp.cosh, "cosh": jnp.sinh,
    "tanh": lambda x: 1.0 - jnp.tanh(x) ** 2,
    "asinh": lambda x: 1.0 / jnp.sqrt(x * x + 1),
    "acosh": lambda x: 1.0 / jnp.sqrt(jnp.maximum(x * x - 1, 1e-300)),
    "atanh": lambda x: 1.0 / jnp.maximum(1 - x * x, 1e-300),
    "floor": lambda x: 0.0, "ceil": lambda x: 0.0,
}


# -------------------------------------------------------------- static prepass

def _walk_stmts(stmts):
    for st in stmts:
        yield st
        k = st[0]
        if k == "block":
            yield from _walk_stmts(st[1])
        elif k == "if":
            yield from _walk_stmts([st[2]])
            if st[3] is not None:
                yield from _walk_stmts([st[3]])
        elif k in ("for",):
            yield from _walk_stmts([st[4]])
        elif k in ("while", "repeat", "event"):
            yield from _walk_stmts([st[2]])
        elif k == "case":
            for _, s2 in st[2]:
                yield from _walk_stmts([s2])


def _walk_exprs(e, out):
    if not isinstance(e, tuple):
        return
    k = e[0]
    out.append(e)
    if k in ("bin",):
        _walk_exprs(e[2], out); _walk_exprs(e[3], out)
    elif k in ("un",):
        _walk_exprs(e[2], out)
    elif k == "cond":
        _walk_exprs(e[1], out); _walk_exprs(e[2], out); _walk_exprs(e[3], out)
    elif k == "call":
        for a in e[2]:
            _walk_exprs(a, out)
    elif k == "array":
        for a in e[1]:
            _walk_exprs(a, out)


def _all_exprs(module):
    out = []
    for st in _walk_stmts(module.analog):
        k = st[0]
        if k == "assign":
            _walk_exprs(st[2], out)
        elif k == "contrib":
            _walk_exprs(st[2], out)
        elif k == "if":
            _walk_exprs(st[1], out)
        elif k == "for":
            _walk_exprs(st[2], out)
        elif k in ("while", "repeat"):
            _walk_exprs(st[1], out)
        elif k == "case":
            _walk_exprs(st[1], out)
            for labels, _ in st[2]:
                if labels:
                    for l in labels:
                        _walk_exprs(l, out)
        elif k in ("sys", "call"):
            for a in st[2]:
                _walk_exprs(a, out)
    for fn in module.functions.values():
        for st in _walk_stmts(fn.body):
            if st[0] == "assign":
                _walk_exprs(st[2], out)
            elif st[0] == "if":
                _walk_exprs(st[1], out)
    return out


# ------------------------------------------------------------------ the device

#: analog filter / event operators lowered to extra device state rows
#: (LRM 4.5.13 laplace_*, 4.5.14 absdelay, 4.5.16 transition, 4.5.17 slew,
#: 4.5.10 idtmod).  Each site owns a block of state unknowns appended after
#: the idt rows; the call site computes every row's (static, dynamic) pair
#: and the output expression, so DC/AC/noise/transient all ride through the
#: ordinary MNA machinery with no operator-specific solver support.
_LF_OPS = frozenset(("laplace_nd", "laplace_np", "laplace_zd", "laplace_zp",
                     "absdelay", "transition", "slew", "idtmod"))

#: absdelay / delayed transition: order of the Padé(N,N) all-pass
#: approximation of e^{-s·td} (exact DC gain; group delay accurate to
#: ~|ω·td| ≲ 2N rad — the classic fallback of continuous-time solvers
#: without history interpolation)
_PADE_ORDER = 3


def _arr_elems(module, e, what):
    if not (isinstance(e, tuple) and e[0] == "array"):
        raise VACodegenError(
            f"module {module.name}: {what} must be an array literal "
            "{c0, c1, ...}")
    return e[1]


def _try_const(e, module):
    """Host-foldable constant value of an expression, else None."""
    try:
        return _const_expr(e, module)
    except Exception:
        return None


def _zi_coeff_counts(module, e):
    """Static (nb, na) — numbers of z^{-1}-ascending numerator/denominator
    coefficients after root-form normalization — for a zi_* site.  Only
    the COUNTS must be static; the values may be parameter expressions."""
    name, args = e[1], e[2]
    if len(args) < 4:
        raise VACodegenError(
            f"module {module.name}: {name}(expr, num, den, T[, tau[, t0]])")

    def arr_len(a, what):
        if not (isinstance(a, tuple) and a[0] in ("arr", "array")):
            raise VACodegenError(
                f"module {module.name}: {name}() {what} must be a "
                "{...} coefficient array")
        return len(a[1])

    if name in ("zi_nd", "zi_np"):
        nb = arr_len(args[1], "numerator")
    else:
        z = arr_len(args[1], "zeros")
        if z % 2:
            raise VACodegenError(
                f"module {module.name}: {name}() zeros must be (re, im) "
                "pairs")
        nb = z // 2 + 1
    if name in ("zi_nd", "zi_zd"):
        na = arr_len(args[2], "denominator")
    else:
        pz = arr_len(args[2], "poles")
        if pz % 2:
            raise VACodegenError(
                f"module {module.name}: {name}() poles must be (re, im) "
                "pairs")
        na = pz // 2 + 1
    if name in ("zi_zd", "zi_zp"):
        if nb > na:
            raise VACodegenError(
                f"module {module.name}: {name}() has more zeros than the "
                "denominator order")
        nb = na      # zero-root numerator is padded to the pole count
    if na < 1:
        raise VACodegenError(
            f"module {module.name}: {name}() needs a denominator")
    return nb, na


def _host_eval(e, module, params):
    """Host-side numeric value of a parameter expression (for the zi_*
    sample clock, which must be voltage-independent per the LRM)."""
    if isinstance(e, (int, float)):
        return float(e)
    if e[0] == "num":
        return float(e[1])
    if e[0] == "ref":
        if e[1] in params:
            return float(params[e[1]])
        return float(_const_expr(e, module))
    if e[0] == "un":
        v = _host_eval(e[2], module, params)
        return {"-": -v, "+": v}[e[1]]
    if e[0] == "bin":
        a = _host_eval(e[2], module, params)
        b = _host_eval(e[3], module, params)
        return {"+": a + b, "-": a - b, "*": a * b, "/": a / b,
                "**": a ** b}[e[1]]
    raise VACodegenError(
        f"module {module.name}: zi_* sample period/offset must be a "
        "constant or parameter expression")


def _lf_n_states(module, e):
    """Static state count for a filter/event operator site (the DAE row
    block size — must be known before tracing)."""
    name, args = e[1], e[2]
    if name in ("laplace_nd", "laplace_np", "laplace_zd", "laplace_zp"):
        if len(args) != 3:
            raise VACodegenError(
                f"module {module.name}: {name}() takes (expr, num, den)")
        if name in ("laplace_nd", "laplace_zd"):
            nd = len(_arr_elems(module, args[2],
                                f"{name}() denominator")) - 1
        else:
            pl = len(_arr_elems(module, args[2], f"{name}() poles"))
            if pl % 2:
                raise VACodegenError(
                    f"module {module.name}: {name}() poles must be "
                    "(re, im) pairs (conjugates listed explicitly, LRM)")
            nd = pl // 2
        if name in ("laplace_nd", "laplace_np"):
            dn = len(_arr_elems(module, args[1],
                                f"{name}() numerator")) - 1
        else:
            zl = len(_arr_elems(module, args[1], f"{name}() zeros"))
            if zl % 2:
                raise VACodegenError(
                    f"module {module.name}: {name}() zeros must be "
                    "(re, im) pairs")
            dn = zl // 2
        if nd < 1:
            raise VACodegenError(
                f"module {module.name}: {name}() needs at least one pole")
        if dn > nd:
            raise VACodegenError(
                f"module {module.name}: {name}() transfer function is "
                f"improper (numerator degree {dn} > denominator {nd})")
        return nd
    if name == "absdelay":
        if not 2 <= len(args) <= 3:
            raise VACodegenError(
                f"module {module.name}: absdelay(expr, td[, maxdelay])")
        return 0 if _try_const(args[1], module) == 0.0 else _PADE_ORDER
    if name == "transition":
        extra = 0
        if len(args) >= 2 and _try_const(args[1], module) != 0.0:
            extra = _PADE_ORDER
        return 1 + extra
    if name == "slew":
        # no rate bounds → identity, no state
        return 1 if len(args) >= 2 else 0
    if name == "idtmod":
        return 1
    raise VACodegenError(f"unknown filter operator {name}")


def _poly_from_pairs(roots):
    """Real polynomial coefficients (ascending powers of s) from a flat
    (re, im, re, im, ...) root list — conjugates listed explicitly per the
    LRM, so the product is real; the imaginary residue is dropped.  Values
    may be traced scalars (parameter-dependent poles are fine — only the
    COUNT is static)."""
    cr, ci = [1.0], [0.0]
    for j in range(0, len(roots), 2):
        a, b = roots[j], roots[j + 1]          # root = a + i·b
        nr = [0.0] * (len(cr) + 1)
        ni = [0.0] * (len(cr) + 1)
        for t in range(len(cr)):
            nr[t + 1] = nr[t + 1] + cr[t]      # s · c_t
            ni[t + 1] = ni[t + 1] + ci[t]
            nr[t] = nr[t] - (a * cr[t] - b * ci[t])   # −root · c_t
            ni[t] = ni[t] - (a * ci[t] + b * cr[t])
        cr, ci = nr, ni
    return cr


def _degen_td(td):
    """Runtime td == 0 flag for a Padé delay block (None when statically
    nonzero, so the common case pays no masking)."""
    if isinstance(td, float):
        return True if td == 0.0 else None
    return td == 0


def _pade_coeffs(td):
    """Padé(3,3) rational approximation of e^{−s·td}:
    H(s) = P(−s·td)/P(s·td) with P(u) = 1 + u/2 + u²/10 + u³/120.
    All-pass (|H| = 1), exact DC gain, group delay within 1% out to
    ω·td ≈ 4 rad.  td may be a traced scalar."""
    c = (1.0, 0.5, 0.1, 1.0 / 120.0)
    den = [c[i] * td ** i if i else 1.0 for i in range(4)]
    num = [den[0], -den[1], den[2], -den[3]]
    return num, den


def make_device(module: Module, strict_ranges=False, delay_mode=None,
                transition_mode=None):
    """Compile a parsed VA Module into a DeviceModel subclass.

    ``delay_mode``: how ``absdelay`` lowers (default from
    ``config.va_delay_mode``):

    * ``"pade"`` — Padé(3,3) all-pass companion states (exact DC gain,
      group delay good to ω·td ≈ 4 rad); works in every analysis.
    * ``"history"`` — exact history interpolation: the integrator carries a
      ring buffer of the delayed expression's accepted-step samples and the
      device reads u(t−td) as an injected input (transient + DC only; AC /
      noise raise — there is no linearized e^{−jωtd} stamp on this path).
      Wideband-exact where Padé runs out of band.

    ``transition_mode``: how ``transition`` lowers (default from
    ``config.va_transition_mode``):

    * ``"smooth"`` — exponential edge shaping via one companion state
      (within 1% of target after the rise/fall time); all analyses.
    * ``"latch"`` — LRM-exact linear ramps: the integrator's latched-state
      channel carries (target, y_start, t_start) per site, re-latched at
      accepted steps when the input changes, and the output is the exact
      piecewise-linear ramp y_start + (target−y_start)·min(1, (t−t_start)/
      rise_or_fall).  A nonzero delay argument still rides the Padé block
      ahead of the latch.  AC treats the operator as unity gain.
    """
    if delay_mode is None:
        from cedarsim_tpu import config as _cfg
        delay_mode = getattr(_cfg, "va_delay_mode", "pade")
    if delay_mode not in ("pade", "history"):
        raise VACodegenError(f"unknown delay_mode {delay_mode!r}")
    if transition_mode is None:
        from cedarsim_tpu import config as _cfg
        transition_mode = getattr(_cfg, "va_transition_mode", "smooth")
    if transition_mode not in ("smooth", "latch"):
        raise VACodegenError(f"unknown transition_mode {transition_mode!r}")
    ports = list(module.ports)
    grounds = set(module.ground_nets)
    internal = [n for n in module.nets if n not in ports and n not in grounds]
    named_branch = {b.name: (b.pos, b.neg) for b in module.branches}

    # --- static scan: branch classification, noise sources, feature checks
    v_branches = []        # ordered (a, b) pairs with any V contribution
    i_branches = set()
    switch_branches = set()  # branches with BOTH kinds (runtime-switched)
    noise_sites = []       # (kind, n_args) in lexical order
    ddx_probes = []        # node names probed by ddx(expr, V(node))
    for e in _all_exprs(module):
        if e[0] == "call" and e[1] == "ddx" and len(e[2]) == 2:
            acc = e[2][1]
            if acc[0] == "call" and acc[1] == "V" and len(acc[2]) == 1 \
                    and acc[2][0][0] == "ref":
                nodename = acc[2][0][1]
                if nodename not in ddx_probes:
                    ddx_probes.append(nodename)
            else:
                raise VACodegenError(
                    f"module {module.name}: ddx() supports single-node "
                    "V(node) probes")
    for st in _walk_stmts(module.analog):
        if st[0] == "contrib":
            kind, a, b = st[1]
            if a in named_branch:
                a, b = named_branch[a]
            key = (a, b)
            if kind == "V":
                if key not in v_branches:
                    v_branches.append(key)
            else:
                i_branches.add(key)
    for key in v_branches:
        if key in i_branches:
            # runtime-switched branch (reference branch state machine,
            # vasim.jl:128-180): keeps a current unknown; the branch row
            # selects the active constraint
            switch_branches.add(key)
    idt_sites = []
    lf_sites = []       # [(expr, kind, n_states)] lexical order — linear
    #                     filter / event operators carrying extra states
    dly_sites = []      # absdelay sites in history mode (exact-delay inputs)
    lat_sites = []      # [(expr, kind, n_slots)] event-latched sites:
    #                     latch-mode transition ramps + zi_* sampled filters
    for e in _all_exprs(module):
        if e[0] == "call":
            if e[1] in ("white_noise", "flicker_noise", "noise_table"):
                if not any(x is e for x in noise_sites):
                    noise_sites.append(e)
            if e[1] == "idt" and not any(x is e for x in idt_sites):
                idt_sites.append(e)

            if e[1] in _LF_OPS:
                if (e[1] == "absdelay" and delay_mode == "history"
                        and 2 <= len(e[2]) <= 3
                        and _try_const(e[2][1], module) != 0.0):
                    # exact-history lowering: no companion states — the
                    # site becomes an injected delayed-value input
                    if not any(x is e for x in dly_sites):
                        dly_sites.append(e)
                elif (e[1] == "transition" and transition_mode == "latch"):
                    # LRM-exact ramp: latched state instead of the ODE
                    # shaper; a nonzero delay keeps its Padé block
                    if not any(x is e for x, _, _ in lat_sites):
                        lat_sites.append((e, "transition", 3))
                        if (len(e[2]) >= 2
                                and _try_const(e[2][1], module) != 0.0):
                            lf_sites.append((e, "transition", _PADE_ORDER))
                elif not any(x is e for x, _, _ in lf_sites):
                    lf_sites.append((e, e[1], _lf_n_states(module, e)))

            if e[1] in ("zi_nd", "zi_np", "zi_zd", "zi_zp"):
                # z-domain filters: sampled IIR over the latched-state
                # channel (the reference simulator has no runtime support
                # — VerilogAParser tokenizes them only)
                if not any(x is e for x, _, _ in lat_sites):
                    nb, na = _zi_coeff_counts(module, e)
                    # [y_held, t_next, u_hist(nb-1), y_hist(max(0, na-2))]
                    lat_sites.append(
                        (e, e[1], 2 + (nb - 1) + max(0, na - 2)))

    # --- parameters
    given_queries = set()
    for e in _all_exprs(module):
        if e[0] == "call" and e[1] == "$param_given" and e[2]:
            a = e[2][0]
            if a[0] == "ref":
                given_queries.add(a[1])
    pdefaults = {}      # actual-name -> default expr
    porder = []
    lower_map = {}
    for p in module.parameters:
        pdefaults[p.name] = p
        porder.append(p.name)
        lower_map.setdefault(p.name.lower(), p.name)
        for al in p.aliases:
            lower_map.setdefault(al.lower(), p.name)

    node_index = {}
    for i, n in enumerate(ports):
        node_index[n] = i
    for i, n in enumerate(internal):
        node_index[n] = len(ports) + i
    for g in grounds:
        node_index[g] = -1
    n_nodes_local = len(ports) + len(internal)
    branch_index = {key: n_nodes_local + i for i, key in
                    enumerate(v_branches)}

    interp = _Interp(module, node_index, branch_index, named_branch,
                     n_nodes_local, len(v_branches), noise_sites,
                     ddx_probes, idt_sites, switch_branches, lf_sites,
                     dly_sites, lat_sites)

    class VADevice(DeviceModel):
        terminals = tuple(ports)
        n_internal = len(internal)
        n_branch = (len(v_branches) + len(idt_sites)
                    + sum(n for _, _, n in lf_sites))
        n_noise = len(noise_sites)
        n_delay = len(dly_sites)
        n_latch = interp.n_lat_slots
        params = {}            # filled below (nominal defaults)
        given_params = ()
        va_module = module
        param_order = tuple(porder)
        param_lower = dict(lower_map)

        @classmethod
        def prepare(cls, raw: dict) -> dict:
            """Evaluate parameter defaults (which may reference other params)
            with instance overrides, host-side."""
            vals = {}
            raws = {}
            for k, v in (raw or {}).items():
                actual = cls.param_lower.get(str(k).lower())
                if actual is None:
                    raise ValueError(
                        f"{module.name}: unknown parameter {k!r}")
                raws[actual] = v
            env = _HostParamEnv(pdefaults, raws, module)
            out = {}
            for name in cls.param_order:
                v = env[name]
                _check_range(module, pdefaults[name], v, strict_ranges)
                out[name] = float(v)
                out[name + "$given"] = float(name in raws)
            return out

        @staticmethod
        def eval(lv, p, ctx, eps):
            # eps is the aux-input vector: [n_noise noise draws,
            # n_delay exact-history delayed values, n_latch latched state]
            return interp.run(lv, p, ctx, eps, collect_noise=False)

        @classmethod
        def noise(cls, lv, p, ctx):
            return interp.run(lv, p, ctx,
                              jnp.zeros(cls.n_noise + cls.n_delay
                                        + cls.n_latch),
                              collect_noise=True)

        @classmethod
        def delays(cls, lv, p, ctx):
            """(u_now, td) for every exact-history absdelay site at the
            given point — u_now feeds the integrator's history ring, td the
            t−td lookups."""
            return interp.run(lv, p, ctx,
                              jnp.zeros(cls.n_noise + cls.n_delay
                                        + cls.n_latch),
                              collect_noise=False, collect_delay=True)

        @classmethod
        def latch0(cls, lv, p, ctx):
            """Initial latched state (every transition site settled at the
            operating point)."""
            return interp.run(lv, p, ctx,
                              jnp.zeros(cls.n_noise + cls.n_delay
                                        + cls.n_latch),
                              collect_noise=False, collect_latch="init")

        @classmethod
        def latch(cls, lv, p, ctx, lat):
            """Updated latched state after an accepted step at ctx.time:
            transition sites re-latch their ramp when the input changed."""
            eps = jnp.concatenate(
                [jnp.zeros(cls.n_noise + cls.n_delay, lat.dtype), lat])
            return interp.run(lv, p, ctx, eps,
                              collect_noise=False, collect_latch="update")

        @classmethod
        def eval_var(cls, lv, p, ctx, name):
            """Value of a module-level variable at the given operating
            point — exposes VA variables (incl. (* desc *)-annotated ones)
            as observables (reference vasim.jl:742-752,841-843).  NOTE:
            exact-history delayed inputs read 0 here (the solution arrays
            don't carry the rings) — delayed-variable observables are only
            exact through the pade path."""
            return interp.run(lv, p, ctx,
                              jnp.zeros(cls.n_noise + cls.n_delay
                                        + cls.n_latch),
                              collect_noise=False, capture_var=name)

    # nominal defaults (so DeviceModel machinery sees names)
    VADevice.params = {n: None for n in porder}
    VADevice.__name__ = f"VA_{module.name}"
    VADevice.__qualname__ = VADevice.__name__
    #: per-site latched-state layout [(kind, slot offset, n_slots)] —
    #: consumed by analysis/ac._delay_ac to build sampled-system
    #: H(e^{jωT}) small-signal stamps for zi_* sites; ``zi_meta`` maps a
    #: zi site's slot offset to its (nb, na) coefficient counts
    VADevice.lat_sites = [tuple(s) for s in interp.lat_sites]
    VADevice.zi_meta = {
        loff: _zi_coeff_counts(module, e)
        for (e, kind, _n), (k2, loff, _n2) in zip(lat_sites,
                                                  interp.lat_sites)
        if kind.startswith("zi")}

    zi_clock_exprs = [e for (e, kind, _n) in lat_sites
                      if kind.startswith("zi")]
    if zi_clock_exprs:
        def _zi_breakpoints(params, tstop):
            """Sample-clock grid t0 + n·T for every zi_* site — the
            integrator's breakpoint schedule lands accepted steps exactly
            on the samples (the while_loop replacement for an event
            queue's timer events)."""
            import numpy as _np
            pts = []
            for e in zi_clock_exprs:
                T = _host_eval(e[2][3], module, params)
                t0a = (_host_eval(e[2][5], module, params)
                       if len(e[2]) > 5 else 0.0)
                if T <= 0.0:
                    raise VACodegenError(
                        f"module {module.name}: zi_* sample period must "
                        f"be positive (got {T})")
                n = int(_np.floor((tstop - t0a) / T))
                if n > 200_000:
                    raise VACodegenError(
                        f"module {module.name}: zi_* clock would need {n} "
                        f"sample breakpoints in ({t0a}, {tstop}) — period "
                        "too small for this time span")
                if n > 0:
                    pts.append(t0a + T * _np.arange(1, n + 1))
            return (_np.concatenate(pts) if pts
                    else _np.zeros(0, _np.float64))
        VADevice.breakpoints = staticmethod(_zi_breakpoints)
    return VADevice


def _check_range(module, param, v, strict):
    import warnings
    for r in param.ranges:
        if r.kind == "from":
            try:
                lo = _const_expr(r.lo, module)
                hi = _const_expr(r.hi, module)
            except Exception:
                continue
            ok = (v > lo or (r.lo_incl and v == lo)) and \
                 (v < hi or (r.hi_incl and v == hi))
            if not ok:
                msg = (f"{module.name}.{param.name}={v} outside range "
                       f"{'[' if r.lo_incl else '('}{lo}:{hi}"
                       f"{']' if r.hi_incl else ')'}")
                if strict:
                    raise ValueError(msg)
                warnings.warn(msg, stacklevel=3)


def _const_expr(e, module):
    if e is None:
        raise ValueError("no bound")
    if e[0] == "num":
        return e[1]
    if e[0] == "un" and e[1] == "-":
        return -_const_expr(e[2], module)
    if e[0] == "ref" and e[1] == "inf":
        return math.inf
    raise ValueError("non-constant bound")


class _HostParamEnv:
    """Lazy host-side evaluation of parameter defaults (may reference other
    params); instance overrides win."""

    def __init__(self, pdefaults, overrides, module):
        self.pdefaults = pdefaults
        self.overrides = overrides
        self.module = module
        self.cache = {}
        self._stack = set()

    def __getitem__(self, name):
        if name in self.cache:
            return self.cache[name]
        if name in self.overrides:
            v = float(self.overrides[name])
        elif name in self.pdefaults:
            if name in self._stack:
                raise ValueError(f"circular parameter default {name!r}")
            self._stack.add(name)
            try:
                v = self._eval(self.pdefaults[name].default)
            finally:
                self._stack.discard(name)
        else:
            raise ValueError(
                f"{self.module.name}: undefined identifier {name!r} in "
                "parameter default")
        self.cache[name] = v
        return v

    def _eval(self, e):
        k = e[0]
        if k == "num":
            return e[1]
        if k == "str":
            return e[1]
        if k == "ref":
            if e[1] == "inf":
                return math.inf
            return self[e[1]]
        if k == "un":
            v = self._eval(e[2])
            return {"-": lambda x: -x, "!": lambda x: float(not x),
                    "~": lambda x: float(~int(x))}[e[1]](v)
        if k == "bin":
            a, b = self._eval(e[2]), self._eval(e[3])
            return _host_binop(e[1], a, b)
        if k == "cond":
            return self._eval(e[2]) if self._eval(e[1]) else self._eval(e[3])
        if k == "call":
            name, args = e[1], [self._eval(a) for a in e[2]]
            if name in _MATH1:
                return float(np.asarray(_MATH1[name](args[0])))
            if name in _MATH2:
                return float(np.asarray(_MATH2[name](args[0], args[1])))
            if name == "$temperature":
                return 300.15
            if name == "$vt":
                return 1.380649e-23 * (args[0] if args else 300.15) \
                    / 1.602176634e-19
            raise ValueError(f"cannot evaluate {name}() in parameter default")
        raise ValueError(f"bad default expression {e!r}")


def _host_binop(op, a, b):
    import operator
    ops = {"+": operator.add, "-": operator.sub, "*": operator.mul,
           "/": operator.truediv, "%": math.fmod, "**": math.pow,
           "==": lambda x, y: float(x == y), "!=": lambda x, y: float(x != y),
           "<": lambda x, y: float(x < y), "<=": lambda x, y: float(x <= y),
           ">": lambda x, y: float(x > y), ">=": lambda x, y: float(x >= y),
           "&&": lambda x, y: float(bool(x) and bool(y)),
           "||": lambda x, y: float(bool(x) or bool(y)),
           "&": lambda x, y: float(int(x) & int(y)),
           "|": lambda x, y: float(int(x) | int(y)),
           "^": lambda x, y: float(int(x) ^ int(y)),
           "<<": lambda x, y: float(int(x) << int(y)),
           ">>": lambda x, y: float(int(x) >> int(y))}
    try:
        return ops[op](a, b)
    except (OverflowError, ZeroDivisionError, ValueError):
        # IEEE semantics like the traced path (jnp gives inf/nan, Python
        # floats raise) — fold through numpy instead
        npops = {"/": np.divide, "*": np.multiply, "+": np.add,
                 "-": np.subtract, "%": np.fmod, "**": np.power}
        with np.errstate(all="ignore"):
            return float(npops[op](np.float64(a), np.float64(b)))


# ---------------------------------------------------------------- interpreter

class _Interp:
    def __init__(self, module, node_index, branch_index, named_branch,
                 n_nodes_local, n_vbranch, noise_sites, ddx_probes=(),
                 idt_sites=(), switch_branches=(), lf_sites=(),
                 dly_sites=(), lat_sites=()):
        self.switch_branches = frozenset(switch_branches)
        self.module = module
        self.ddx_probes = tuple(ddx_probes)
        self.noise_site_ids = {id(e): k for k, e in enumerate(noise_sites)}
        self.idt_site_ids = {id(e): k for k, e in enumerate(idt_sites)}
        self.n_idt = len(idt_sites)
        # exact-history absdelay sites: the call reads its delayed value
        # from the aux-input slot n_noise + k (delay_mode="history")
        self.dly_site_ids = {id(e): k for k, e in enumerate(dly_sites)}
        self.n_dly = len(dly_sites)
        # event-latched sites (latch-mode transition ramps, zi_* sampled
        # filters): id(expr) → index; per-site (kind, slot offset, n_slots)
        # into the latched aux block at n_noise + n_dly + off
        self.lat_site_ids = {}
        self.lat_sites = []
        loff = 0
        for k, (e, kind, n_sl) in enumerate(lat_sites):
            self.lat_site_ids[id(e)] = k
            self.lat_sites.append((kind, loff, n_sl))
            loff += n_sl
        self.n_lat_slots = loff
        # filter/event operator sites: id(expr) → (index, kind, offset,
        # n_states); offsets pack the state blocks after the idt rows
        self.lf_site_ids = {}
        self.lf_sites = []
        off = 0
        for k, (e, kind, n_st) in enumerate(lf_sites):
            self.lf_site_ids[id(e)] = k
            self.lf_sites.append((kind, off, n_st))
            off += n_st
        self.n_lf = off
        self.node_index = node_index
        self.branch_index = branch_index
        self.named_branch = named_branch
        self.n_nodes = n_nodes_local
        self.n_vbranch = n_vbranch
        self.n_noise = len(noise_sites)

    # env keys: str = variable; ("I", a, b) = current contrib accumulator;
    # ("V", a, b) = voltage contrib accumulator
    def run(self, lv, p, ctx, eps, collect_noise, capture_var=None,
            capture_all=False, collect_delay=False, collect_latch=None):
        st = _State(self, lv, p, ctx, eps, collect_noise,
                    collect_delay=collect_delay, collect_latch=collect_latch)
        lvd = st.lv_dtype   # lv may be a stacked array OR a per-lvar list
        # row-zero prototype: rows never touched by a contribution must
        # still stack with touched ones.  Under the vmapped path lv
        # entries are () scalars, so zeros(()) matches; the fused-kernel
        # path passes (1, n_inst) TILES un-vmapped, and a () zero next to
        # a (1, n_inst) row breaks the final jnp.stack (hit by bsim4's
        # untouched rows, round-4)
        zrow = (jnp.zeros_like(lv[0]) if len(lv)
                else jnp.zeros((), lvd))
        self._ctx_mode = ctx.mode
        env = {}
        for stmt in self.module.analog:
            st.stmt(stmt, env)
        if collect_delay:
            zero = zrow
            u = [zero] * self.n_dly
            td = [zero] * self.n_dly
            for k, (uv, tv) in st.dly_rec.items():
                u[k] = uv + zero
                td[k] = tv + zero
            return jnp.stack(u) if u else jnp.zeros(0, lvd), \
                jnp.stack(td) if td else jnp.zeros(0, lvd)
        if collect_latch is not None:
            # flattened per-site latched-state rows
            zero = zrow
            out = [zero] * self.n_lat_slots
            for k, vals in st.lat_rec.items():
                _kind, off, n_sl = self.lat_sites[k]
                for i, v in enumerate(vals):
                    out[off + i] = v + zero
            return (jnp.stack(out) if out else jnp.zeros(0, lvd))
        if capture_all:
            # debug/observability: every module-level variable's value
            return {k: _pair(v)[0] + jnp.zeros((), lvd)
                    for k, v in env.items() if isinstance(k, str)}
        if capture_var is not None:
            v = env.get(capture_var, 0.0)
            return _pair(v)[0] + jnp.zeros((), lvd)
        zero = zrow
        n_rows = self.n_nodes + self.n_vbranch + self.n_idt + self.n_lf
        static = [zero] * n_rows
        dynamic = [zero] * n_rows

        def add_row(idx, s, q):
            if idx < 0:
                return
            static[idx] = static[idx] + s
            if q is not None:
                dynamic[idx] = dynamic[idx] + q

        # filter/event operator state rows: the call site stores each row's
        # (static, dynamic) pair under ("LFROW", site, i); a site whose
        # statement never executed this trace (statically-dead branch)
        # pins its states to zero so the block row stays nonsingular
        lf_base = self.n_nodes + self.n_vbranch + self.n_idt
        for k, (kind, off, n_st) in enumerate(self.lf_sites):
            for i in range(n_st):
                row = lf_base + off + i
                v = env.get(("LFROW", k, i))
                if v is None:
                    static[row] = static[row] + lv[row]
                else:
                    s, q = _pair(v)[:2]
                    static[row] = static[row] + s
                    if q is not None:
                        dynamic[row] = dynamic[row] + q

        for key, val in env.items():
            if not isinstance(key, tuple):
                continue
            if key[0] == "LFROW":
                continue
            if key[0] == "IDT":
                # idt state y_k: row = −arg + d/dt(y) = 0 (tran); in the
                # operating point the state pins to its ic (integrators have
                # no DC solution otherwise)
                k2 = key[1]
                row = self.n_nodes + self.n_vbranch + k2
                yv = lv[row]
                arg, icval = val
                from cedarsim_tpu.core.context import Modes as _M
                if self._ctx_mode in (_M.DCOP, _M.TRANOP):
                    static[row] = static[row] + (yv - icval)
                else:
                    static[row] = static[row] - _pair(arg)[0]
                    dynamic[row] = dynamic[row] + yv
                continue
            kind, a, b = key
            if kind == "Vact":
                continue
            s, q = _pair(val)[:2]
            ia = self.node_index[a]
            ib = self.node_index[b] if b is not None else -1
            if kind == "I" and (a, b) in self.switch_branches:
                # handled together with the V entry below
                continue
            if kind == "V" and (a, b) in self.switch_branches:
                bidx = self.branch_index[(a, b)]
                ibr = lv[bidx]
                add_row(ia, ibr, None)
                add_row(ib, -ibr, None)
                va = lv[ia] if ia >= 0 else zero
                vb = lv[ib] if ib >= 0 else zero
                act = _pair(env.get(("Vact", a, b), 0.0))[0]
                i_s, i_q = _pair(env.get(("I", a, b),
                                         (zero, None, None)))[:2]
                # V-mode: (vab − v_expr) = 0; I-mode: (i_br − i_expr) = 0
                v_row_s = (va - vb) - s
                i_row_s = ibr - i_s
                st_row = jnp.where(act != 0, v_row_s, i_row_s)
                qv = zero if q is None else -q
                qi = zero if i_q is None else -i_q
                dyn_row = jnp.where(act != 0, qv, qi)
                add_row(bidx, st_row, dyn_row)
                continue
            if kind == "I":
                add_row(ia, s, q)
                if q is None:
                    qn = None
                else:
                    qn = -q
                add_row(ib, -s, qn)
            else:  # V contribution: branch row
                bidx = self.branch_index[(a, b)]
                ibr = lv[bidx]
                # KCL: +i at a, -i at b
                add_row(ia, ibr, None)
                add_row(ib, -ibr, None)
                va = lv[ia] if ia >= 0 else zero
                vb = lv[ib] if ib >= 0 else zero
                add_row(bidx, (va - vb) - s, None if q is None else -q)
        if collect_noise:
            pwr = st.noise_pwr + [zero] * (self.n_noise - len(st.noise_pwr))
            ex = st.noise_exp + [zero] * (self.n_noise - len(st.noise_exp))
            if self.n_noise == 0:
                return jnp.zeros((0,)), jnp.zeros((0,))
            return jnp.stack(pwr), jnp.stack(ex)
        return jnp.stack(static), jnp.stack(dynamic)


class _State:
    def __init__(self, interp, lv, p, ctx, eps, collect_noise,
                 collect_delay=False, collect_latch=None):
        self.it = interp
        self.lv = lv
        # lv arrives either as one stacked array or as a list of per-lvar
        # tiles (the fused-chord kernel passes a list so each tile keeps a
        # static index); dtype probes must not assume the array form
        try:
            self.lv_dtype = jnp.result_type(
                lv[0] if isinstance(lv, (list, tuple)) else lv)
        except (IndexError, TypeError):
            self.lv_dtype = jnp.float64
        self.p = p
        self.ctx = ctx
        self.eps = eps
        self.collect = collect_noise
        self.collect_delay = collect_delay
        self.collect_latch = collect_latch  # None | "init" | "update"
        self.dly_rec = {}          # site k -> (u_now, td)
        self.lat_rec = {}          # site k -> (target, y_start, t_start)
        self.noise_pwr = []
        self.noise_exp = []
        self.zero = 0.0

    # ------------------------------------------------------------ statements

    def stmt(self, st, env):
        k = st[0]
        if k == "null":
            return
        if k == "block":
            for name, (ty, init) in st[2].items():
                if ty == "param" and init is not None:
                    env[name] = self.expr(init, env)
                elif name not in env:
                    env[name] = self.zero
            for s2 in st[1]:
                self.stmt(s2, env)
            return
        if k == "assign":
            env[st[1]] = self.expr(st[2], env)
            return
        if k == "contrib":
            kind, a, b = st[1]
            if a in self.it.named_branch:
                a, b = self.it.named_branch[a]
            val = _pair(self.expr(st[2], env))
            val = (val[0], val[1], None)  # contributions drop ddx tangents
            if (a, b) in self.it.switch_branches:
                # branch state machine (vasim.jl:128-180): a contribution of
                # one kind discards the other kind's accumulation
                vk, ik = ("V", a, b), ("I", a, b)
                actk = ("Vact", a, b)
                if kind == "V":
                    env[vk] = _padd(env.get(vk, (self.zero, None, None)),
                                    val)
                    env[ik] = (self.zero, None, None)
                    env[actk] = 1.0
                else:
                    env[ik] = _padd(env.get(ik, (self.zero, None, None)),
                                    val)
                    env[vk] = (self.zero, None, None)
                    env[actk] = 0.0
                return
            key = (kind, a, b)
            cur = env.get(key, (self.zero, None, None))
            env[key] = _padd(cur, val)
            return
        if k == "if":
            cond = _scalar(self.expr(st[1], env), "condition")
            if _concrete(cond):
                if float(cond) != 0.0:
                    self.stmt(st[2], env)
                elif st[3] is not None:
                    self.stmt(st[3], env)
                return
            env_t = dict(env)
            self.stmt(st[2], env_t)
            env_f = dict(env)
            if st[3] is not None:
                self.stmt(st[3], env_f)
            self._merge(env, cond, env_t, env_f)
            return
        if k == "case":
            sel = _scalar(self.expr(st[1], env), "case selector")
            labels_concrete = _concrete(sel)
            if labels_concrete:
                default_body = None
                for labels, body in st[2]:
                    if labels is None:
                        default_body = body
                        continue
                    lvs = [self.expr(l, env) for l in labels]
                    if not _concrete(*[_pair(lv_)[0] for lv_ in lvs]):
                        labels_concrete = False
                        break
                    if any(float(_pair(lv_)[0]) == float(sel) for lv_ in lvs):
                        self.stmt(body, env)
                        return
                if labels_concrete:
                    if default_body is not None:
                        self.stmt(default_body, env)
                    return
            # traced selector: desugar to where-merged if-chain
            matched = jnp.zeros((), bool)
            branches = []
            for labels, body in st[2]:
                if labels is None:
                    cond = jnp.logical_not(matched)
                else:
                    c = jnp.zeros((), bool)
                    for l in labels:
                        lv_ = _scalar(self.expr(l, env))
                        c = jnp.logical_or(c, jnp.asarray(sel == lv_))
                    cond = jnp.logical_and(c, jnp.logical_not(matched))
                    matched = jnp.logical_or(matched, c)
                branches.append((cond, body))
            for cond, body in branches:
                env_t = dict(env)
                self.stmt(body, env_t)
                self._merge(env, cond, env_t, dict(env))
            return
        if k == "for":
            # static unroll: bounds must be host-evaluable
            init, cond, step, body = st[1], st[2], st[3], st[4]
            self.stmt(init, env)
            guard = 0
            while True:
                c = self.expr(cond, env)
                c = _pair(c)[0]
                cc = self._static_bool(c)
                if cc is None:
                    raise VACodegenError(
                        f"{self.it.module.name}: for-loop condition is not "
                        "statically evaluable (traced loop bounds)")
                if not cc:
                    break
                self.stmt(body, env)
                self.stmt(step, env)
                guard += 1
                if guard > 10000:
                    raise VACodegenError("for-loop unroll limit exceeded")
            return
        if k == "repeat":
            cnt = self._static_bool(self.expr(st[1], env), want_val=True)
            if cnt is None:
                raise VACodegenError("repeat count must be static")
            for _ in range(int(cnt)):
                self.stmt(st[2], env)
            return
        if k == "while":
            guard = 0
            while True:
                c = self._static_bool(_pair(self.expr(st[1], env))[0])
                if c is None:
                    raise VACodegenError(
                        f"{self.it.module.name}: while-loop with traced "
                        "condition not supported")
                if not c:
                    break
                self.stmt(st[2], env)
                guard += 1
                if guard > 10000:
                    raise VACodegenError("while-loop unroll limit exceeded")
            return
        if k == "event":
            names = st[1]
            # initial_step blocks typically precompute operating parameters —
            # execute unconditionally; other events are ignored.
            if any("initial_step" in n for n in names):
                self.stmt(st[2], env)
            return
        if k == "sys":
            return  # $strobe/$display/$finish → no-op
        if k == "call":
            self._call_function(st[1], st[2], env)
            return
        raise VACodegenError(f"unhandled statement {k!r}")

    def _static_bool(self, v, want_val=False):
        try:
            arr = np.asarray(v)
            if arr.size == 1:
                return float(arr) if want_val else bool(arr)
        except Exception:
            return None
        return None

    def _merge(self, env, cond, env_t, env_f):
        keys = set(env_t) | set(env_f)
        for k in keys:
            base = env.get(k, (self.zero, None, None))
            tv = env_t.get(k, base)
            fv = env_f.get(k, base)
            if tv is fv:
                # untouched by either branch (env copies share the object) —
                # no select needed; merging everything here used to dominate
                # whole-model traces (BSIM-CMG: 21k of 25k eqns were wheres)
                env[k] = tv
                continue
            a = _pair(tv)
            b = _pair(fv)
            s = a[0] if a[0] is b[0] else jnp.where(cond, a[0], b[0])
            if a[1] is None and b[1] is None:
                q = None
            elif a[1] is b[1]:
                q = a[1]
            else:
                qa = self.zero if a[1] is None else a[1]
                qb = self.zero if b[1] is None else b[1]
                q = jnp.where(cond, qa, qb)
            d = _dmerge(a[2], b[2],
                        lambda x, y: x if x is y else jnp.where(cond, x, y))
            env[k] = (s, q, d)

    # ----------------------------------------------------------- expressions

    def expr(self, e, env):
        k = e[0]
        if k == "num":
            return float(e[1])
        if k == "str":
            return e[1]
        if k == "ref":
            return self._ref(e[1], env)
        if k == "un":
            v = self.expr(e[2], env)
            if e[1] == "-":
                return _pneg(v)
            if e[1] == "!":
                sv = _scalar(v)
                if _concrete(sv):
                    return float(sv == 0)
                return jnp.logical_not(sv != 0).astype(self.lv_dtype)
            if e[1] == "~":
                sv = _scalar(v)
                if _concrete(sv):
                    return float(~int(sv))
                return (~(sv.astype(jnp.int32))).astype(self.lv_dtype)
        if k == "bin":
            return self._binop(e[1], e[2], e[3], env)
        if k == "cond":
            c = _scalar(self.expr(e[1], env))
            if _concrete(c):
                return self.expr(e[2] if float(c) != 0 else e[3], env)
            a = _pair(self.expr(e[2], env))
            b = _pair(self.expr(e[3], env))
            s = jnp.where(c != 0, a[0], b[0])
            if a[1] is None and b[1] is None:
                q = None
            else:
                qa = self.zero if a[1] is None else a[1]
                qb = self.zero if b[1] is None else b[1]
                q = jnp.where(c != 0, qa, qb)
            d = _dmerge(a[2], b[2],
                        lambda x, y: jnp.where(c != 0, x, y))
            return (s, q, d)
        if k == "call":
            return self._callexpr(e[1], e[2], env, node=e)
        raise VACodegenError(f"unhandled expression {e!r}")

    def _ref(self, name, env):
        if name in env:
            return env[name]
        if name in self.p:
            return self.p[name]
        if name.startswith("$"):
            # no-arg system functions used without parens ($temperature, $vt)
            return self._callexpr(name, [], env)
        if name == "inf":
            return np.inf
        mv = self.it.module.variables
        if name in mv:
            return self.zero
        consts = {"M_PI": math.pi, "M_E": math.e, "M_SQRT2": math.sqrt(2),
                  "M_LN2": math.log(2), "M_LN10": math.log(10),
                  "M_LOG2E": 1/math.log(2), "M_LOG10E": 1/math.log(10),
                  "M_PI_2": math.pi/2, "M_PI_4": math.pi/4,
                  "M_1_PI": 1/math.pi, "M_2_PI": 2/math.pi,
                  "M_SQRT1_2": math.sqrt(0.5), "M_TWO_PI": 2*math.pi,
                  "P_Q": 1.602176634e-19, "P_K": 1.380649e-23,
                  "P_EPS0": 8.8541878128e-12, "P_H": 6.62607015e-34,
                  "P_CELSIUS0": 273.15, "P_C": 299792458.0,
                  "P_U0": 1.25663706212e-6}
        if name in consts:
            return consts[name]
        raise VACodegenError(
            f"{self.it.module.name}: undefined identifier {name!r}")

    def _binop(self, op, ea, eb, env):
        if op == "/":
            # Balanced quotient evaluation: a*b/(c*d) evaluates as
            # (a/c)*(b/d) instead of (a*b)/(c*d), so intermediate products
            # stay within the f32 exponent range when a model evaluates in
            # f32.  BSIM-CMG's vbi = Vtm*ln(NBODY*NSD/(ni*ni)) reaches 1e50
            # in source order; balanced it peaks at ~1e17.
            # Reassociation only perturbs rounding at the ulp level.
            num, den = [], []
            _flatten_muldiv(ea, num, den)
            _flatten_muldiv(eb, den, num)
            if len(num) >= 2 and len(den) >= 2:
                vn = [self.expr(e, env) for e in num]
                vd = [self.expr(e, env) for e in den]
                out = _pdiv(vn[0], vd[0])
                i = 1
                for j in range(1, len(vd)):
                    if i < len(vn):
                        out = _pmul(out, vn[i])
                        i += 1
                    out = _pdiv(out, vd[j])
                for k in range(i, len(vn)):
                    out = _pmul(out, vn[k])
                return out
        a = self.expr(ea, env)
        b = self.expr(eb, env)
        if op == "+":
            return _padd(a, b)
        if op == "-":
            return _psub(a, b)
        if op == "*":
            return _pmul(a, b)
        if op == "/":
            return _pdiv(a, b)
        if op == "**":
            va, da = _dual(a)
            vb, db = _dual(b)
            _scalar(a, "'**'"); _scalar(b, "'**'")
            if _concrete(va, vb) and da is None and db is None:
                return _host_binop(op, float(va), float(vb))
            out = _safe_pow(va, vb)
            if da is None and db is None:
                return out
            ga = vb * _safe_pow(va, vb - 1.0)
            d1 = _dscale(da, ga)
            d2 = None
            if db is not None:
                d2 = _dscale(db, jnp.where(va > 0, jnp.log(
                    jnp.where(va > 0, va, 1.0)) * out, 0.0))
            return (out, None, _dmerge(d1, d2, lambda x, y: x + y))
        sa, sb = _scalar(a, f"'{op}'"), _scalar(b, f"'{op}'")
        if _concrete(sa, sb):
            from cedarsim_tpu.va.codegen import _host_binop
            return _host_binop(op, float(sa), float(sb))
        d = self.lv_dtype
        if op == "%":
            return jnp.fmod(sa, sb)
        cmp = {"==": lambda: sa == sb, "!=": lambda: sa != sb,
               "<": lambda: sa < sb, "<=": lambda: sa <= sb,
               ">": lambda: sa > sb, ">=": lambda: sa >= sb,
               "&&": lambda: (sa != 0) & (sb != 0),
               "||": lambda: (sa != 0) | (sb != 0)}
        if op in cmp:
            return jnp.asarray(cmp[op]()).astype(d)
        ia = jnp.asarray(sa).astype(jnp.int32)
        ib = jnp.asarray(sb).astype(jnp.int32)
        bit = {"&": ia & ib, "|": ia | ib, "^": ia ^ ib,
               "<<": ia << ib, ">>": ia >> ib}
        if op in bit:
            return bit[op].astype(d)
        raise VACodegenError(f"unhandled operator {op!r}")

    def _node_v(self, name):
        idx = self.it.node_index.get(name)
        if idx is None:
            raise VACodegenError(
                f"{self.it.module.name}: unknown node {name!r}")
        return self.lv[idx] if idx >= 0 else self.zero

    def _lf_laplace(self, k, base, n_st, x, num, den, env, degen=None):
        """Phase-variable companion for y = N(s)/D(s) · x: states
        z_i = w^{(i)} with D(s)·w = x, y = N(s)·w.  Rows (appended at
        ``base``): ż_i − z_{i+1} = 0 for i < n−1, and
        d_n·ż_{n−1} + Σ d_i z_i − x = 0.  At DC (dynamic parts dropped)
        this collapses to z_{i>0} = 0, d_0 z_0 = x — the exact DC gain —
        so no operating-point special case is needed.

        ``degen`` (bool or traced): the Padé-delay caller's runtime
        td == 0 flag.  A degenerate block would otherwise turn the chain
        rows into derivative trackers (z_1 = ẋ — LTE death on step
        inputs); instead pin the higher states and let the last row make
        z_0 = x algebraically."""
        z = [self.lv[base + i] for i in range(n_st)]
        for i in range(n_st - 1):
            if degen is None:
                env[("LFROW", k, i)] = (-z[i + 1], z[i])
            else:
                env[("LFROW", k, i)] = (
                    jnp.where(degen, z[i + 1], -z[i + 1]),
                    jnp.where(degen, 0.0, z[i]))
        acc = self.zero
        for i in range(n_st):
            acc = acc + den[i] * z[i]
        env[("LFROW", k, n_st - 1)] = (acc - x, den[n_st] * z[n_st - 1])
        w = list(z)
        if len(num) - 1 == n_st:
            # w^{(n)} = ż_{n−1} = (x − Σ d_i z_i)/d_n.  d_n may be a traced
            # zero (absdelay with runtime td = 0 degenerates to d = [1]):
            # then the matching numerator coefficient is zero too, so the
            # term contributes nothing — mask the division instead of
            # letting 0/0 poison the output.
            dn = den[n_st]
            if isinstance(dn, float):
                if dn != 0.0:
                    w.append((x - acc) / dn)
                else:
                    w.append(self.zero)
            else:
                nz = dn != 0
                w.append(jnp.where(nz, (x - acc)
                                   / jnp.where(nz, dn, 1.0), 0.0))
        y = self.zero
        for i, c in enumerate(num):
            y = y + c * w[i]
        return y

    def _transition_latch(self, kl, args, env, node):
        """LRM-exact transition() (transition_mode="latch"): the integrator
        carries (target, y_start, t_start) in the latched aux channel,
        re-latched at accepted steps whenever the (possibly Padé-delayed)
        input changes; the output is the exact linear ramp
        y_start + (target−y_start)·min(1, (t−t_start)/rise_or_fall)."""
        it = self.it

        def ev(e_, what):
            return _scalar(self.expr(e_, env), what)

        x = _scalar(self.expr(args[0], env), "transition")
        xd = x
        k = it.lf_site_ids.get(id(node))
        if k is not None:          # nonzero delay: Padé block feeds the latch
            _kind, off, _n_st = it.lf_sites[k]
            base = it.n_nodes + it.n_vbranch + it.n_idt + off
            td = ev(args[1], "transition delay")
            num, den = _pade_coeffs(td)
            xd = self._lf_laplace(k, base, _PADE_ORDER, x, num, den, env,
                                  degen=_degen_td(td))
        mode = self.ctx.mode
        if self.collect_latch is None and mode in (Modes.DCOP, Modes.TRANOP):
            return xd              # steady state: output settled at input
        if self.collect_latch is None and mode == Modes.AC:
            return xd              # unity small-signal gain
        rise = ev(args[2], "transition rise") if len(args) > 2 else 1e-9
        fall = ev(args[3], "transition fall") if len(args) > 3 else rise
        t = self.ctx.time
        if self.collect_latch == "init":
            # settled at the op: ramp finished well before t0
            t0i = t - jnp.maximum(jnp.maximum(rise, fall), 0.0) - 1.0
            self.lat_rec[kl] = (xd, xd, t0i)
            return xd
        _kind, loff, _nsl = it.lat_sites[kl]
        a0 = it.n_noise + it.n_dly + loff
        target, y0, t0 = self.eps[a0], self.eps[a0 + 1], self.eps[a0 + 2]
        dur = jnp.where(target >= y0, jnp.maximum(rise, 1e-15),
                        jnp.maximum(fall, 1e-15))
        frac = jnp.clip((t - t0) / dur, 0.0, 1.0)
        y = y0 + (target - y0) * frac
        if self.collect_latch == "update":
            # re-latch when the input moved: the running ramp's current
            # value becomes the new start point (LRM interrupted-ramp rule)
            tol = 1e-12 + 1e-9 * jnp.abs(xd)
            changed = jnp.abs(xd - target) > tol
            self.lat_rec[kl] = (jnp.where(changed, xd, target),
                                jnp.where(changed, y, y0),
                                jnp.where(changed, t, t0))
        return y

    def _zi_coeffs(self, name, args, env):
        """(b, a): z^{-1}-ascending numerator/denominator coefficient lists
        (root forms expanded via _poly_from_pairs in z, reversed into
        z^{-1}, numerator zero-padded to the pole count)."""
        def ev(e_):
            return _scalar(self.expr(e_, env), name)

        if name in ("zi_nd", "zi_np"):
            b = [ev(c) for c in args[1][1]]
        else:
            b = list(reversed(_poly_from_pairs([ev(c)
                                                for c in args[1][1]])))
        if name in ("zi_nd", "zi_zd"):
            a = [ev(c) for c in args[2][1]]
        else:
            a = list(reversed(_poly_from_pairs([ev(c)
                                                for c in args[2][1]])))
        if name in ("zi_zd", "zi_zp"):
            b = [0.0] * (len(a) - len(b)) + b
        return b, a

    def _zi_latch(self, name, args, env, node):
        """z-domain IIR filter (LRM 4.5.15 zi_nd/np/zd/zp): the input is
        sampled on the clock t0 + n·T (the device schedules breakpoints so
        accepted steps land exactly on the samples), the difference
        equation updates in the latched aux channel, and the output is the
        zero-order hold of y_n.  DC returns the steady gain H(z=1)·u; AC
        raises (no small-signal stamp for a sampled system on this path).
        The reference simulator has no zi_* runtime at all (VerilogAParser
        tokenizes them only)."""
        it = self.it
        kl = it.lat_site_ids.get(id(node))
        if kl is None:
            raise VACodegenError(f"{name}() site not registered")
        _kind, loff, _nsl = it.lat_sites[kl]

        def ev(e_, what):
            return _scalar(self.expr(e_, env), what)

        x = _scalar(self.expr(args[0], env), name)
        b, a = self._zi_coeffs(name, args, env)
        nb, na = len(b), len(a)
        mode = self.ctx.mode
        if self.collect_latch is None and mode in (Modes.DCOP, Modes.TRANOP):
            return x * sum(b) / sum(a)       # sampled steady state
        if self.collect_latch is None and mode == Modes.AC:
            # hold the latched output as an aux input: the analysis
            # linearizes ∂F/∂aux and adds the sampled-system H(e^{jωT})
            # stamp per site (analysis/ac._delay_ac), extracted
            # numerically from the latch-update map's Jacobians
            return self.eps[it.n_noise + it.n_dly + loff]
        t = self.ctx.time
        a0v = it.n_noise + it.n_dly + loff
        if self.collect_latch == "init":
            T = ev(args[3], "zi sample period")
            t0a = ev(args[5], "zi t0") if len(args) > 5 else 0.0
            y = x * sum(b) / sum(a)
            tn = t0a + T * (jnp.floor((t - t0a) / T + 1e-9) + 1.0)
            self.lat_rec[kl] = tuple([y, tn] + [x] * (nb - 1)
                                     + [y] * max(0, na - 2))
            return y
        y_held = self.eps[a0v]
        if self.collect_latch == "update":
            T = ev(args[3], "zi sample period")
            t_next = self.eps[a0v + 1]
            u_hist = [self.eps[a0v + 2 + i] for i in range(nb - 1)]
            y_hist = [self.eps[a0v + 2 + (nb - 1) + i]
                      for i in range(max(0, na - 2))]
            yfull = [y_held] + y_hist        # y_n, y_{n-1}, ...
            u_all = [x] + u_hist             # u_{n+1}, u_n, ...
            fire = t >= t_next - 1e-9 * T
            y_new = (sum(b[i] * u_all[i] for i in range(nb))
                     - sum(a[i + 1] * yfull[i] for i in range(na - 1))) \
                / a[0]

            def sel(nv, ov):
                return jnp.where(fire, nv, ov)

            self.lat_rec[kl] = tuple(
                [sel(y_new, y_held), sel(t_next + T, t_next)]
                + [sel(u_all[i], u_hist[i]) for i in range(nb - 1)]
                + [sel(yfull[i], y_hist[i]) for i in range(max(0, na - 2))])
            return sel(y_new, y_held)
        return y_held                        # transient: zero-order hold

    def _lf_call(self, name, args, env, node):
        """Analog filter / event operators (LRM 4.5.10-17) lowered to the
        site's extra state rows.  The reference simulator has no runtime
        support for any of these (VerilogAParser tokenizes them only) —
        this is a capability beyond parity."""
        it = self.it
        kd = it.dly_site_ids.get(id(node))
        if kd is not None:
            # exact-history absdelay (delay_mode="history"): the delayed
            # value u(t−td) arrives as aux input n_noise + kd, filled by the
            # integrator from its history ring (analysis/tran.py); the
            # collect_delay run records (u_now, td) for ring pushes/lookups
            x = _scalar(self.expr(args[0], env), name)
            td = _scalar(self.expr(args[1], env), "absdelay delay")
            if self.collect_delay:
                self.dly_rec[kd] = (x, td)
                return x
            mode = self.ctx.mode
            if mode in (Modes.DCOP, Modes.TRANOP):
                return x            # steady state: u(t−td) = u
            # TRAN: the integrator fills the aux from its history ring.
            # AC/noise: the analysis linearizes holding this aux fixed at
            # its op value and adds the EXACT e^{−jωtd} delay stamp
            # (analysis/ac._delay_ac) — small-signal absdelay without the
            # Padé approximation.
            return self.eps[it.n_noise + kd]
        kl = it.lat_site_ids.get(id(node))
        if kl is not None:
            return self._transition_latch(kl, args, env, node)
        k = it.lf_site_ids.get(id(node))
        if k is None:
            raise VACodegenError(f"{name}() site not registered")
        kind, off, n_st = it.lf_sites[k]
        base = it.n_nodes + it.n_vbranch + it.n_idt + off
        x = _scalar(self.expr(args[0], env), name)
        dc = self.ctx.mode in (Modes.DCOP, Modes.TRANOP)

        def ev(e_, what):
            return _scalar(self.expr(e_, env), what)

        if name in ("laplace_nd", "laplace_np", "laplace_zd", "laplace_zp"):
            if name in ("laplace_nd", "laplace_np"):
                num = [ev(c, name) for c in args[1][1]]
            else:
                num = _poly_from_pairs([ev(c, name) for c in args[1][1]])
            if name in ("laplace_nd", "laplace_zd"):
                den = [ev(c, name) for c in args[2][1]]
            else:
                den = _poly_from_pairs([ev(c, name) for c in args[2][1]])
            return self._lf_laplace(k, base, n_st, x, num, den, env)
        if name == "absdelay":
            if n_st == 0:            # statically-zero delay: identity
                return x
            td = ev(args[1], "absdelay delay")
            num, den = _pade_coeffs(td)
            return self._lf_laplace(k, base, n_st, x, num, den, env,
                                    degen=_degen_td(td))
        if name == "transition":
            i0, xd = 0, x
            if n_st > 1:             # Padé-delayed input block first
                td = ev(args[1], "transition delay")
                num, den = _pade_coeffs(td)
                xd = self._lf_laplace(k, base, _PADE_ORDER, x, num, den,
                                      env, degen=_degen_td(td))
                i0 = _PADE_ORDER
            rise = (ev(args[2], "transition rise") if len(args) > 2
                    else 1e-9)
            fall = (ev(args[3], "transition fall") if len(args) > 3
                    else rise)
            y = self.lv[base + i0]
            if dc:
                env[("LFROW", k, i0)] = (y - xd, None)
            else:
                # exponential edge shaping: τ = t_edge/ln(100) puts the
                # output within 1% of the target after rise/fall seconds
                # (a smooth stand-in for the LRM's linear ramp — there is
                # no event queue to latch ramp endpoints from)
                tau = jnp.where(xd > y, jnp.maximum(rise, 1e-15),
                                jnp.maximum(fall, 1e-15)) / 4.6051702
                env[("LFROW", k, i0)] = (-(xd - y) / tau, y)
            return y
        if name == "slew":
            if n_st == 0:            # no rate bounds: identity
                return x
            rp = ev(args[1], "slew rate")
            rn = ev(args[2], "slew rate") if len(args) > 2 else -rp
            y = self.lv[base]
            if dc:
                env[("LFROW", k, 0)] = (y - x, None)
            else:
                # bounded follower: tracks x within ~1 µV when unclamped,
                # slews at the rate bound otherwise (implicit methods eat
                # the stiffness; Newton sees a smooth clip)
                kgain = jnp.maximum(rp, -rn) * 1e6
                rate = jnp.clip(kgain * (x - y), rn, rp)
                env[("LFROW", k, 0)] = (-rate, y)
            return y
        if name == "idtmod":
            icval = ev(args[1], "idtmod ic") if len(args) > 1 else self.zero
            y = self.lv[base]
            if dc:
                env[("LFROW", k, 0)] = (y - icval, None)
            else:
                env[("LFROW", k, 0)] = (-x, y)
            if len(args) > 2:
                modulus = ev(args[2], "idtmod modulus")
                offset = (ev(args[3], "idtmod offset") if len(args) > 3
                          else self.zero)
                return y - modulus * jnp.floor((y - offset) / modulus)
            return y
        raise VACodegenError(f"unhandled filter operator {name}")

    def _callexpr(self, name, args, env, node=None):
        it = self.it
        if name == "V":
            a = self._node_v(args[0][1])
            if len(args) > 1:
                return a - self._node_v(args[1][1])
            if args[0][1] in self.it.ddx_probes:
                return (a, None, {args[0][1]: 1.0})
            return a
        if name == "I":
            nm = args[0][1] if args[0][0] == "ref" else None
            if nm in it.named_branch:
                pair = it.named_branch[nm]
                if pair in it.branch_index:
                    return self.lv[it.branch_index[pair]]
            raise VACodegenError(
                f"{it.module.name}: I() probe supported only on branches "
                "with V<+ contributions")
        if name == "ddt":
            v = _scalar(self.expr(args[0], env), "ddt argument")
            return (self.zero, v, None)
        if name == "ddx":
            val, d = _dual(self.expr(args[0], env))
            probe = args[1][2][0][1]
            if d is None or probe not in d:
                return self.zero
            return d[probe]
        if name in ("white_noise", "flicker_noise"):
            # lexical site identity by AST node (stable across both-branch
            # conditional evaluation)
            k = it.noise_site_ids.get(id(node), 0)
            pwr = _scalar(self.expr(args[0], env))
            if self.collect:
                while len(self.noise_pwr) <= k:
                    self.noise_pwr.append(self.zero)
                    self.noise_exp.append(self.zero)
                self.noise_pwr[k] = pwr
                if name == "flicker_noise" and len(args) > 1:
                    self.noise_exp[k] = _scalar(self.expr(args[1], env))
            n_eps = (len(self.eps) if isinstance(self.eps, (list, tuple))
                     else self.eps.shape[0])  # fused path passes a list
            if k < n_eps:
                return self.eps[k]
            return self.zero
        if name == "idt":
            k = it.idt_site_ids.get(id(node))
            if k is None:
                raise VACodegenError("idt() site not registered")
            arg = self.expr(args[0], env)
            icval = (_scalar(self.expr(args[1], env))
                     if len(args) > 1 else self.zero)
            env[("IDT", k)] = (arg, icval)
            row = it.n_nodes + it.n_vbranch + k
            return self.lv[row]
        if name in _LF_OPS:
            return self._lf_call(name, args, env, node)
        if name in ("zi_nd", "zi_np", "zi_zd", "zi_zp"):
            return self._zi_latch(name, args, env, node)
        if name == "noise_table":
            return self.zero
        if name == "analysis":
            mode = self.ctx.mode
            wanted = args[0][1] if args and args[0][0] == "str" else ""
            val = {
                "ic": mode in (Modes.DCOP, Modes.TRANOP),
                "dc": mode in (Modes.DCOP, Modes.TRANOP),
                "static": mode in (Modes.DCOP, Modes.TRANOP),
                "tran": mode == Modes.TRAN,
                "ac": mode == Modes.AC,
                "noise": mode == Modes.AC,
                "nodeset": False,
            }.get(wanted, False)
            return 1.0 if val else 0.0
        if name == "$temperature":
            return self.ctx.temp
        if name == "$vt":
            if args:
                t = _scalar(self.expr(args[0], env))
                return t * (1.380649e-23 / 1.602176634e-19)
            return self.ctx.vt
        if name == "$param_given":
            pn = args[0][1]
            key = pn + "$given"
            if key in self.p:
                return self.p[key]
            return 0.0
        if name == "$simparam":
            pname = args[0][1] if args and args[0][0] == "str" else ""
            if pname == "gmin":
                return self.ctx.gmin
            if pname in ("temp", "tnom"):
                return self.ctx.temp - 273.15
            if pname == "scale":
                return self.ctx.scale
            if pname == "sourceScaleFactor":
                return self.ctx.sourcefac
            if len(args) > 1:
                return _scalar(self.expr(args[1], env))
            return self.zero
        if name in ("$limit",):
            return self.expr(args[0], env)
        if name == "$abstime":
            return self.ctx.time
        if name in ("$port_connected",):
            return 1.0
        if name in _MATH1:
            raw = self.expr(args[0], env)
            v, d = _dual(raw)
            _scalar(raw, name)
            if _concrete(v) and d is None:
                return _HOST_MATH1[name](float(v))
            out = _MATH1[name](v)
            if d is not None and name in _DMATH1:
                return (out, None, _dscale(d, _DMATH1[name](v)))
            return out
        if name in _MATH2:
            v1 = _scalar(self.expr(args[0], env), name)
            v2 = _scalar(self.expr(args[1], env), name)
            if _concrete(v1, v2):
                return _HOST_MATH2[name](float(v1), float(v2))
            return _MATH2[name](v1, v2)
        if name in it.module.functions:
            return self._call_function(name, args, env)
        raise VACodegenError(
            f"{it.module.name}: unknown function {name!r}")

    def _call_function(self, name, args, env):
        fn: AnalogFunction = self.it.module.functions[name]
        fenv = {}
        for pname, a in zip(fn.inputs, args):
            fenv[pname] = self.expr(a, env)
        for ln in fn.locals_:
            fenv.setdefault(ln, self.zero)
        fenv.setdefault(fn.name, self.zero)
        for on in fn.outputs:
            fenv.setdefault(on, self.zero)
        for st in fn.body:
            self.stmt(st, fenv)
        # write back output args (must be plain variable refs at call site)
        n_in = len(fn.inputs)
        for k2, on in enumerate(fn.outputs):
            ai = n_in + k2
            if ai < len(args) and args[ai][0] == "ref":
                env[args[ai][1]] = fenv[on]
        return fenv[fn.name]


def load_va(text: str, file="<va>", include_paths=(), defines=(),
            **make_kwargs):
    """Parse + compile VA source → dict module-name → DeviceModel subclass
    (the equivalent of ``load_VA_model``,
    /root/reference/src/ModelLoader.jl:20).  ``defines`` predefines empty
    macros (compile-time model variants); extra keyword args pass
    through to ``make_device`` (delay_mode=, transition_mode=, ...)."""
    mods = parse_va(text, file, include_paths, defines=defines)
    return {m.name: make_device(m, **make_kwargs) for m in mods}

"""Netlist elaboration: SPICE AST → flat Circuit graph.

This replaces the reference's netlist→Julia codegen (``SpcScope`` walking the
CST and emitting macros/closures, /root/reference/src/spectre.jl:35-60,
825-966, 1233-1255): instead of generating code, we directly build the
circuit graph — subcircuits flatten with dotted prefixes, parameters resolve
through lexically-scoped lazy environments (the ``.param`` dependency
topological order falls out of lazy evaluation, cf. ``toposort``
spectre.jl:321-345), models merge into device parameter dicts, and ``m=``
multipliers compose down the hierarchy like ``ParallelInstances``
(/root/reference/src/simulate_ir.jl:56-75).

Re-elaboration with ``params={...}`` overrides is cheap (host-only graph
build), giving the ParamSim-style "netlist params as data" workflow.
"""

from __future__ import annotations

import math
import os
import warnings

import numpy as np

from cedarsim_tpu.core.circuit import Circuit, GROUND
from cedarsim_tpu.devices import (
    Resistor, Capacitor, Inductor, Diode, CoupledInductors,
    VSource, VSourcePWL, VSourcePULSE, VSourceSIN, VSourceEXP,
    ISource, ISourcePWL, ISourcePULSE, ISourceSIN, ISourceEXP,
    VCVS, VCCS, CCVS, CCCS, VSwitch, ISwitch, TLine, LTRALine,
)
from cedarsim_tpu.devices.mos import Mos1
from cedarsim_tpu.devices.bjt import Bjt
from cedarsim_tpu.devices.jfet import Jfet, Mesfet
from cedarsim_tpu.frontend import parser as P
from cedarsim_tpu.frontend.expr import eval_expr, expr_refs, ExprError


class ElabError(ValueError):
    def __init__(self, msg, loc: P.Loc = None):
        if loc is not None:
            msg = f"{loc.file}:{loc.line}: {msg}\n    {loc.src.strip()}"
        super().__init__(msg)


class ParamEnv:
    """Lexically-scoped lazy parameter environment with cycle detection —
    the dict-of-thunks equivalent of the reference's dynamically-scoped
    ``@requires`` free variables (/root/reference/src/spectre.jl:930-966)."""

    def __init__(self, parent=None, rng=None):
        self.exprs = {}
        self.cache = {}
        self.parent = parent
        self.rng = rng if rng is not None else (
            parent.rng if parent is not None else None)
        self._evaluating = set()

    def define(self, name, expr):
        name = name.lower()
        self.exprs[name] = expr
        self.cache.pop(name, None)

    def __contains__(self, name):
        name = name.lower()
        return (name in self.exprs
                or (self.parent is not None and name in self.parent))

    def __getitem__(self, name):
        name = name.lower()
        if name in self.cache:
            return self.cache[name]
        if name in self.exprs:
            if name in self._evaluating:
                raise ExprError(f"circular parameter definition: {name!r}")
            e = self.exprs[name]
            if isinstance(e, tuple) and e and e[0] == "funcdef":
                self.cache[name] = e
                return e
            if isinstance(e, (int, float)):
                v = float(e)
            else:
                self._evaluating.add(name)
                try:
                    v = eval_expr(e, self, self.rng)
                finally:
                    self._evaluating.discard(name)
            self.cache[name] = v
            return v
        if self.parent is not None:
            return self.parent[name]
        raise ExprError(f"undefined parameter {name!r}")

    def get(self, name, default=None):
        return self[name] if name in self else default


class _MismatchEnv(ParamEnv):
    """Per-instance parameter overlay for ``statistics { mismatch }``.

    A lookup of a mismatch-varied parameter returns a draw keyed on
    (mc_seed, instance path, parameter name); a lookup of any parameter
    whose definition *transitively references* a mismatch parameter pulls
    that definition down and re-evaluates it in this overlay, so derived
    parameters (``vth = vth0 + dvthmm``) decorrelate per instance too.
    Everything else delegates to the shared environment (keeping its
    global cache warm).  Reference role: per-instance ``agauss`` sampling
    from ``spec.rng`` (/root/reference/src/spectre_env.jl:178-187)."""

    def __init__(self, parent, elab, inst_name):
        super().__init__(parent=parent)
        self._elab = elab
        self._inst = inst_name

    def __getitem__(self, name):
        n = name.lower()
        if n in self.cache:
            return self.cache[n]
        if n not in self.exprs:
            el = self._elab
            if n in el.mismatch_vars and el.rng is not None:
                v = el._mismatch_draw(n, self._inst, self.parent)
                self.cache[n] = v
                return v
            if el.rng is not None and el._mismatch_dependent(n, self.parent):
                e = _find_param_expr(n, self.parent)
                if e is not None:
                    self.exprs[n] = e   # re-evaluate locally (below)
        return super().__getitem__(n)


def _find_param_expr(name, env):
    """Defining expression of ``name`` in the closest enclosing scope."""
    e = env
    while e is not None:
        if name in e.exprs:
            return e.exprs[name]
        e = e.parent
    return None


def _tiny_default(v, d):
    return d if v is None else v


class Elaborator:
    def __init__(self, include_paths=(), mc_seed=None, temp=27.0,
                 param_overrides=None):
        self.include_paths = [os.fspath(p) for p in include_paths]
        self.rng = (np.random.default_rng(mc_seed)
                    if mc_seed is not None else None)
        self.ckt = Circuit()
        self.globals = {"0", "gnd!", "vdd!", "vss!", "vcc!", "vee!"}
        self.warnings = []
        self.temp = temp
        self.param_overrides = {
            k.lower(): v for k, v in (param_overrides or {}).items()}
        self.mc_seed = mc_seed
        #: statistics-block mismatch registrations:
        #: name -> (dist, std_expr, percent, loc); consumed per instance
        #: by _MismatchEnv
        self.mismatch_vars = {}
        self._mm_dep_cache = {}

    # ---------------------------------------------------------------- utils

    def warn(self, msg, loc=None):
        if loc is not None:
            msg = f"{loc.file}:{loc.line}: {msg}"
        self.warnings.append(msg)
        warnings.warn(msg, stacklevel=2)

    def _resolve_file(self, path, loc):
        cands = [path]
        base = os.path.dirname(loc.file) if loc and os.path.isabs(
            loc.file) or (loc and os.sep in loc.file) else None
        if base:
            cands.append(os.path.join(base, path))
        for ip in self.include_paths:
            cands.append(os.path.join(ip, path))
        # in-tree vendored model sources last (.hdl "bsimcmg.va" just
        # works) — the analog of the reference's jlpkg:// package-model
        # resolution (/root/reference/src/spectre.jl:1276-1311)
        from cedarsim_tpu.models import MODEL_SEARCH_PATHS
        for ip in MODEL_SEARCH_PATHS:
            cands.append(os.path.join(ip, path))
        for cand in cands:
            if os.path.isfile(cand):
                return cand
        raise ElabError(f"include file not found: {path!r}", loc)

    def vres(self, v, env, loc):
        """Resolve a value (float or expression AST) in an environment."""
        if isinstance(v, (int, float)):
            return float(v)
        try:
            return float(eval_expr(v, env, self.rng))
        except ExprError as e:
            raise ElabError(str(e), loc)

    # -------------------------------------------------- mismatch statistics

    def _mismatch_draw(self, var, inst, env):
        """One per-instance draw for a ``statistics mismatch`` parameter,
        keyed deterministically on (mc_seed, instance path, name) so the
        same seed reproduces lane-for-lane while matched instances
        decorrelate."""
        import zlib
        dist, std_expr, percent, loc = self.mismatch_vars[var]
        nominal = float(env[var])     # process draws already applied here
        std = self.vres(std_expr, env, loc)
        if percent:
            std = abs(nominal) * std / 100.0
        seed = [0 if self.mc_seed is None else int(self.mc_seed) & 0xffffffff,
                zlib.crc32(inst.encode()), zlib.crc32(var.encode())]
        rng = np.random.default_rng(seed)
        if dist == "lnorm":
            return nominal * float(np.exp(rng.normal(0.0, std)))
        if dist in ("unif", "uniform"):
            return nominal + float(rng.uniform(-std, std))
        return nominal + float(rng.normal(0.0, std))

    def _mismatch_dependent(self, name, env, _seen=None):
        """Does ``name``'s definition transitively reference a mismatch-
        varied parameter?  Memoized on (defining scope, name)."""
        if not self.mismatch_vars:
            return False
        e = env
        while e is not None and name not in e.exprs:
            e = e.parent
        if e is None:
            return False
        key = (id(e), name)
        hit = self._mm_dep_cache.get(key)
        if hit is not None:
            return hit
        expr = e.exprs[name]
        if isinstance(expr, (int, float)) or (
                isinstance(expr, tuple) and expr and expr[0] == "funcdef"):
            self._mm_dep_cache[key] = False
            return False
        _seen = _seen or set()
        if key in _seen:
            return False                      # cycle guard
        _seen.add(key)
        dep = False
        for r in expr_refs(expr):
            if r in self.mismatch_vars:
                dep = True
                break
            if self._mismatch_dependent(r, e, _seen):
                dep = True
                break
        self._mm_dep_cache[key] = dep
        return dep

    # ------------------------------------------------------------ main walk

    def run(self, netlist: P.SpiceNetlist) -> Circuit:
        self.ckt.title = netlist.title
        env = ParamEnv(rng=self.rng)
        env.define("$temp", self.temp)
        scope = dict(models={}, subckts={}, env=env)
        elements = []
        self._collect(netlist.statements, scope, elements)
        # user overrides win over netlist .param values
        for k, v in self.param_overrides.items():
            env.define(k, float(v))
        kcards = []
        for el, sc in elements:
            if el.letter == "k":
                kcards.append((el, sc))
                continue
            self._instantiate(el, sc, prefix="", nodemap={}, mfac=1.0)
        for el, sc in kcards:
            self._apply_coupling(el, sc)
        return self.ckt

    def _collect(self, stmts, scope, elements):
        """Sequential definition pass: params/models/subckts register, includes
        splice, .if branches resolve; element cards queue for pass 2."""
        env = scope["env"]
        for st in stmts:
            if isinstance(st, P.Param):
                for name, expr in st.assignments:
                    env.define(name, expr)
            elif isinstance(st, P.Model):
                scope["models"][st.name] = st
            elif isinstance(st, P.Subckt):
                scope["subckts"][st.name] = (st, scope)
            elif isinstance(st, P.Include):
                self._do_include(st, scope, elements)
            elif isinstance(st, P.LibSection):
                scope.setdefault("libsections", {})[st.name] = st
            elif isinstance(st, P.IfBlock):
                taken = None
                for cond, body in st.branches:
                    if cond is None or bool(self.vres(cond, env, st.loc)):
                        taken = body
                        break
                if taken:
                    self._collect(taken, scope, elements)
            elif isinstance(st, P.Control):
                self._do_control(st, scope)
            elif isinstance(st, P.Element):
                elements.append((st, scope))
            else:
                self.warn(f"ignored statement {type(st).__name__}", st.loc)

    def _do_include(self, st: P.Include, scope, elements):
        path = self._resolve_file(st.path, st.loc)
        with open(path, "r", errors="replace") as f:
            text = f.read()
        if path.lower().endswith(".scs"):
            # Spectre-dialect include (e.g. the ASAP7 ``7nm_TT.scs`` model
            # deck): parse with the Spectre grammar — the reference reaches
            # the same behavior through ``simulator lang=`` re-entry
            # (spectre.jl:1365-1527); ``.scs`` is Spectre's canonical
            # extension and such decks carry no lang pragma of their own
            from cedarsim_tpu.frontend.spectre import parse_mixed
            sub = parse_mixed(text, file=path, start_lang="spectre")
        else:
            sub = P.SpiceParser(text, file=path, title_line=False).parse()
        stmts = sub.statements
        if st.section is not None:
            sections = {}
            for s in stmts:
                if isinstance(s, P.LibSection):
                    sections[s.name.lower()] = s
            sec = sections.get(st.section.lower())
            if sec is None:
                raise ElabError(
                    f"section {st.section!r} not found in {path!r}", st.loc)
            stmts = sec.body
        self._collect(stmts, scope, elements)

    def _do_control(self, st: P.Control, scope):
        env = scope["env"]
        if st.cmd == "statistics":
            self._do_statistics(st, scope)
            return
        if st.cmd == "funcdecl":
            # Spectre user-defined function (reference FunctionDecl,
            # forms.jl:145): registered in the lexical param scope; called
            # from expressions via eval_expr's funcdef dispatch
            name, args, body = st.args
            env.define(name.lower() + "()", ("funcdef", list(args), body))
            return
        if st.cmd in ("ic", "nodeset"):
            for node, v in st.kwargs.items():
                val = self.vres(v, env, st.loc)
                if st.cmd == "ic":
                    self.ckt.ic(node.lower(), val)
                else:
                    self.ckt.nodesets[node.lower()] = val
            return
        if st.cmd == "global":
            for n in st.args:
                self.globals.add(n.lower())
            return
        if st.cmd == "option":
            for k, v in st.kwargs.items():
                if isinstance(v, (int, float)):
                    self.ckt.options[k] = float(v)
                    continue
                try:
                    self.ckt.options[k] = self.vres(v, env, st.loc)
                except ElabError:
                    # word-valued options (ngspice: method=gear|trap) keep
                    # the raw identifier; anything non-word still errors
                    if isinstance(v, tuple) and len(v) == 2 \
                            and v[0] in ("w", "ref") \
                            and isinstance(v[1], str):
                        self.ckt.options[k] = v[1].lower()
                    else:
                        raise
            return
        if st.cmd == "temp":
            if st.args:
                self.ckt.options["temp"] = self.vres(
                    P._val(("w", st.args[0]), st.loc), env, st.loc) \
                    if isinstance(st.args[0], str) else float(st.args[0])
            return
        if st.cmd in ("tran", "dc", "ac", "op", "noise", "four"):
            args = []
            for a in st.args:
                if isinstance(a, str):
                    from cedarsim_tpu.frontend.numbers import parse_number
                    n = parse_number(a)
                    args.append(n if n is not None else a)
                else:
                    args.append(a)
            self.ckt.directives.append((st.cmd, args, {
                k: (self.vres(v, env, st.loc)
                    if not isinstance(v, (int, float)) else float(v))
                for k, v in st.kwargs.items()}))
            return
        if st.cmd == "alterstmt":
            # device-targeted alter (a1 alter dev=r1 param=r value=2k):
            # recorded as a directive, applied per analysis segment in
            # api.simulate via set_param
            kw = {}
            for k, v in st.kwargs.items():
                if k in ("dev", "param"):
                    kw[k] = (v[1] if isinstance(v, tuple) and v
                             and v[0] == "ref" else str(v))
                else:
                    kw[k] = (self.vres(v, env, st.loc)
                             if not isinstance(v, (int, float))
                             else float(v))
            self.ckt.directives.append(("alterstmt", list(st.args), kw))
            return
        if st.cmd in ("hdl", "va"):
            from cedarsim_tpu.va.codegen import load_va
            path = self._resolve_file(st.args[0].strip('"'), st.loc)
            with open(path, "r", errors="replace") as f:
                mods = load_va(f.read(), path,
                               include_paths=self.include_paths)
            vam = scope.setdefault("va_modules", {})
            for name, cls in mods.items():
                vam[name.lower()] = cls
            return
        if st.cmd == "data":
            name, cols, vals = st.args
            ncol = max(len(cols), 1)
            rows = [vals[i:i + ncol] for i in range(0, len(vals), ncol)
                    if len(vals[i:i + ncol]) == ncol]
            self.ckt.directives.append(
                ("data", [name, cols, rows], {}))
            return
        if st.cmd in ("meas", "measure"):
            self.ckt.directives.append(("meas", [st.loc.src], {}))
            return
        if st.cmd in ("save", "probe"):
            # waveform projection (ngspice .save/.probe): record the probe
            # targets; api.simulate turns them into TranOptions.store_vars.
            # The card lexer splits "v(q)" into ["v", "q"], so a bare
            # v/i token prefixes its target.
            targets = []
            toks = [a for a in st.args if isinstance(a, str)]
            i = 0
            while i < len(toks):
                t = toks[i].lower()
                if t in ("v", "i") and i + 1 < len(toks):
                    tgt = toks[i + 1].lower()
                    targets.append(tgt if t == "v" else tgt + ".i")
                    i += 2
                    continue
                targets.append(t)
                i += 1
            self.ckt.directives.append(("save", targets, {}))
            return
        if st.cmd in ("print", "plot", "width", "end", "backanno", "temp"):
            return  # stored/no-op for now
        self.warn(f"unhandled directive .{st.cmd}", st.loc)

    # -------------------------------------------------------------- devices

    def _net(self, name, prefix, nodemap):
        n = name.lower()
        if n in nodemap:
            return nodemap[n]
        if n in ("0", "gnd", "gnd!", "ground"):
            return GROUND
        if n in self.globals or n.endswith("!"):
            return self.ckt.net(n)
        return self.ckt.net(prefix + n)

    def _model(self, name, scope, loc, l=None, w=None, env=None):
        """Resolve a model by name; models named ``base.N`` are bins selected
        by instance L/W against their LMIN/LMAX/WMIN/WMAX (reference
        BinnedModel/find_bin, /root/reference/src/spectre.jl:677,718-736,
        1162-1176 — selection at instantiation, fully static thereafter)."""
        n = name.lower()
        sc = scope
        while sc is not None:
            if n in sc["models"]:
                return sc["models"][n]
            bins = [m for key, m in sc["models"].items()
                    if key.startswith(n + ".")]
            if bins:
                if l is None or w is None:
                    return bins[0]
                scale = self.ckt.options.get("scale", 1.0)
                for m in bins:
                    def g(pname, d):
                        v = m.params.get(pname)
                        return d if v is None else self.vres(v, env, loc)
                    lmin, lmax = g("lmin", 0.0), g("lmax", 1.0)
                    wmin, wmax = g("wmin", 0.0), g("wmax", 1.0)
                    if lmin <= l * scale < lmax and wmin <= w * scale < wmax:
                        return m
                raise ElabError(
                    f"no bin of model {name!r} covers l={l:g} w={w:g}", loc)
            sc = sc.get("parent")
        raise ElabError(f"model {name!r} not found", loc)

    def _subckt(self, name, scope, loc):
        n = name.lower()
        sc = scope
        while sc is not None:
            if n in sc["subckts"]:
                return sc["subckts"][n]
            sc = sc.get("parent")
        return None

    def _instantiate(self, el: P.Element, scope, prefix, nodemap, mfac):
        env = scope["env"]
        name = prefix + el.name.lower()
        if self.mismatch_vars and self.rng is not None:
            # per-instance mismatch overlay: this instance's parameter
            # expressions see instance-keyed draws for mismatch-varied
            # params (and re-evaluate anything derived from them)
            env = _MismatchEnv(env, self, name)
            scope = dict(scope, env=env)
        nets = [self._net(n, prefix, nodemap) for n in el.nodes]
        letter = el.letter
        if letter == "b":
            mv = el.params.get("m", 1.0)
            m = mfac * (self.vres(mv, env, el.loc)
                        if not isinstance(mv, (int, float)) else float(mv))
            self._instantiate_bsource(el, name, nets, env, m, prefix, nodemap)
            return
        if letter == "sparam":
            self._instantiate_sparam(el, name, nets, scope)
            return
        kw = {k: self.vres(v, env, el.loc) for k, v in el.params.items()}
        m = mfac * kw.pop("m", 1.0)

        def val(i, default=None):
            if i < len(el.values):
                return self.vres(el.values[i], env, el.loc)
            return default

        if letter == "x":
            self._instantiate_subckt(el, scope, prefix, nodemap, m, kw)
            return
        if letter == "r":
            p = {}
            mp = {}
            if el.model is not None:
                mdl = self._model(el.model, scope, el.loc)
                mp = {k: self.vres(v, env, el.loc)
                      for k, v in mdl.params.items()}
            for src in (mp, kw):
                for k, v in src.items():
                    if k in ("r", "res", "resistance"):
                        p["r"] = v
                    elif k in ("rsh",):
                        p["rsh"] = v
                    elif k in ("w", "l", "narrow", "short"):
                        p[k] = v
                    elif k in ("tc1", "tc2", "tnom"):
                        p[k] = v
                    elif k == "tc":
                        p["tc1"] = v
            if "r" not in p and el.values:
                p["r"] = val(0)
            self.ckt.add(Resistor, name, nets, p, m=m)
            return
        if letter == "c":
            c = kw.get("c", val(0))
            if c is None and el.model is not None:
                mdl = self._model(el.model, scope, el.loc)
                c = self.vres(mdl.params.get("c", 0.0), env, el.loc)
            self.ckt.add(Capacitor, name, nets, dict(c=c or 0.0), m=m)
            if "ic" in kw:
                self.ckt.ic(nets[0].name, kw["ic"])
            return
        if letter == "l":
            self.ckt.add(Inductor, name, nets,
                         dict(l=kw.get("l", val(0, 0.0))), m=m)
            return
        if letter in ("v", "i"):
            self._instantiate_source(el, name, nets, kw, env, m)
            return
        if letter == "d":
            mdl = self._model(el.model, scope, el.loc)
            p = self._map_params(Diode, mdl.params, env, el.loc,
                                 rename={"cjo": "cj0", "mj": "m",
                                         "nj": "n", "af": None, "kf": None,
                                         "rs": None})
            area = kw.get("area", val(0, 1.0))
            p["area"] = area if area is not None else 1.0
            self.ckt.add(Diode, name, nets, p, m=m)
            return
        if letter == "m":
            mdl = self._model(el.model, scope, el.loc,
                              l=kw.get("l"), w=kw.get("w"), env=env)
            polarity, level = self._mos_kind(mdl, env, el.loc)
            if level in (8.0, 14.0, 49.0, 53.0, 54.0):
                # reference level table: 14/54 -> bsim4 (spectre.jl:599-607);
                # BSIM3-class levels 8/49/53 share the core via aliases
                self._instantiate_bsim4(el, name, nets, kw, mdl, env, m,
                                        polarity)
                return
            if level in (17.0, 72.0):
                # BSIM-CMG (reference: level 17/72 -> bsimcmg107,
                # spectre.jl:599-607; the ASAP7 decks' path)
                self._instantiate_cmg(el, name, nets, kw, mdl, env, m,
                                      polarity)
                return
            if level not in (1.0,):
                self.warn(f"MOS level {level:g} not built in yet; using "
                          "level 1", el.loc)
            p = self._map_params(Mos1, mdl.params, env, el.loc,
                                 rename={"lambda": "lam", "tnom": None,
                                         "lmin": None, "lmax": None,
                                         "wmin": None, "wmax": None,
                                         "level": None, "cj": None,
                                         "cjsw": None, "js": None,
                                         "mjsw": None, "kf": None,
                                         "af": None, "tpg": None,
                                         "nss": None, "nfs": None,
                                         "xj": None, "uexp": None,
                                         "ucrit": None, "utra": None,
                                         "neff": None, "delta": None,
                                         "vmax": None, "theta": None,
                                         "eta": None, "kappa": None})
            p["ptype"] = 1.0 if polarity == "nmos" else -1.0
            for k in ("w", "l"):
                if k in kw:
                    p[k] = kw[k]
            self.ckt.add(Mos1, name, nets, p, m=m)
            return
        if letter == "q":
            mdl = self._model(el.model, scope, el.loc)
            lvl = self.vres(mdl.params.get("level", 1.0), env, el.loc)
            if mdl.mtype == "vbic" or lvl in (4.0, 9.0):
                # ngspice/hspice select VBIC at BJT level 4 (and 9); the
                # reference instantiates UnimplementedDevice for every
                # non-GP BJT (spectre.jl:606-630) — functional here via the
                # in-tree VBIC-class VA model
                self._instantiate_vbic(el, name, nets, kw, mdl, env, m,
                                       val)
                return
            p = self._map_params(Bjt, mdl.params, env, el.loc,
                                 rename={"tnom": None, "xtb": None,
                                         "xti": None, "eg": None,
                                         "rb": None, "rc": None, "re": None,
                                         "irb": None, "rbm": None,
                                         "xtf": None, "vtf": None,
                                         "itf": None, "ptf": None,
                                         "kf": None, "af": None,
                                         "xcjc": None})
            p["ptype"] = 1.0 if mdl.mtype == "npn" else -1.0
            p["area"] = kw.get("area", val(0, 1.0)) or 1.0
            while len(nets) < 4:
                nets.append(GROUND)
            self.ckt.add(Bjt, name, nets, p, m=m)
            return
        if letter in ("j", "z"):
            # JFET (njf/pjf) and MESFET (nmf/pmf): the reference parses
            # these cards but implements no device (spectre.jl:606-630
            # UnimplementedDevice) — fully functional here
            mdl = self._model(el.model, scope, el.loc)
            dev = Jfet if letter == "j" else Mesfet
            want = ("njf", "pjf") if letter == "j" else ("nmf", "pmf")
            if mdl.mtype not in want:
                raise ElabError(
                    f"{el.name}: expected a {'/'.join(want)} model, got "
                    f"{mdl.mtype!r}", el.loc)
            p = self._map_params(dev, mdl.params, env, el.loc,
                                 rename={"lambda": "lam", "kf": None,
                                         "af": None, "tnom": None,
                                         "vtotc": None, "betatce": None,
                                         "vk": None, "tau": None})
            area = kw.get("area", val(0, 1.0)) or 1.0
            for k in ("beta", "is", "cgs", "cgd"):
                p[k] = p.get(k, dev.params[k]) * area
            p["ptype"] = 1.0 if mdl.mtype in ("njf", "nmf") else -1.0
            self.ckt.add(dev, name, nets, p, m=m)
            return
        if letter == "e":
            self.ckt.add(VCVS, name, nets, dict(gain=kw.get("gain", val(0))),
                         m=m)
            return
        if letter == "g":
            self.ckt.add(VCCS, name, nets, dict(gm=kw.get("gm", val(0))), m=m)
            return
        if letter == "t":
            # lossless transmission line: Tname p1 n1 p2 n2 Z0= TD= (or
            # F= [NL=], td = nl/f; ngspice/hspice card).  Exact Branin
            # method-of-characteristics device (devices/simple.py::TLine).
            z0 = kw.get("z0", kw.get("zo", 50.0))
            td = kw.get("td")
            if td is None:
                f = kw.get("f")
                if f is None:
                    raise ElabError(
                        f"{el.name}: transmission line needs TD= or F= "
                        "(+ optional NL=)", el.loc)
                if f <= 0:
                    raise ElabError(f"{el.name}: F={f} must be positive",
                                    el.loc)
                td = kw.get("nl", 0.25) / f
            if td <= 0 or z0 <= 0:
                raise ElabError(
                    f"{el.name}: transmission line needs TD > 0 and Z0 > 0 "
                    f"(got td={td}, z0={z0})", el.loc)
            self.ckt.add(TLine, name, nets, dict(z0=z0, td=td), m=m)
            return
        if letter == "o":
            self._instantiate_ltra(el, name, nets, scope, env, m)
            return
        if letter == "u":
            self._instantiate_urc(el, name, nets, scope, env, kw, m)
            return
        if letter == "s":
            mdl = self._model(el.model, scope, el.loc)
            pr = self._map_params(VSwitch, mdl.params, env, el.loc)
            self.ckt.add(VSwitch, name, nets, pr, m=m)
            return
        if letter == "w":
            # card: Wname n+ n- Vctrl model — the parser's model slot holds
            # Vctrl; the model name is the following bare word
            ctrl = prefix + el.model.lower() if el.model else None
            mname = None
            for v in el.values:
                if isinstance(v, tuple) and v[0] == "ref":
                    mname = v[1]
            if ctrl is None or mname is None:
                raise ElabError(f"{el.name}: W needs a control V-source and "
                                "a model", el.loc)
            mdl = self._model(mname, scope, el.loc)
            pr = self._map_params(ISwitch, mdl.params, env, el.loc)
            self.ckt.add(ISwitch, name, nets, pr, m=m, ctrl=ctrl)
            return
        if letter in ("f", "h"):
            ctrl = prefix + el.model.lower() if el.model else None
            if ctrl is None:
                raise ElabError(f"{el.name}: missing control source", el.loc)
            if letter == "f":
                self.ckt.add(CCCS, name, nets, dict(f=val(0, 1.0)), m=m,
                             ctrl=ctrl)
            else:
                self.ckt.add(CCVS, name, nets, dict(r=val(0, 1.0)), m=m,
                             ctrl=ctrl)
            return
        if el.letter == "osdi":
            raise ElabError(
                f"{el.name}: OSDI compiled-binary models are not supported — "
                "load the model's Verilog-A source instead (`.hdl "
                "\"model.va\"` / ahdl_include), which compiles through the "
                "native VA→JAX pipeline", el.loc)
        raise ElabError(
            f"device type {el.letter.upper()!r} not implemented yet "
            f"({el.name})", el.loc)

    def _instantiate_ltra(self, el, name, nets, scope, env, m):
        """O element — lossy transmission line with an LTRA model card
        (``.model mname LTRA R= L= G= C= LEN=``).  The reference lexes the
        O letter (SPICE/tokenize/lexer.jl:581) but has no runtime for it;
        here it is fully functional.  Dispatch by which per-length
        constants are present, mirroring ngspice's LTRA cases:

        * L>0 and C>0 (LC / RLC / RLCG): cascade of ``LTRALine`` lossy
          method-of-characteristics sections — K sections sized so each
          carries a small fraction of the total loss (K=1 for lossless ==
          exact Branin).  DC series resistance exact, AC exact (cascade of
          exact RLCG two-ports), transient converges with K.
        * C>0, L=0 (RC diffusion line): lumped RC ladder (trapezoidal
          shunt lumping; what ngspice models by convolution).
        * G>0, L=0=C (RG): resistive ladder.
        * R only: a plain series resistor.
        """
        if el.model is None:
            raise ElabError(f"{el.name}: O element needs an LTRA model",
                            el.loc)
        mdl = self._model(el.model, scope, el.loc)
        mp = {k: self.vres(v, env, el.loc) for k, v in mdl.params.items()}
        r = float(mp.get("r", 0.0))
        l = float(mp.get("l", 0.0))
        g = float(mp.get("g", 0.0))
        c = float(mp.get("c", 0.0))
        length = float(mp.get("len", mp.get("length", 1.0)))
        if length <= 0:
            raise ElabError(f"{el.name}: LTRA LEN must be positive", el.loc)
        rtot, ltot, gtot, ctot = (r * length, l * length,
                                  g * length, c * length)
        p1, n1, p2, n2 = nets
        if ltot > 0.0 and ctot > 0.0:
            z0 = math.sqrt(ltot / ctot)
            # per-section loss budget: keep R/(2Z0)+G·Z0/2 ≤ ~0.1 per
            # section so the MoC attenuation+lump approximation holds
            loss = rtot / (2.0 * z0) + gtot * z0 / 2.0
            k = max(1, min(32, math.ceil(loss / 0.1)))
            # interior junction reference collapses onto the port-1
            # reference net: the reference conductor is ideal (carries no
            # impedance), and separate chained reference nets would leave
            # each junction's common mode floating (x/y KCL rows of a
            # differential two-port are redundant -> singular matrix)
            xa = p1
            for i in range(k):
                last = i == k - 1
                xb = p2 if last else self.ckt.net(f"{name}#x{i + 1}")
                self.ckt.add(LTRALine, f"{name}#s{i + 1}" if k > 1 else name,
                             [xa, n1, xb, n2 if last else n1],
                             dict(rtot=rtot / k, ltot=ltot / k,
                                  gtot=gtot / k, ctot=ctot / k), m=m)
                xa = xb
            return
        if ctot > 0.0 or gtot > 0.0:
            # diffusion (RC) / leaky (RG/RCG) line: lumped ladder
            nseg = max(3, min(50, math.ceil(10.0 * max(
                1.0, math.log10(max(rtot * ctot * 1e9, 1.0) + 1.0)))))
            self._ladder(name, nets, rtot, ctot, gtot, nseg, m)
            return
        # series R only (degenerate)
        self.ckt.add(Resistor, name, [p1, p2], dict(r=max(rtot, 1e-12)),
                     m=m)
        if not (n1.is_ground and n2.is_ground) and n1.name != n2.name:
            self.warn(f"{el.name}: R-only LTRA ignores the reference "
                      "conductor terminals", el.loc)

    def _ladder(self, name, nets, rtot, ctot, gtot, nseg, m,
                weights=None, shunt=None):
        """Uniform (or weighted) lumped ladder between nets (p1,n1,p2,n2)
        or (n1,n2,ncommon): series R splits with shunt C and/or G at the
        interior junctions (trapezoidal end lumps — total series R and
        total shunt C/G are exact).  ``shunt(j, frac)`` may be passed to
        instantiate a custom shunt element (URC's diode variant)."""
        if len(nets) == 4:
            p1, n1, p2, n2 = nets
            ref = lambda i: n1 if (i <= nseg // 2) else n2  # noqa: E731
        else:
            p1, p2, ncom = nets
            ref = lambda i: ncom  # noqa: E731
        w = list(weights) if weights is not None else [1.0 / nseg] * nseg
        tot = sum(w)
        w = [x / tot for x in w]
        # junction nodes j_0=p1 .. j_nseg=p2; series resistor i spans
        # (j_i, j_{i+1}); shunt fraction at junction i = (w[i-1]+w[i])/2
        # with half-lumps at the ends
        prev = p1
        for i in range(nseg + 1):
            frac = ((w[i - 1] if i > 0 else 0.0)
                    + (w[i] if i < nseg else 0.0)) / 2.0
            node = prev
            if shunt is not None:
                shunt(i, node, ref(i), frac)
            else:
                if ctot > 0.0:
                    self.ckt.add(Capacitor, f"{name}#c{i}", [node, ref(i)],
                                 dict(c=ctot * frac), m=m)
                if gtot > 0.0:
                    self.ckt.add(Resistor, f"{name}#g{i}", [node, ref(i)],
                                 dict(r=1.0 / (gtot * frac)), m=m)
            if i < nseg:
                nxt = (self.ckt.net(f"{name}#j{i + 1}") if i < nseg - 1
                       else p2)
                self.ckt.add(Resistor, f"{name}#r{i}", [prev, nxt],
                             dict(r=max(rtot * w[i], 1e-12)), m=m)
                prev = nxt

    def _instantiate_urc(self, el, name, nets, scope, env, kw, m):
        """U element — uniform distributed RC line (ngspice URC; the
        reference lexes the U letter, SPICE/tokenize/lexer.jl:599-600, with
        no runtime).  ``Uname n1 n2 ncommon mname L=len [N=segs]`` with
        ``.model mname URC (K= FMAX= RPERL= CPERL= ISPERL= RSPERL=)``.
        Expanded at elaboration into a ladder of N segments whose widths
        grade geometrically (ratio K) toward the middle — fine resolution
        at the ends where step-response gradients are steepest.  If
        ISPERL is given the shunt capacitors become reverse-biased
        junction diodes with proportional saturation current and junction
        capacitance (ngspice semantics)."""
        if el.model is None:
            raise ElabError(f"{el.name}: U element needs a URC model",
                            el.loc)
        mdl = self._model(el.model, scope, el.loc)
        mp = {kk: self.vres(v, env, el.loc) for kk, v in mdl.params.items()}
        kfac = float(mp.get("k", 2.0))
        fmax = float(mp.get("fmax", 1e9))
        rperl = float(mp.get("rperl", 1000.0))
        cperl = float(mp.get("cperl", 1e-12))
        isperl = float(mp.get("isperl", 0.0))
        rsperl = float(mp.get("rsperl", 0.0))
        length = float(kw.get("l", 0.0) or 0.0)
        if length <= 0:
            raise ElabError(f"{el.name}: URC needs L= (line length)", el.loc)
        rtot, ctot = rperl * length, cperl * length
        nseg = kw.get("n")
        if nseg is None:
            # ngspice's segment-count rule: enough segments that the
            # smallest (end) lump resolves FMAX
            arg = (fmax * rtot * ctot * 2.0 * math.pi
                   * ((kfac - 1.0) / kfac) ** 2)
            nseg = max(3, min(64, math.ceil(math.log(max(arg, 2.0))
                                            / math.log(max(kfac, 1.1)))))
        else:
            nseg = max(1, min(64, int(nseg)))
        # symmetric geometric grading: widths ∝ K^min(i, n-1-i)
        w = [kfac ** min(i, nseg - 1 - i) for i in range(nseg)]
        if isperl <= 0.0:
            self._ladder(name, nets, rtot, ctot, 0.0, nseg, m, weights=w)
            return

        def shunt(i, node, ref, frac):
            if frac <= 0.0:
                return
            p = {"is": isperl * length * frac, "cj0": ctot * frac}
            if rsperl > 0.0:
                # RSPERL is Ω·m: series resistance of the lump's diode
                mid = self.ckt.net(f"{name}#d{i}m")
                self.ckt.add(Resistor, f"{name}#rs{i}", [node, mid],
                             dict(r=rsperl / (length * frac)), m=m)
                node = mid
            # anode at the common node: reverse-biased for a positive
            # line voltage (the URC junction-isolation assumption)
            self.ckt.add(Diode, f"{name}#d{i}", [ref, node], p, m=m)

        self._ladder(name, nets, rtot, ctot, 0.0, nseg, m, weights=w,
                     shunt=shunt)

    def _instantiate_sparam(self, el, name, nets, scope):
        """hspice S-element (reference SParameterElement, SPICE/parse/
        forms.jl:411-418): port k is (nets[k], ground); the port S-matrix
        comes from a touchstone file named by the model card's
        file=/tstonefile= parameter.  Converted once to port admittances
        Y(f); applied as frequency-dependent stamps by AC/noise analyses.
        Open at DC/transient (documented; gmin keeps the matrix regular)."""
        from cedarsim_tpu.frontend.touchstone import (
            parse_touchstone, s_to_y, nports_from_name, TouchstoneError)
        if el.model is None:
            raise ElabError(f"{el.name}: S-element requires a model card "
                            "naming the touchstone file", el.loc)
        mdl = self._model(el.model, scope, el.loc)
        raw = None
        for src in (mdl.params, el.params):
            for k in ("file", "tstonefile", "sfile"):
                if k in src and raw is None:
                    raw = src[k]
        if raw is None:
            raise ElabError(f"{el.name}: model {el.model!r} has no "
                            "file=/tstonefile= parameter", el.loc)
        path = raw[1] if isinstance(raw, tuple) and len(raw) > 1 else raw
        path = str(path).strip("\"'")
        path = self._resolve_file(path, el.loc)
        with open(path) as f:
            text = f.read()
        try:
            freqs, S, z0 = parse_touchstone(text, nports_from_name(path))
        except TouchstoneError as e:
            raise ElabError(f"{el.name}: bad touchstone file {path!r}: {e}",
                            el.loc)
        import numpy as _np
        if S.shape[-1] != len(nets):
            raise ElabError(
                f"{el.name}: {S.shape[-1]}-port data but {len(nets)} "
                "element nodes", el.loc)
        Y = s_to_y(S, z0)
        self.ckt.sparam_blocks.append((name, list(nets), _np.asarray(freqs),
                                       Y))

    #: Spectre MOS master name -> equivalent SPICE level (reference
    #: spice_select_device inverse, spectre.jl:589-630)
    _SPECTRE_MOS_LEVEL = {"bsim4": 54.0, "bsim3v3": 49.0, "bsim3": 49.0,
                          "bsimcmg": 72.0, "bsimcmg107": 72.0,
                          "mos1": 1.0, "mos902": 1.0, "mos0": 1.0}

    def _mos_kind(self, mdl, env, loc):
        """Normalize a MOS model statement to (polarity, level): SPICE cards
        carry nmos/pmos + level=, Spectre cards carry the master name +
        type=n/p."""
        t = mdl.mtype
        if t in ("nmos", "pmos"):
            return t, self.vres(mdl.params.get("level", 1.0), env, loc)
        if t in self._SPECTRE_MOS_LEVEL:
            ty = mdl.params.get("type")
            if isinstance(ty, tuple) and ty and ty[0] == "ref":
                ty = ty[1]
            pol = "pmos" if str(ty).lower().startswith("p") else "nmos"
            return pol, self._SPECTRE_MOS_LEVEL[t]
        raise ElabError(f"model {mdl.name!r}: unknown MOS model kind {t!r}",
                        loc)

    def _instantiate_bsim4(self, el, name, nets, kw, mdl, env, m, polarity):
        """BSIM4-class MOSFET from a `.model level=8/14/49/53/54` card.
        Model-card parameters map case-insensitively onto the VA module's
        parameters (the reference's case_adjust_kwargs role, spectre.jl:
        1113-1149); names the core does not implement are collected into one
        warning instead of failing the card."""
        from cedarsim_tpu.models import bsim4_class
        # RDSMOD selects a compile-time model variant (internal diffusion
        # nodes only exist for rdsMod=1 cards), so it must resolve here
        rdsmod = 0
        if "rdsmod" in mdl.params:
            rdsmod = int(self.vres(mdl.params["rdsmod"], env, el.loc))
            if rdsmod not in (0, 1):
                self.warn(f"bsim4 model {el.model!r}: RDSMOD={rdsmod} not "
                          "supported (0/1); using 0", el.loc)
                rdsmod = 0
        cls = bsim4_class(rdsmod)
        p = {"TYPE": 1.0 if polarity == "nmos" else -1.0}
        ignored = []
        bin_corr = {}          # base param -> {'l': LP, 'w': WP, 'p': PP}

        def take(k, v):
            kl = k.lower()
            actual = cls.param_lower.get(kl)
            if actual is not None:
                p[actual] = v
                return
            # L/W/P binning corrections (real binned libraries: every
            # binnable parameter P carries lP/wP/pP geometry-dependence
            # coefficients; the reference's BSIM4.jl implements these
            # natively and test/binning/bins.cir leans on them — dropping
            # lvth0 alone mis-biases Vth by >100 mV on that lib).  Full
            # core names take precedence above (lw/wl/pclm are real
            # geometry/model params, not corrections of w/l/clm).
            if kl[:1] in ("l", "w", "p"):
                base = cls.param_lower.get(kl[1:])
                if base is not None:
                    bin_corr.setdefault(base, {})[kl[0]] = float(v)
                    return
            ignored.append(k)

        for k, v in mdl.params.items():
            if k in ("level", "version", "type"):
                continue
            take(k, self.vres(v, env, el.loc))
        for k, v in kw.items():
            take(k, v)
        if bin_corr:
            self._apply_bsim4_binning(cls, p, bin_corr)
        if ignored:
            self.warn(f"bsim4 model {el.model!r}: ignoring unsupported "
                      f"parameter(s) {sorted(set(ignored))}", el.loc)
        while len(nets) < 4:
            nets.append(nets[-1])
        self.ckt.add(cls, name, nets[:4], p, m=m)

    def _instantiate_cmg(self, el, name, nets, kw, mdl, env, m, polarity):
        """BSIM-CMG FinFET from a ``.model level=17/72`` card or a Spectre
        ``bsimcmg`` master (e.g. the ASAP7 7nm TT decks).  Card parameters
        map case-insensitively onto the vendored CMC bsimcmg107 module's
        parameters; ``type``/polarity becomes DEVTYPE (1=n, 0=p).  The
        4th SPICE terminal (bulk) lands on the module's substrate node
        ``e``."""
        from cedarsim_tpu.models import bsimcmg_class
        cls = bsimcmg_class()
        p = {"DEVTYPE": 1.0 if polarity == "nmos" else 0.0}
        ignored = []

        def take(k, v):
            actual = cls.param_lower.get(k.lower())
            if actual is not None:
                p[actual] = v
            else:
                ignored.append(k)

        for k, v in mdl.params.items():
            if k in ("level", "version", "type"):
                continue
            take(k, self.vres(v, env, el.loc))
        for k, v in kw.items():
            take(k, v)
        if ignored:
            self.warn(f"bsimcmg model {el.model!r}: ignoring unsupported "
                      f"parameter(s) {sorted(set(ignored))}", el.loc)
        while len(nets) < 4:
            nets.append(nets[-1])
        self.ckt.add(cls, name, nets[:4], p, m=m)

    @staticmethod
    def _apply_bsim4_binning(cls, p, bin_corr):
        """Denormalize L/W/P binning corrections into effective card
        values: P_eff = P + LP/Lb + WP/Wb + PP/(Lb·Wb), with Lb/Wb the
        BSIM4 binning geometry (Leff = L + XL − 2·dL, Weff = W/NF + XW −
        2·dW, dL/dW from LINT/LL/LW/LWL and WINT/WL/WW/WWL) expressed in
        meters (binunit=2) or microns (binunit=1).  SPICE binning
        semantics (BSIM4 manual §11 / ngspice b4geo; reference behavior
        via BSIM4.jl on test/binning/bins.cir)."""
        import numpy as _np
        resolved = cls.prepare(p)

        def g(name, d=0.0):
            v = resolved.get(name, d)
            return float(_np.asarray(v))

        # BINUNIT is a declared model parameter (bsim4.va) — read it from
        # the resolved card, not the raw loop (where it is consumed as a
        # normal parameter): 1 = microns (BSIM4 default), 2 = meters
        binunit = g("BINUNIT", 1.0)
        L = g("L", 5e-6)
        W = g("W", 5e-6)
        NF = max(g("NF", 1.0), 1.0)
        lln, lwn = g("LLN", 1.0), g("LWN", 1.0)
        wln, wwn = g("WLN", 1.0), g("WWN", 1.0)
        dL = (g("LINT") + g("LL") / L ** lln + g("LW") / W ** lwn
              + g("LWL") / (L ** lln * W ** lwn))
        dW = (g("WINT") + g("WL") / L ** wln + g("WW") / W ** wwn
              + g("WWL") / (L ** wln * W ** wwn))
        Lb = L + g("XL") - 2.0 * dL
        Wb = W / NF + g("XW") - 2.0 * dW
        if int(binunit) == 1:
            Lb, Wb = Lb / 1e-6, Wb / 1e-6
        for base, c in bin_corr.items():
            base_v = float(_np.asarray(p.get(base, resolved.get(base, 0.0))))
            p[base] = (base_v + c.get("l", 0.0) / Lb + c.get("w", 0.0) / Wb
                       + c.get("p", 0.0) / (Lb * Wb))

    def _do_statistics(self, st: P.Control, scope):
        """Spectre ``statistics { process/mismatch { vary ... } }`` — apply
        Monte-Carlo parameter variations when elaborating with ``mc_seed``
        (beyond the reference, whose parser has no statistics form).

        Semantics: each ``process vary`` perturbs the named parameter with
        one draw from the seeded elaboration RNG — ``dist=gauss`` adds
        N(0, std), ``dist=unif`` adds U(-std, std), ``dist=lnorm``
        multiplies by exp(N(0, std)); ``percent=yes`` scales std by
        |nominal|/100.  ``mismatch vary`` draws are per-*instance*
        (Spectre semantics; the reference's per-instance ``agauss``
        sampling role, /root/reference/src/spectre_env.jl:178-187): the
        parameter is registered in ``self.mismatch_vars`` and every
        device/subckt instantiation evaluates it — and anything derived
        from it — under a per-instance overlay with a draw keyed
        deterministically on (mc_seed, instance path, parameter), so two
        matched devices decorrelate while the same lane reproduces."""
        env = scope["env"]
        entries = st.args[0]
        for ent in entries:
            if ent.get("kind") == "unsupported":
                self.warn("statistics: unsupported clause ignored: "
                          + ent.get("src", ""), st.loc)
                continue
            name = ent["param"]
            if name not in env:
                raise ElabError(
                    f"statistics vary references undefined parameter "
                    f"{name!r}", st.loc)
            if ent["kind"] == "mismatch":
                self.mismatch_vars[name.lower()] = (
                    str(ent.get("dist", "gauss")).lower(),
                    ent.get("std", 0.0),
                    str(ent.get("percent", "no")).lower() in
                    ("yes", "1", "true"),
                    st.loc)
                continue
            if self.rng is None:
                continue                      # nominal elaboration
            nominal = float(env[name])
            dist = str(ent.get("dist", "gauss")).lower()
            std = self.vres(ent.get("std", 0.0), env, st.loc)
            if str(ent.get("percent", "no")).lower() in ("yes", "1", "true"):
                std = abs(nominal) * std / 100.0
            if dist == "lnorm":
                new = nominal * float(np.exp(self.rng.normal(0.0, std)))
            elif dist in ("unif", "uniform"):
                new = nominal + float(self.rng.uniform(-std, std))
            else:                             # gauss (default)
                new = nominal + float(self.rng.normal(0.0, std))
            env.define(name, float(new))

    def _instantiate_vbic(self, el, name, nets, kw, mdl, env, m, val):
        """VBIC-class BJT from a ``.model level=4/9`` card (or a Spectre
        ``vbic`` master with ``type=npn/pnp``).  Model-card parameters map
        case-insensitively onto the VA module's parameters; unknown names
        are collected into one warning (same discipline as
        :meth:`_instantiate_bsim4`)."""
        from cedarsim_tpu.models import vbic_class
        cls = vbic_class()
        if mdl.mtype == "vbic":
            ty = mdl.params.get("type")
            if isinstance(ty, tuple) and ty and ty[0] == "ref":
                ty = ty[1]
            npn = not str(ty).lower().startswith("p")
        else:
            npn = mdl.mtype != "pnp"
        p = {"TYPE": 1.0 if npn else -1.0}
        ignored = []
        for k, v in mdl.params.items():
            if k in ("level", "type"):
                continue
            actual = cls.param_lower.get(k.lower())
            if actual is None:
                ignored.append(k)
                continue
            p[actual] = self.vres(v, env, el.loc)
        for k, v in kw.items():
            actual = cls.param_lower.get(k.lower())
            if actual is None:
                ignored.append(k)
                continue
            p[actual] = v
        area = kw.get("area", val(0, 1.0))
        if area is not None:
            p["AREA"] = area
        if ignored:
            self.warn(f"vbic model {el.model!r}: ignoring unsupported "
                      f"parameter(s) {sorted(set(ignored))}", el.loc)
        while len(nets) < 4:
            nets.append(GROUND)
        self.ckt.add(cls, name, nets[:4], p, m=m)

    def _instantiate_bsource(self, el, name, nets, env, m, prefix,
                             nodemap):
        from cedarsim_tpu.frontend.behavioral import (
            collect_probes, make_bsource, probe_extras)
        from cedarsim_tpu.frontend.expr import expr_refs
        kind, ast = None, None
        for k2, v in el.params.items():
            if k2 in ("v", "i"):
                kind, ast = k2, v
        if kind is None:
            raise ElabError(f"{el.name}: behavioral source needs V= or I=",
                            el.loc)
        if isinstance(ast, (int, float)):
            ast = ("num", float(ast))
        probes = collect_probes(ast)
        # resolve every non-probe identifier to a parameter value now
        const_env = {}
        probe_nodes = set()
        for p in probes:
            if p[0] == "v":
                probe_nodes.add(p[1])
                if p[2]:
                    probe_nodes.add(p[2])
            else:
                probe_nodes.add(p[1])
        for ref in expr_refs(ast):
            if ref in ("time", "temper", "temp", "pi", "m_pi", "v", "i"):
                continue
            if ref in probe_nodes:
                continue
            if ref in env:
                const_env[ref] = env[ref]
        cls = make_bsource(kind, ast, probes, const_env, name)
        extras = probe_extras(
            probes, lambda n2: self._net(n2, prefix, nodemap), prefix)
        self.ckt.add(cls, name, nets, {}, m=m, kw_extras=extras)

    def _apply_coupling(self, el, scope):
        """K card: replace the two named inductors with one
        CoupledInductors device (mutual inductance)."""
        env = scope["env"]
        # card shape: Kxx L1 L2 value — inductor names parse as bare refs
        names = [n.lower() for n in el.nodes]
        if el.model:
            names.append(el.model.lower())
        kval = None
        for v in el.values:
            if isinstance(v, tuple) and v[0] == "ref":
                names.append(v[1].lower())
            elif kval is None:
                kval = self.vres(v, env, el.loc)
        names = names[:2]
        if len(names) < 2:
            raise ElabError(f"{el.name}: needs two inductor names", el.loc)
        if kval is None:
            kval = self.vres(el.params.get("k", 1.0), env, el.loc)
        insts = {i.name: i for i in self.ckt.instances}
        l_insts = []
        for nm in names:
            inst = insts.get(nm)
            if inst is None or inst.model is not Inductor:
                raise ElabError(f"{el.name}: {nm!r} is not an inductor",
                                el.loc)
            l_insts.append(inst)
        la, lb = l_insts
        nets = (*la.nets, *lb.nets)
        self.ckt.instances = [i for i in self.ckt.instances
                              if i.name not in (la.name, lb.name)]
        self.ckt._names.discard(la.name)
        self.ckt._names.discard(lb.name)
        self.ckt.add(CoupledInductors, f"{el.name.lower()}", nets,
                     dict(l1=la.params["l"], l2=lb.params["l"], k=kval))

    def _map_params(self, device, mparams, env, loc, rename=None):
        rename = rename or {}
        out = {}
        for k, v in mparams.items():
            k2 = rename.get(k, k)
            if k2 is None:
                continue
            if k2 in device.params:
                out[k2] = self.vres(v, env, loc)
            else:
                self.warn(f"{device.__name__}: ignoring model param {k!r}",
                          loc)
        return out

    def _instantiate_source(self, el, name, nets, kw, env, m):
        vsrc = el.letter == "v"
        p = {}
        # positional token stream: [dc] value | DC value | AC mag [phase]
        vals = list(el.values)
        # model slot may have swallowed 'dc'/'ac' keywords
        pending = []
        if el.model is not None:
            pending.append(("ref", el.model))
        pending += vals
        i = 0
        positional = []
        while i < len(pending):
            v = pending[i]
            if (isinstance(v, tuple) and v[0] == "ref"
                    and isinstance(v[1], str)):
                word = v[1].lower()
                if word == "dc":
                    i += 1
                    if i < len(pending):
                        p["dc"] = self.vres(pending[i], env, el.loc)
                    i += 1
                    continue
                if word == "ac":
                    i += 1
                    if i < len(pending):
                        p["ac"] = self.vres(pending[i], env, el.loc)
                        i += 1
                    if i < len(pending) and not (
                            isinstance(pending[i], tuple)
                            and pending[i][0] == "ref"):
                        p["acphase"] = self.vres(pending[i], env, el.loc)
                        i += 1
                    continue
            positional.append(self.vres(v, env, el.loc))
            i += 1
        if positional and "dc" not in p:
            p["dc"] = positional[0]
        if "dc" in kw:
            p["dc"] = kw["dc"]
        if "ac" in kw:
            p["ac"] = kw["ac"]

        cls_dc = VSource if vsrc else ISource
        if not el.waves:
            self.ckt.add(cls_dc, name, nets, p, m=m)
            return
        kind, args = el.waves[0]
        args = [self.vres(a, env, el.loc) for a in args]

        def a(i, d=None):
            return args[i] if i < len(args) else d

        if kind == "pulse":
            cls = VSourcePULSE if vsrc else ISourcePULSE
            p.update(v1=a(0, 0.0), v2=a(1, 0.0), td=a(2, 0.0),
                     tr=_tiny_default(a(3), 1e-12),
                     tf=_tiny_default(a(4), 1e-12),
                     pw=_tiny_default(a(5), math.inf),
                     per=_tiny_default(a(6), math.inf))
        elif kind == "pwl":
            cls = VSourcePWL if vsrc else ISourcePWL
            ts, ys = args[0::2], args[1::2]
            if len(ts) != len(ys) or not ts:
                raise ElabError(f"{el.name}: malformed PWL points", el.loc)
            p.update(ts=tuple(ts), ys=tuple(ys))
        elif kind in ("sin", "sine"):
            cls = VSourceSIN if vsrc else ISourceSIN
            p.update(vo=a(0, 0.0), va=a(1, 0.0), freq=a(2, 0.0), td=a(3, 0.0),
                     theta=a(4, 0.0), phase=a(5, 0.0))
        elif kind == "exp":
            cls = VSourceEXP if vsrc else ISourceEXP
            p.update(v1=a(0, 0.0), v2=a(1, 0.0), td1=a(2, 0.0),
                     tau1=_tiny_default(a(3), 1e-9), td2=a(4, 1e30),
                     tau2=_tiny_default(a(5), 1e-9))
        else:
            raise ElabError(f"{el.name}: waveform {kind!r} not implemented",
                            el.loc)
        self.ckt.add(cls, name, nets, p, m=m)

    def _va_module(self, name, scope):
        n = name.lower()
        sc = scope
        while sc is not None:
            vam = sc.get("va_modules")
            if vam and n in vam:
                return vam[n]
            sc = sc.get("parent")
        return None

    #: model type → element letter for master-style instantiation (Spectre
    #: instances and X-cards naming a .model)
    _MTYPE_LETTER = {"nmos": "m", "pmos": "m", "d": "d", "diode": "d",
                     "npn": "q", "pnp": "q", "vbic": "q", "r": "r",
                     "res": "r",
                     "resistor": "r", "c": "c", "capacitor": "c",
                     "l": "l", "inductor": "l",
                     "njf": "j", "pjf": "j", "nmf": "z", "pmf": "z",
                     # Spectre MOS masters (normalized by _mos_kind)
                     "bsim4": "m", "bsim3v3": "m", "bsim3": "m",
                     "bsimcmg": "m", "bsimcmg107": "m", "mos1": "m",
                     "mos902": "m", "mos0": "m"}

    def _instantiate_subckt(self, el, scope, prefix, nodemap, mfac, kw):
        entry = self._subckt(el.model, scope, el.loc)
        if entry is None:
            cls = self._va_module(el.model, scope)
            if cls is not None:
                name = prefix + el.name.lower()
                nets = [self._net(n, prefix, nodemap) for n in el.nodes]
                self.ckt.add(cls, name, nets, kw, m=mfac)
                return
            # master naming a .model → instantiate the built-in device
            try:
                mdl = self._model(el.model, scope, el.loc)
            except ElabError:
                mdl = None
            if mdl is not None and mdl.mtype in self._MTYPE_LETTER:
                import dataclasses as _dc
                el2 = _dc.replace(el, letter=self._MTYPE_LETTER[mdl.mtype])
                self._instantiate(el2, scope, prefix, nodemap, mfac)
                return
            raise ElabError(f"subcircuit {el.model!r} not found", el.loc)
        sub, def_scope = entry
        if len(el.nodes) != len(sub.nodes):
            raise ElabError(
                f"{el.name}: {el.model} has {len(sub.nodes)} ports "
                f"({' '.join(sub.nodes)}), got {len(el.nodes)}", el.loc)
        child_env = ParamEnv(parent=def_scope["env"], rng=self.rng)
        for pname, pexpr in sub.params.items():
            child_env.define(pname, pexpr)
        for pname, pval in kw.items():   # already evaluated in caller env
            child_env.define(pname, pval)
        child_prefix = prefix + el.name.lower() + "."
        child_map = {}
        for port, nodename in zip(sub.nodes, el.nodes):
            child_map[port.lower()] = self._net(nodename, prefix, nodemap)
        child_scope = dict(models=dict(), subckts=dict(), env=child_env,
                           parent=scope)
        elements = []
        self._collect(sub.body, child_scope, elements)
        # instance overrides win over `parameters` statements in the body
        # (Spectre-style defaults collected above would otherwise shadow them)
        for pname, pval in kw.items():
            child_env.define(pname, pval)
        for e2, sc2 in elements:
            self._instantiate(e2, sc2, child_prefix, child_map, mfac)


def elaborate(netlist, include_paths=(), params=None, mc_seed=None,
              temp=27.0) -> Circuit:
    el = Elaborator(include_paths=include_paths, mc_seed=mc_seed, temp=temp,
                    param_overrides=params)
    return el.run(netlist)


def load_spice(text: str, file="<netlist>", **kw) -> Circuit:
    """Parse + elaborate SPICE netlist text → Circuit (the equivalent of
    the reference's ``sp"..."`` string macro, spectre.jl:1754)."""
    return elaborate(P.parse_spice(text, file), **kw)

"""Transient analysis: adaptive implicit time-stepping entirely on-device.

Replaces the reference's Sundials IDA path (``tran!`` → ``solve(prob, IDA())``,
/root/reference/src/sweeps.jl:450-465) with a trapezoidal/backward-Euler
predictor-corrector loop inside ``jax.lax.while_loop`` — no host round-trips
per step, so a vmapped sweep of transients runs as one XLA program.

Method
======
DAE residual F = S(x,t) + dQ(x)/dt, discretized per TranOptions.method
("auto": trap for f64, BDF2 for mixed precision) and
TranOptions.formulation ("auto": charge differences for f64 — exactly
charge-conserving; companion-model capacitance form for f32 evals — never
divides eval noise by h).

* Charge-form trap corrector:  (Q(x₁)−Q(x₀))/h + ½(S(x₁,t₁)+S(x₀,t₀)) = 0,
  Newton matrix C/h + ½G.  Backward Euler for the first step and after each
  waveform breakpoint (order reset at discontinuities).  Cap-form corrector:
  S(x₁) + C(x₁)·ẋ₁ = 0 with ẋ₁ from the method's derivative recurrence.
* Predictor: quadratic Newton divided-difference extrapolation through the
  last three accepted points.
* LTE control: predictor-corrector difference scaled by (atol + rtol·|x|),
  divided by ``trtol`` (SPICE TRTOL≈7 — the classic overestimation factor);
  step accept iff err ≤ 1, h ← h·clip(0.9·err^(−1/3), 0.2, 3).
* Breakpoints: source discontinuities (PWL corners, PULSE edges) are a static
  sorted schedule; steps clamp to hit them exactly, then restart at reduced h
  with BE — the reference gets this via ``time_periodic_singularities!``
  notifying IDA (/root/reference/src/spectre_env.jl:71-77).
* Newton failure → h/4 and retry; abort below h_min.

Outputs land in fixed-size buffers (ts, xs, ẋs) sized ``max_steps``; the
``TranSolution`` trims on host.  ẋ at accepted points comes from the
integrator's own derivative recurrence, making device terminal currents
(i = S_local + C_local·ẋ) exact observables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from cedarsim_tpu.core.compile import CompiledCircuit
from cedarsim_tpu.core.context import SimSpec, Modes
from cedarsim_tpu.ops import linalg
from cedarsim_tpu.analysis.dc import NewtonOptions, solve_dc


@dataclasses.dataclass(frozen=True)
class TranOptions:
    rtol: float = 1e-3
    atol: float = 1e-6
    trtol: float = 7.0
    #: integration method: "trap" (trapezoidal w/ BE starts), "be"
    #: (backward Euler), "bdf2" (variable-step BDF, order 1-2), "bdf3"
    #: (variable-ORDER BDF ladder 1→3: BE on a fresh history, BDF2 after
    #: one accepted step, BDF3 after two — IDA's order ramp capped at 3),
    #: or "bdf5" (the full IDA-parity ladder 1→5,
    #: /root/reference/src/sweeps.jl:456; generic variable-step Lagrange
    #: coefficients, quartic predictor from 5 history points, growth clamp
    #: 1.2 for high-order zero stability); order resets at
    #: breakpoints like IDA does at events.  The cubic predictor engages
    #: one step later (needs 4 history points), raising the controller's
    #: error-estimate order to 4 on smooth stretches — the step-count win
    #: over bdf2; stiff-robust choice matching IDA's low orders; reference solver
    #: bench sweeps integrators, benchmarks/gf180_dff_solver_bench.jl:60-96).
    #: "auto" (default) resolves to trap for the charge formulation and
    #: bdf2 for the cap formulation: the cap-form trap recurrence
    #: ẋ_{n+1} = 2(x_{n+1}-x_n)/h - ẋ_n carries eval noise forward with
    #: alternating sign, inflating LTE (measured 7.7x more Newton solves
    #: than bdf2/cap on the f32 BSIM4 DFF); BDF2's recurrence never
    #: references ẋ and is immune.
    method: str = "auto"
    max_steps: int = 8192          # output buffer size
    max_newton: int = 12
    newton_reltol: float = 1e-6
    newton_abstol: float = 1e-9
    res_tol: float = 1e-9
    #: Jacobian-only diagonal damping on voltage rows (see dc.NewtonOptions
    #: .jac_shunt) — required for eval_dtype=float32
    jac_shunt: float = 0.0
    #: relative coefficient of the Newton residual check (scaled by the
    #: magnitudes of the residual's constituent terms); the f64 default is
    #: 1e-7, f32 evals need ~3e-5
    res_rel: float = 1e-7
    #: step-size controller: "i" (default — classic integral-only
    #: err^(-1/3) control) or "pi" (digital PI, previous-error damped,
    #: Hairer-Wanner PI.4.2).  PI cuts rejections ~45% and smooths h, but
    #: its conservative growth costs more accepted steps — a net loss
    #: under batched lockstep execution, where every lane runs the union
    #: of steps, and a net win for rejection-dominated or oscillatory
    #: single runs.  Either way the controller is AD-detached.
    controller: str = "i"
    #: LTE acceptance deadband: accept steps with err ≤ accept_slack (err is
    #: already trtol-scaled); 1.0 = strict classic rule.  Marginal accepts
    #: still shrink h next step.  Useful under batched lockstep where any
    #: lane's rejection re-runs every lane.
    accept_slack: float = 1.0
    #: modified (chord) Newton, IDA's strategy (the reference's default
    #: integrator, Sundials IDA, re-evaluates J only when convergence
    #: degrades).  0 = off: classic full Newton re-assembles the model
    #: Jacobian (the expensive jacfwd walk) EVERY iteration.
    #: 1 = per-step chord: assemble (G, C) at the predictor once per step
    #: attempt, factor once, iterate with exact residuals only.  This mode
    #: has NO data-dependent refresh decision, so it vmaps cleanly — the
    #: batched-lockstep win (a Newton step typically runs 2-4 iterations;
    #: all but the first skip the jacfwd walk and the factorization).
    #: N ≥ 2 = cross-step reuse: additionally keep the cached (G, C) across
    #: up to N step attempts, refreshing on age, a stale-J Newton failure
    #: (retried at the same h), or a breakpoint crossing.  The refresh is a
    #: lax.cond — profitable only un-vmapped (single-stream), where cond
    #: executes one branch; under vmap it lowers to select and pays both.
    #: Either way the residual stays exact, so a converged step satisfies
    #: the same corrector equation as full Newton.  Per-step chord works on
    #: both the dense and sparse linear-algebra paths (the sparse
    #: factor/solve split mirrors KLU's klu_factor/klu_solve); cross-step
    #: reuse is dense-only (the cache carries dense (G, C)).
    jac_reuse: int = 0
    #: full-Newton rescue after a failed per-step chord certify.  Applies
    #: exactly where the per-step chord path runs: jac_reuse=1 on either
    #: linear-algebra path, and jac_reuse>=2 on the SPARSE path (sparse
    #: never gets cross-step reuse, so it has no stale-J retry of its
    #: own).  The dense cross-step path (jac_reuse>=2, mn_cross) is
    #: excluded — there a Newton failure with a stale J is retried at the
    #: same h with a fresh one instead.
    #: Structured as a SECOND while_loop seeded at the chord iterate, so
    #: under vmap it costs nothing while every lane certifies (the batched
    #: while's condition is false on entry) and rescues a stalled lane
    #: in-program otherwise — the solver-level fix for the round-2
    #: flaky-lane h-collapse (bench.py's host-side relaunch is now a
    #: second line of defense, not the only one).
    chord_fallback: bool = True
    #: consecutive Newton-failed step attempts (h shrinking 4× each) before
    #: the chord_fallback rescue becomes eligible for a lane.  Under vmap
    #: the rescue's while_loop body executes for the WHOLE batch whenever
    #: ANY lane enters it, and each iteration is a full jacfwd model walk +
    #: factorization — engaging on every chord miss cut batched throughput
    #: on the DFF bench several-fold, while the pathology it exists for
    #: (the round-2 h-collapse stall at a breakpoint) only appears as a
    #: failure *streak*.  Ordinary one-off
    #: chord misses reject-and-shrink as before; a lane that has already
    #: failed Newton ``rescue_after`` times at the same t (h down 4^k×)
    #: gets the in-program full-Newton rescue on its next attempt.
    #: 0 = engage immediately on any chord certify failure.  Default 5:
    #: at rescue_after=2 the DFF bench still engaged ~6k batch-iterations
    #: on 2-streaks that h-shrink resolves anyway (identical rejection
    #: counts, more wall time); a genuine stall spiral runs hundreds of
    #: attempts, so waiting five failures (h down 4^5 = 1024x) costs a
    #: stalled lane almost nothing and keeps the common path clean.
    rescue_after: int = 5
    #: consecutive LTE rejections (with converged Newton) before the step is
    #: accepted anyway with an order reset.  Bounds the breakpoint Zeno loop:
    #: a marginal error estimate (err ~ 1.1-1.5) on a breakpoint-landing step
    #: otherwise repeats {reject, shrink, tiny-accept, regrow, re-clip onto
    #: the breakpoint} until the try budget burns out (measured 45k rejected
    #: steps at one PWL corner).  IDA similarly escalates after repeated
    #: error-test failures rather than looping forever.
    stall_accept: int = 12
    h0: float = None               # initial step (default span·1e-6)
    hmax_frac: float = 0.04        # h_max = span·hmax_frac (≈ tstop/25)
    hmin_frac: float = 1e-12
    grow: float = 3.0
    shrink: float = 0.2
    bp_restart: float = 0.1        # h multiplier after a breakpoint
    uic: bool = False              # skip operating point, use ICs directly
    #: transient noise: seed for per-step white-noise injection through the
    #: device noise sources (ε channels) — ngspice TRNOISE role, a
    #: capability the reference lacks.  ε_k ~ N(0, pwr/(2h)) per source at
    #: each step (band-limited white at the step Nyquist); 1/f sources are
    #: excluded.  Use with near-fixed stepping (loose rtol/atol + hmax_frac
    #: sized to the bandwidth of interest): the LTE controller otherwise
    #: fights the non-smooth sample path.  None = noiseless (default).
    noise_seed: int = None
    #: corrector formulation: "charge" discretizes dQ/dt as charge
    #: differences (Q(x)-Qn)/h — exactly charge-conserving, the f64 default;
    #: "cap" uses the companion-model capacitance form S(x) + C(x)·ẋ(x)
    #: with ẋ from the method's derivative recurrence on the f64 states.
    #: "auto" picks cap for mixed-precision (f32) model evals: f32
    #: transcendentals carry ~1e-6 relative error, and dividing that charge
    #: noise by h floors the charge-form residual at ~1e-5 A for small
    #: steps — Newton then never converges and h death-spirals.  The cap
    #: form never divides an f32-evaluated quantity by h (the x-difference
    #: in ẋ is exact f64), so eval noise stays relative.
    formulation: str = "auto"
    #: history-ring length for exact-delay (VA absdelay, delay_mode=
    #: "history") lookups: the last delay_history accepted points' delayed-
    #: expression samples are retained; queries older than the ring hold
    #: its oldest sample.  Size it so td spans at most ~delay_history
    #: accepted steps.
    delay_history: int = 512
    #: output projection (SPICE .save at the engine level): a tuple of
    #: state indices to store in the waveform buffers, or None for all.
    #: A 10k-lane vmapped sweep storing every unknown is terabytes of
    #: HBM; storing only the probed nodes is O(lanes·steps·len(store)).
    #: The checkpoint/final state always carries the FULL x, so resume
    #: and chained windows are unaffected.
    store_vars: tuple = None
    #: output-buffer chunk size: the adaptive while_loop carries only a
    #: (chunk_size, n) buffer; an outer lax.scan stacks chunks in place.
    #: Keeps buffer writes O(chunk) per step — with the full buffer in the
    #: while carry, batched (vmapped) runs copy the whole buffer every
    #: iteration.
    chunk_size: int = 64


@dataclasses.dataclass
class TranSolution:
    ts: np.ndarray
    xs: np.ndarray
    xdots: np.ndarray
    converged: bool
    n_accepted: int
    n_rejected: int
    n_newton: int
    compiled: CompiledCircuit
    ctx: SimSpec
    params: dict
    #: final integrator state (CHECKPOINT_FIELDS dict of host arrays);
    #: pass as ``tran(..., resume=sol.checkpoint)`` to continue, or
    #: persist with save_checkpoint/load_checkpoint
    checkpoint: dict = None
    #: projected-waveform name map (``.save`` semantics): when
    #: TranOptions.store_vars restricted the stored columns, this maps the
    #: stored observable name -> column of ``xs``; None means ``xs`` holds
    #: the full state and every observable is reconstructable
    store_map: dict = None
    #: the options this run used (resolved defaults included), so the same
    #: transient can be repeated on the same compiled program
    opts: TranOptions = None

    @property
    def t(self):
        return self.ts

    def __getitem__(self, name):
        if self.store_map is not None:
            key = name.lower()
            if key not in self.store_map:
                raise KeyError(
                    f"observable {name!r} was not stored — this run "
                    f"projected the waveforms to store_vars="
                    f"{sorted(self.store_map)} (.save semantics); re-run "
                    "without store_vars for full-state access")
            return np.asarray(self.xs[:, self.store_map[key]])
        fn = self.compiled.observe(name)
        f = jax.jit(jax.vmap(
            lambda x, xd, t: fn(x, xd, self.ctx.at_time(t), self.params)))
        return np.asarray(f(self.xs, self.xdots, self.ts))

    def interp(self, name, t_eval):
        vals = self[name]
        return np.interp(t_eval, self.ts, vals)

    def interp_state(self, t_eval):
        """Full state vector linearly interpolated at time(s) ``t_eval``
        (shape [n_x] for scalar t, [len(t), n_x] for a vector)."""
        t = np.asarray(t_eval, dtype=float)
        xs = np.asarray(self.xs)
        out = np.stack([np.interp(t, self.ts, xs[:, i])
                        for i in range(xs.shape[1])], axis=-1)
        return out


def xdot0_and_mask_impl(compiled, x, ctx, params):
    """Traceable (ẋ0, lte_mask) from ONE model walk at the operating point:

    * ẋ0 — minimum-norm solution of C·ẋ = −S (C is structurally singular on
      algebraic rows; ridge-regularized normal equations give the min-norm
      consistent derivative),
    * lte_mask — 1.0 for unknowns with charge/flux dynamics (nonzero column
      in C), 0.0 for algebraic ones, falling back to all-ones for an
      all-algebraic circuit.

    vmap-safe over (x, params) — the sharded sweep path maps it per lane."""
    S, _, _, C = compiled.res_jacs_fwd(x, ctx, params)
    lam = 1e-12 * (jnp.max(jnp.abs(C)) ** 2 + 1e-30)
    A = C.T @ C + lam * jnp.eye(compiled.n_x, dtype=compiled.dtype)
    xd0 = linalg.solve(A, -(C.T @ S))
    m = (jnp.max(jnp.abs(C), axis=0) > 0).astype(compiled.dtype)
    mask = jnp.where(jnp.max(m) > 0, m, jnp.ones_like(m))
    return xd0, mask


def consistent_xdot_impl(compiled, x, ctx, params):
    """ẋ0 only (see xdot0_and_mask_impl; the unused mask DCEs under jit)."""
    return xdot0_and_mask_impl(compiled, x, ctx, params)[0]


def _consistent_xdot(compiled, x, ctx, params):
    """Jit-cached ``consistent_xdot_impl``.

    Evaluated in TRAN mode regardless of the caller's ctx: operating-point
    modes replace integrator-state rows (idt/idtmod pins) with algebraic IC
    constraints that have no dynamic part, which would zero those states'
    ẋ (and, below, drop them from the differential mask)."""
    ctx = ctx.with_mode(Modes.TRAN)
    cache = compiled.__dict__.setdefault("_xdot_jit_cache", {})
    if "fn" not in cache:
        cache["fn"] = jax.jit(
            lambda x, ctx, params: consistent_xdot_impl(
                compiled, x, ctx, params))
    return cache["fn"](x, ctx, params)


def _differential_mask(compiled, x, ctx, params):
    """1.0 for unknowns with charge/flux dynamics (nonzero column in C at the
    operating point), 0.0 for algebraic unknowns.  TRAN-mode C (see
    _consistent_xdot): an idtmod-only circuit evaluated in TRANOP would see
    C ≡ 0 and fall back to LTE-controlling every unknown — including
    discontinuous algebraic outputs like a wrapped VCO phase, locking the
    step controller at the wrap."""
    ctx = ctx.with_mode(Modes.TRAN)
    cache = compiled.__dict__.setdefault("_diffmask_jit_cache", {})
    if "fn" not in cache:
        cache["fn"] = jax.jit(
            lambda x, ctx, params: xdot0_and_mask_impl(
                compiled, x, ctx, params)[1])
    return cache["fn"](x, ctx, params)


#: integrator-state fields that make a transient resumable: the current
#: point, step size, and the three-point history behind the predictor and
#: the BDF2/BDF3 correctors (x3/t3 feed only bdf3's cubic predictor; other
#: methods carry them untouched so every method shares one checkpoint
#: layout)
CHECKPOINT_FIELDS = ("t", "h", "x", "xdot", "x1", "x2", "x3", "t1", "t2",
                     "t3", "nhist", "errp")


def blank_checkpoint(x, xdot, h0):
    """Fresh CHECKPOINT_FIELDS dict for starting a (possibly windowed)
    ``tran_core`` chain at an operating point: no predictor history, step
    size ``h0``.  ``x``/``xdot`` may carry a leading batch axis (vmapped
    lanes) — the scalar fields broadcast to it.  Segment drivers
    (bench.py, benchmarks/chain_transient.py) must build the init state
    through this ONE helper so a new checkpoint field can't silently
    desynchronize them from ``tran_core``'s ``init_state`` contract."""
    bshape = x.shape[:-1]
    d = x.dtype
    z = jnp.zeros(bshape, d)
    return dict(t=z, h=jnp.full(bshape, h0, d), x=x, xdot=xdot,
                x1=x, x2=x, x3=x, t1=z, t2=z, t3=z,
                nhist=jnp.zeros(bshape, jnp.int32),
                errp=jnp.ones(bshape, d))


def window_schedules(bps_all, edges):
    """Per-window breakpoint schedules padded to one shared length so a
    single compiled ``tran_core`` program serves every window: window k
    covers (edges[k], edges[k+1]], its schedule is the interior breakpoints
    + the window end + inf padding — the checkpoint-chained segmentation
    used to respect per-execution deadlines (see bench.py)."""
    bps_all = np.asarray(bps_all, np.float64)
    win = []
    for a, b in zip(edges[:-1], edges[1:]):
        wb = bps_all[(bps_all > a) & (bps_all < b)]
        win.append(np.concatenate([wb, [b], [np.inf]]))
    L = max(len(w) for w in win)
    return np.stack([np.concatenate([w, np.full(L - len(w), np.inf)])
                     for w in win])


def tran_core(compiled: CompiledCircuit, params, ctx: SimSpec, x0, xdot0,
              t0, tstop, bps, h0, opts: TranOptions, lte_mask=None,
              init_state=None):
    """Traceable adaptive transient loop. vmap-safe over params/x0.

    ``lte_mask``: 1.0 for differential variables (those with charge/flux
    dynamics), 0.0 for algebraic ones (branch currents, purely resistive
    nodes).  LTE control applies only to differential variables — algebraic
    quantities jump legitimately at waveform corners and must not drive the
    step-size controller (SPICE applies LTE to states only).

    ``init_state``: optional CHECKPOINT_FIELDS dict from a previous run's
    final state (element 7 of the return tuple) — resumes the integrator
    with its step size and predictor history intact (solver-state
    checkpoint/resume, SURVEY.md §5).  ``t0``/``x0``/``xdot0`` must equal
    the checkpoint's; ``bps`` must contain only breakpoints > t0."""
    n = compiled.n_x
    dtype = compiled.dtype
    span = tstop - t0
    hmax = span * opts.hmax_frac
    hmin = span * opts.hmin_frac
    if opts.store_vars is None:
        n_store = n

        def _proj(v):
            return v
    else:
        _sv = jnp.asarray(np.asarray(opts.store_vars, np.int32))
        n_store = _sv.shape[0]

        def _proj(v):
            return v[_sv]
    nb = bps.shape[0]  # padded with [tstop, inf...]
    if nb == 0:
        # direct callers may pass an empty schedule (no source breakpoint
        # below tstop); indexing a size-0 array is a trace-time error, so
        # substitute the same [tstop, inf] padding the public tran() uses
        bps = jnp.stack([jnp.asarray(tstop, dtype),
                         jnp.asarray(jnp.inf, dtype)])
        nb = 2

    ctx_t = ctx.with_mode(Modes.TRAN)

    from cedarsim_tpu.core.compile import use_sparse_solver
    use_sparse = use_sparse_solver(compiled)
    if use_sparse:
        from cedarsim_tpu.core.sparse_ops import get_sparse_ops
        sops = get_sparse_ops(compiled)
        lin_solve = sops.solve
        c_apply = sops.matvec
    else:
        lin_solve = linalg.solve
        c_apply = lambda C, v: C @ v
    cap_form = (opts.formulation == "cap"
                or (opts.formulation == "auto"
                    and compiled.eval_dtype != compiled.dtype))
    method = opts.method
    if method == "auto":
        method = "bdf2" if cap_form else "trap"
    if method not in ("trap", "be", "bdf2", "bdf3", "bdf5"):
        raise ValueError(f"unknown integration method {method!r} "
                         "(trap | be | bdf2 | bdf3 | bdf5)")
    # modified Newton.  jac_reuse=1 is the static per-step chord
    # (vmappable, both dense and sparse — the sparse factor/solve split is
    # SparseOps.factorize/solve_factorized, KLU's klu_factor/klu_solve
    # role); >=2 adds the cond-gated cross-step cache (dense only: the
    # cache carries dense (G, C) arrays)
    mn = opts.jac_reuse > 0
    mn_cross = opts.jac_reuse > 1 and not use_sparse
    nv = compiled.n_nodes + compiled.n_internal
    _jsh_vec = (opts.jac_shunt
                * (jnp.arange(n) < nv).astype(dtype)) if opts.jac_shunt \
        else None

    def damp_J(J):
        if opts.jac_shunt == 0.0:
            return J
        if use_sparse:
            return sops.add_diag(J, opts.jac_shunt)
        return J + jnp.diag(_jsh_vec)

    noisy = opts.noise_seed is not None and compiled.n_eps > 0
    noise_key = (jax.random.PRNGKey(opts.noise_seed) if noisy else None)
    #: exact-history absdelay sites (VA delay_mode="history"): the carry
    #: holds a shifting (t, u) sample ring; each step attempt reads
    #: u(t_new − td) by linear interpolation and the residual sees it as a
    #: held aux input (explicit-in-delay treatment — standard when td ≳ h)
    n_dly = getattr(compiled, "n_dly", 0)      # total aux width
    n_ring = getattr(compiled, "n_ring", n_dly)  # ring-filled slots
    n_lat = getattr(compiled, "n_lat", 0)        # latched-state slots
    ring_slots = (jnp.asarray(getattr(compiled, "ring_slots"))
                  if n_ring and n_lat else None)
    KD = opts.delay_history

    def parts(x, t, eps=None, dly=None):
        return compiled.residuals(x, ctx_t.at_time(t), params, eps=eps,
                                  dly=dly)

    def rj(x, t, eps=None, dly=None):
        """(S, Q, G, C) — G/C dense or sparse value vectors; J assembly
        (C/h + beta*G) and the rest of the Newton loop are representation-
        agnostic."""
        if use_sparse:
            return sops.res_jacs_sparse(x, ctx_t.at_time(t), params,
                                        eps=eps, dly=dly)
        return compiled.res_jacs_fwd(x, ctx_t.at_time(t), params, eps=eps,
                                     dly=dly)

    def draw_eps(x, t, h_real, k):
        """Discrete white-noise sample for the step ending the interval of
        length h: ε ~ N(0, pwr/(2h)) per source (ngspice TRNOISE
        discretization: band-limited white noise at the step Nyquist).
        Deterministic in the accepted-step index k, so a rejected retry at
        smaller h re-uses the same unit draw rescaled — one sample path per
        seed.  1/f sources (exp>0) are excluded (white only)."""
        pwr, ex = compiled.noise_sources(x, ctx_t.at_time(t), params)
        xi = jax.random.normal(jax.random.fold_in(noise_key, k),
                               (compiled.n_eps,), dtype)
        sigma = jnp.sqrt(jnp.maximum(pwr, 0.0)
                         / (2.0 * jnp.maximum(h_real, 1e-300)))
        return xi * sigma * (ex == 0.0)

    def newton_step(x_init, t_new, h, a0, Qhist, Sn, beta, c0, xdh,
                    eps=None, dly=None, seed=None):
        """Implicit-step Newton.  Charge form solves the generalized
        multistep corrector

            f = (a0*Q(x) + Qhist)/h + beta*S(x) + (1-beta)*Sn

        (BE: a0=1, Qhist=-Qn, beta=1; trap: beta=1/2; BDF2: variable-step
        alpha coefficients with Qhist = a1*Qn + a2*Qprev).  Cap form solves
        the companion-model corrector

            f = S(x) + C(x)·(c0*x + xdh)/h

        (BE: c0=1, xdh=-xn; trap: c0=2, xdh=-(2xn+h·ẋn); BDF2: c0=a0,
        xdh=a1*xn+a2*xp — each exactly the method's ẋ recurrence, so the
        stored ẋ stays consistent with the corrector).  The coefficients
        are data, so every method shares ONE loop-body instantiation.
        (S, Q, G, C) from ONE fused model walk per iteration ride in the
        carry (compile-time discipline — see dc.py docstring); the final
        (S, Q) at the accepted point come out for free.

        ``seed``: optional (S, Q, G, C, done, nnwt0) continuation state —
        the full-Newton RESCUE of a failed per-step chord certify.  The
        carry starts at the chord's final iterate with its (S, Q) and the
        predictor-point (G, C) already in hand (no model walk at init —
        the seed's C is one iterate stale, which only perturbs the first
        search direction; the convergence test always uses fresh values).
        Lanes whose chord already certified enter with done=True, so the
        batched while_loop body never executes when every lane certified —
        the rescue is free on the common path.  This is what keeps a
        marginal vmapped lane from h-collapsing at a breakpoint when its
        frozen-Jacobian iteration stops certifying (the round-2 flaky-lane
        root cause): the lane converges in-program instead of stalling."""
        if seed is None:
            S0_, Q0_, G0_, C0_ = rj(x_init, t_new, eps, dly)
            done0 = jnp.asarray(False)
            nnwt0 = jnp.asarray(0, jnp.int32)
        else:
            S0_, Q0_, G0_, C0_, done0, nnwt0 = seed
            done0 = jnp.asarray(done0)
            nnwt0 = jnp.asarray(nnwt0, jnp.int32)

        def fres(x, S, Q, C):
            if cap_form:
                ic = c_apply(C, (c0 * x + xdh) / h)
                return ic + S, jnp.abs(ic) + jnp.abs(S)
            f = (a0 * Q + Qhist) / h + beta * S + (1.0 - beta) * Sn
            scale = (jnp.abs(a0 * Q + Qhist) / h + jnp.abs(beta * S)
                     + jnp.abs((1.0 - beta) * Sn))
            return f, scale

        def body(carry):
            x, S, Q, G, C, _, it, nnwt = carry
            f, _ = fres(x, S, Q, C)
            J = damp_J(c0 * C / h + G) if cap_form \
                else damp_J(a0 * C / h + beta * G)
            dx = lin_solve(J, -f)
            bad = jnp.logical_not(jnp.all(jnp.isfinite(dx)))
            dx = jnp.where(bad, jnp.zeros_like(dx), dx)
            mx = jnp.max(jnp.abs(dx))
            dx = dx * jnp.where(mx > 5.0, 5.0 / mx, 1.0)
            xn = x + dx
            Sn1, Qn1, Gn1, Cn1 = rj(xn, t_new, eps, dly)
            # residual check as well as dx — a dx-only test false-converges
            # at piecewise-model kinks where Newton stalls with f ≠ 0
            f_new, scale = fres(xn, Sn1, Qn1, Cn1)
            res_ok = jnp.all(jnp.abs(f_new)
                             <= opts.res_rel * scale + opts.res_tol)
            done = jnp.logical_and(
                jnp.logical_and(
                    jnp.all(jnp.abs(dx) <= opts.newton_reltol * jnp.abs(xn)
                            + opts.newton_abstol),
                    res_ok),
                jnp.logical_not(bad))
            return xn, Sn1, Qn1, Gn1, Cn1, done, it + 1, nnwt + 1

        def cond(carry):
            done, it = carry[5], carry[6]
            return jnp.logical_and(jnp.logical_not(done), it < opts.max_newton)

        xn, Sf, Qf, _, _, done, _, nnwt = jax.lax.while_loop(
            cond, body, (x_init, S0_, Q0_, G0_, C0_, done0,
                         jnp.asarray(0, jnp.int32), nnwt0))
        ok = jnp.logical_and(done, jnp.all(jnp.isfinite(xn)))
        return xn, Sf, Qf, ok, nnwt

    def newton_mod(x_init, t_new, h, a0, Qhist, Sn, beta, c0, xdh,
                   solve_fn, eps=None, dly=None, init_parts=None):
        """Modified (chord) Newton: iterate with a FROZEN factored Jacobian,
        evaluating only the residual each iteration.  The residual is exact,
        so a converged point satisfies the same corrector equation as full
        Newton — only the iteration path differs.  Charge form needs just
        (S, Q); cap form gets the displacement current C(x)·v through a jvp
        of the charge vector (no Jacobian assembly).

        ``init_parts``: optional (S, Q, ic) already evaluated at ``x_init``
        — the per-step chord path assembles (S, Q, G, C) at the predictor
        anyway, and ic = C(x_init)·v there, so re-evaluating the model for
        the init residual would duplicate the whole model subgraph in the
        compiled program (and one jvp eval per step attempt at runtime)."""

        def fparts(x):
            if cap_form:
                v = (c0 * x + xdh) / h
                # jvp of Q at x in direction v is exactly C(x)·v — the
                # cap-form displacement current at the current iterate
                (S, Q), (_, ic) = jax.jvp(
                    lambda xx: parts(xx, t_new, eps, dly), (x,), (v,))
                return S, Q, ic
            S, Q = parts(x, t_new, eps, dly)
            return S, Q, jnp.zeros_like(S)

        def fres2(S, Q, ic):
            if cap_form:
                return ic + S, jnp.abs(ic) + jnp.abs(S)
            f = (a0 * Q + Qhist) / h + beta * S + (1.0 - beta) * Sn
            scale = (jnp.abs(a0 * Q + Qhist) / h + jnp.abs(beta * S)
                     + jnp.abs((1.0 - beta) * Sn))
            return f, scale

        S0_, Q0_, ic0_ = fparts(x_init) if init_parts is None else init_parts

        def body(carry):
            x, S, Q, ic, _, it, nnwt = carry
            f, _ = fres2(S, Q, ic)
            dx = solve_fn(-f)
            bad = jnp.logical_not(jnp.all(jnp.isfinite(dx)))
            dx = jnp.where(bad, jnp.zeros_like(dx), dx)
            mx = jnp.max(jnp.abs(dx))
            dx = dx * jnp.where(mx > 5.0, 5.0 / mx, 1.0)
            xn = x + dx
            Sn1, Qn1, icn1 = fparts(xn)
            f_new, scale = fres2(Sn1, Qn1, icn1)
            res_ok = jnp.all(jnp.abs(f_new)
                             <= opts.res_rel * scale + opts.res_tol)
            done = jnp.logical_and(
                jnp.logical_and(
                    jnp.all(jnp.abs(dx) <= opts.newton_reltol * jnp.abs(xn)
                            + opts.newton_abstol),
                    res_ok),
                jnp.logical_not(bad))
            return xn, Sn1, Qn1, icn1, done, it + 1, nnwt + 1

        def cond(carry):
            done, it = carry[4], carry[5]
            return jnp.logical_and(jnp.logical_not(done),
                                   it < opts.max_newton)

        xn, Sf, Qf, _, done, _, nnwt = jax.lax.while_loop(
            cond, body, (x_init, S0_, Q0_, ic0_, jnp.asarray(False),
                         jnp.asarray(0, jnp.int32),
                         jnp.asarray(0, jnp.int32)))
        ok = jnp.logical_and(done, jnp.all(jnp.isfinite(xn)))
        return xn, Sf, Qf, ok, nnwt

    CH = opts.chunk_size
    n_chunks = -(-opts.max_steps // CH)
    max_tries = 3 * opts.max_steps

    if n_dly:
        # seed the history ring at the operating point: every pre-t0 query
        # holds u0 (jnp.interp clamps to the ends).  On resume the corrector
        # history (Sn/Qn) must see u(t0 − td) from the RESTORED ring, not
        # the live value — the trap corrector otherwise solves its first
        # post-seam step against a wrong Sn on the delay rows.  Latched
        # aux state (LRM transition()/zi_*) seeds settled at the op, or
        # restores from the checkpoint.
        latw0 = compiled.latch_init(x0, ctx_t.at_time(t0), params)
        if init_state is not None and "latw" in init_state:
            latw0 = jnp.asarray(init_state["latw"]).astype(dtype)
        u0_d, td0_d = compiled.delay_sources(x0, ctx_t.at_time(t0), params)
        if n_ring:
            if init_state is not None and "t_ring" in init_state:
                _tr0 = jnp.asarray(init_state["t_ring"]).astype(dtype)
                _ur0 = jnp.asarray(init_state["u_ring"]).astype(dtype)
                ring0 = jax.vmap(lambda q, col: jnp.interp(q, _tr0, col))(
                    jnp.asarray(t0, dtype) - td0_d, _ur0.T)
            else:
                ring0 = u0_d
            dly_t0 = (latw0.at[ring_slots].set(ring0)
                      if ring_slots is not None else ring0)
        else:
            dly_t0 = latw0
        S0, Q0 = parts(x0, t0, dly=dly_t0)
    else:
        S0, Q0 = parts(x0, t0)

    state0 = dict(
        t=jnp.asarray(t0, dtype), h=jnp.asarray(h0, dtype),
        x=x0, xdot=xdot0, Qn=Q0, Qp=Q0, Sn=S0,
        x1=x0, x2=x0, x3=x0, t1=jnp.asarray(t0, dtype),
        t2=jnp.asarray(t0, dtype), t3=jnp.asarray(t0, dtype),
        nhist=jnp.asarray(0, jnp.int32), bpi=jnp.asarray(0, jnp.int32),
        k=jnp.asarray(0, jnp.int32), ok=jnp.asarray(True),
        nrej=jnp.asarray(0, jnp.int32), nnwt=jnp.asarray(0, jnp.int32),
        rrun=jnp.asarray(0, jnp.int32), errp=jnp.asarray(1.0, dtype),
        nfr=jnp.asarray(0, jnp.int32),
    )
    if method == "bdf3":
        # third charge-history point (Q at x2) — bdf3-only so the other
        # methods' loop carries (and compiled programs) are unchanged.
        # Like Qn/Qp it is NOT checkpointed: a resume re-seeds it at the
        # checkpoint charge and the order ladder rebuilds from there.
        state0.update(Qpp=Q0)
    elif method == "bdf5":
        # orders 4-5 need a 5th history point (x4/t4) and the deeper
        # charge history; none of it is checkpointed — a resume clamps
        # nhist to the checkpointed depth (≤3) and the ladder rebuilds
        state0.update(Qpp=Q0, Qppp=Q0, Qpppp=Q0,
                      x4=x0, t4=jnp.asarray(t0, dtype))
    if mn_cross:
        # cached model linearization; jage starts huge so the first attempt
        # refreshes, jfail forces a same-h refresh retry after a stale-J
        # Newton failure
        state0.update(Gc=jnp.zeros((n, n), dtype),
                      Cc=jnp.zeros((n, n), dtype),
                      jage=jnp.asarray(1 << 30, jnp.int32),
                      jfail=jnp.asarray(False))
    ckpt_fields = CHECKPOINT_FIELDS
    if n_dly:
        state0.update(latw=latw0.astype(dtype))
        ckpt_fields = CHECKPOINT_FIELDS + ("latw",)
        if n_ring:
            state0.update(
                t_ring=jnp.full((KD,), t0, dtype),
                u_ring=jnp.tile(u0_d.astype(dtype)[None, :], (KD, 1)),
                dly_td=td0_d.astype(dtype))
            ckpt_fields = ckpt_fields + ("t_ring", "u_ring", "dly_td")
    if init_state is not None:
        # Qn/Sn are recomputed at the checkpoint point (S0/Q0 above, since
        # x0/t0 equal the checkpoint's); history restores the predictor
        for f in ckpt_fields:
            if f in ("t", "x", "xdot") or f not in init_state:
                continue  # already seeded via t0/x0/xdot0
            v = jnp.asarray(init_state[f])
            state0[f] = v.astype(jnp.int32 if f == "nhist" else dtype)
        if n_dly == 0:
            # corrector charge history at the RESTORED predictor points
            # (Qp = Q0 was a seam approximation: the first resumed
            # BDF2/BDF3 step's Qhist otherwise mixes charges evaluated at
            # the wrong state).  Skipped with delay channels — Q at t1
            # would need the ring rewound below t0.
            state0["Qp"] = parts(state0["x1"], state0["t1"])[1]
            if method == "bdf3":
                state0["Qpp"] = parts(state0["x2"], state0["t2"])[1]
            elif method == "bdf5":
                state0["Qpp"] = parts(state0["x2"], state0["t2"])[1]
                Q3 = parts(state0["x3"], state0["t3"])[1]
                state0["Qppp"] = Q3
                state0["Qpppp"] = Q3
        if method == "bdf5":
            # the checkpoint has no 5th history point: seed x4/t4 at x3/t3
            # and clamp the ladder so order ≤ 4 until real history refills
            state0["x4"] = state0["x3"]
            state0["t4"] = state0["t3"]
            state0["nhist"] = jnp.minimum(
                state0["nhist"], jnp.asarray(3, jnp.int32))

    t_end = tstop - 1e-12 * span

    def live(c):
        return jnp.logical_and(
            jnp.logical_and(c["t"] < t_end, c["ok"]),
            c["k"] + c["nrej"] < max_tries)

    def attempt(c, bufs):
        """One step attempt; on accept writes slot kc of the chunk buffers."""
        ts_b, xs_b, xd_b, kc = bufs
        t, h, x = c["t"], c["h"], c["x"]
        # a consumed schedule (bpi past the end, or the slot already at/
        # behind t) must stop clipping: pinning next_bp at the last entry
        # made next_bp - t == 0 once the final breakpoint was hit, and the
        # stretch-onto-bp branch below then collapsed h_use to exactly 0 —
        # Newton at h=0 is NaN and the step loop aborts at hmin with the
        # span unfinished (seen on schedules whose last breakpoint lies
        # below tstop; the public tran()/window paths pad with tstop and
        # never hit it)
        next_bp = jnp.where(
            jnp.logical_or(c["bpi"] >= nb,
                           bps[jnp.minimum(c["bpi"], nb - 1)]
                           <= t + 1e-12 * span),
            jnp.asarray(jnp.inf, dtype),
            bps[jnp.minimum(c["bpi"], nb - 1)])
        h_use = jnp.minimum(jnp.minimum(h, hmax),
                            jnp.maximum(next_bp - t, hmin))
        if n_ring:
            # active delay lines bound the step: h ≤ min(td)/2 keeps at
            # least two ring samples per delay, so the interpolated waves
            # can't alias even when LTE is controlled by slower dynamics
            # (SPICE caps T-element timesteps the same way)
            h_use = jnp.minimum(h_use, jnp.maximum(
                0.5 * jnp.min(c["dly_td"]), hmin))
        # if we'd land just short of the breakpoint, stretch onto it
        h_use = jnp.where(next_bp - t - h_use < 0.25 * h_use,
                          next_bp - t, h_use)
        hit_bp = t + h_use >= next_bp - 1e-12 * span
        t_new = jnp.where(hit_bp, next_bp, t + h_use)
        h_real = t_new - t

        # predictor
        t1, t2, x1, x2, nh = c["t1"], c["t2"], c["x1"], c["x2"], c["nhist"]
        d1 = jnp.where(t > t1, (x - x1) / jnp.maximum(t - t1, 1e-300), 0.0)
        d1b = jnp.where(t1 > t2, (x1 - x2) / jnp.maximum(t1 - t2, 1e-300),
                        0.0)
        d2 = jnp.where(t > t2, (d1 - d1b) / jnp.maximum(t - t2, 1e-300), 0.0)
        x_lin = x + d1 * h_real
        x_quad = x_lin + d2 * h_real * (t_new - t1)
        x_pred = jnp.where(nh >= 2, x_quad, jnp.where(nh >= 1, x_lin, x))
        if method in ("bdf3", "bdf5"):
            # cubic Newton-polynomial predictor over (t,x)…(t3,x3): one
            # order above the BDF3 corrector's history so the predictor-
            # corrector difference estimates the h^4 term (IDA's order-
            # aware estimate; the controller exponent switches with it)
            t3, x3 = c["t3"], c["x3"]
            d1c = jnp.where(t2 > t3,
                            (x2 - x3) / jnp.maximum(t2 - t3, 1e-300), 0.0)
            d2b = jnp.where(t1 > t3,
                            (d1b - d1c) / jnp.maximum(t1 - t3, 1e-300), 0.0)
            d3 = jnp.where(t > t3,
                           (d2 - d2b) / jnp.maximum(t - t3, 1e-300), 0.0)
            x_cub = x_quad + d3 * h_real * (t_new - t1) * (t_new - t2)
            x_pred = jnp.where(nh >= 3, x_cub, x_pred)
        if method == "bdf5":
            # quartic continuation of the divided-difference table through
            # (t4, x4); at top order (5) the predictor stays quartic and
            # the PC difference gauges the h^5 term — conservative
            t4, x4 = c["t4"], c["x4"]
            d1d = jnp.where(t3 > t4,
                            (x3 - x4) / jnp.maximum(t3 - t4, 1e-300), 0.0)
            d2c = jnp.where(t2 > t4,
                            (d1c - d1d) / jnp.maximum(t2 - t4, 1e-300), 0.0)
            d3b = jnp.where(t1 > t4,
                            (d2b - d2c) / jnp.maximum(t1 - t4, 1e-300), 0.0)
            d4 = jnp.where(t > t4,
                           (d3 - d3b) / jnp.maximum(t - t4, 1e-300), 0.0)
            x_quart = x_cub + (d4 * h_real * (t_new - t1) * (t_new - t2)
                               * (t_new - t3))
            x_pred = jnp.where(nh >= 4, x_quart, x_pred)

        use_be = nh == 0
        one = jnp.asarray(1.0, dtype)
        if method == "bdf2":
            # variable-step BDF2 alphas; order drops to BE without history
            hi = nh >= 1
            r = h_real / jnp.maximum(t - t1, 1e-300)
            a0 = jnp.where(hi, (1.0 + 2.0 * r) / (1.0 + r), one)
            a1 = jnp.where(hi, -(1.0 + r), -one)
            a2 = jnp.where(hi, r * r / (1.0 + r), 0.0)
            beta = one
        elif method == "bdf3":
            # variable-order BDF ladder: coefficients a_j = h·L_j'(τ0)
            # from the Lagrange basis over the active nodes τ0=t_new,
            # τ1=t, τ2=t1, τ3=t2 (order = 1 + min(nhist, 2)).  Uniform-h
            # sanity: order 3 gives (11/6, -3, 3/2, -1/3).  Degenerate
            # node gaps (empty history) are clamped — the order select
            # ignores those lanes.
            hr = h_real
            e1 = jnp.maximum(h_real, 1e-300)            # τ0−τ1
            e2 = jnp.maximum(t_new - t1, 1e-300)        # τ0−τ2
            e3 = jnp.maximum(t_new - t2, 1e-300)        # τ0−τ3
            f12 = jnp.maximum(t - t1, 1e-300)           # τ1−τ2
            f13 = jnp.maximum(t - t2, 1e-300)           # τ1−τ3
            f23 = jnp.maximum(t1 - t2, 1e-300)          # τ2−τ3
            o3 = (hr * (1.0 / e1 + 1.0 / e2 + 1.0 / e3),
                  -hr * e2 * e3 / (e1 * f12 * f13),
                  hr * e1 * e3 / (e2 * f12 * f23),
                  -hr * e1 * e2 / (e3 * f13 * f23))
            o2 = (hr * (1.0 / e1 + 1.0 / e2),
                  -hr * e2 / (e1 * f12),
                  hr * e1 / (e2 * f12))
            hi3, hi2 = nh >= 2, nh >= 1
            a0 = jnp.where(hi3, o3[0], jnp.where(hi2, o2[0], one))
            a1 = jnp.where(hi3, o3[1], jnp.where(hi2, o2[1], -one))
            a2 = jnp.where(hi3, o3[2], jnp.where(hi2, o2[2], 0.0))
            a3 = jnp.where(hi3, o3[3], 0.0)
            beta = one
        elif method == "bdf5":
            # full IDA-parity ladder (orders 1-5): coefficients a_j =
            # h·L_j'(τ0) from the Lagrange basis over the active nodes
            # τ0=t_new, τ1=t, τ2=t1, τ3=t2, τ4=t3, τ5=t4; active order
            # k = 1 + min(nhist, 4).  Uniform-h sanity (order 5):
            # (137/60, -5, 5, -10/3, 5/4, -1/5) — pinned by
            # tests/test_integrators.py::test_bdf5_uniform_alphas.
            ts_n = (t_new, t, t1, t2, c["t3"], c["t4"])

            def lag(k):
                out = []
                for j in range(k + 1):
                    if j == 0:
                        s = 0.0
                        for m in range(1, k + 1):
                            s = s + 1.0 / jnp.maximum(ts_n[0] - ts_n[m],
                                                      1e-300)
                        out.append(h_real * s)
                        continue
                    num = h_real
                    for m in range(1, k + 1):
                        if m != j:
                            num = num * jnp.maximum(ts_n[0] - ts_n[m],
                                                    1e-300)
                    den = -jnp.maximum(ts_n[0] - ts_n[j], 1e-300)
                    for m in range(1, k + 1):
                        if m != j:
                            dd = ts_n[j] - ts_n[m]
                            dd = jnp.where(m > j,
                                           jnp.maximum(dd, 1e-300),
                                           jnp.minimum(dd, -1e-300))
                            den = den * dd
                    out.append(num / den)
                return out + [one * 0.0] * (5 - k)

            A = [lag(k) for k in (1, 2, 3, 4, 5)]

            def pick(j):
                v = A[0][j]
                for ki in (2, 3, 4, 5):
                    v = jnp.where(nh >= ki - 1, A[ki - 1][j], v)
                return v

            a0, a1, a2, a3, a4, a5 = (pick(j) for j in range(6))
            beta = one
        elif method == "be":
            a0, a1, a2, beta = one, -one, one * 0.0, one
        else:  # trap with BE starts
            a0, a1, a2 = one, -one, one * 0.0
            beta = jnp.where(use_be, 1.0, 0.5).astype(dtype)
        Qhist = a1 * c["Qn"] + a2 * c["Qp"]
        if method == "bdf3":
            Qhist = Qhist + a3 * c["Qpp"]
        elif method == "bdf5":
            Qhist = (Qhist + a3 * c["Qpp"] + a4 * c["Qppp"]
                     + a5 * c["Qpppp"])
        # cap-form ẋ recurrence coefficients (mirror the xdot_* updates)
        if method == "bdf2":
            c0 = a0
            xdh = a1 * x + a2 * x1
        elif method == "bdf3":
            c0 = a0
            xdh = a1 * x + a2 * x1 + a3 * x2
        elif method == "bdf5":
            c0 = a0
            xdh = (a1 * x + a2 * x1 + a3 * x2 + a4 * c["x3"]
                   + a5 * c["x4"])
        elif method == "be":
            c0 = one
            xdh = -x
        else:  # trap with BE starts
            c0 = jnp.where(use_be, 1.0, 2.0).astype(dtype)
            xdh = jnp.where(use_be, -x, -(2.0 * x + h_real * c["xdot"]))
        eps_k = (draw_eps(x, t, h_real, c["k"]) if noisy else None)
        if n_dly:
            # aux inputs for this step: u(t_new − td) from the history
            # ring + the latched state slots, held fixed through Newton
            if n_ring:
                ring_k = jax.vmap(
                    lambda q, col: jnp.interp(q, c["t_ring"], col))(
                        t_new - c["dly_td"], c["u_ring"].T)
                dly_k = (c["latw"].at[ring_slots].set(ring_k)
                         if ring_slots is not None else ring_k)
            else:
                dly_k = c["latw"]
        else:
            dly_k = None
        if mn:
            def fresh_gc(_):
                _, _, G_, C_ = rj(x_pred, t_new, eps_k, dly_k)
                return G_, C_

            if mn_cross:
                refresh = jnp.logical_or(c["jfail"],
                                         c["jage"] >= opts.jac_reuse)
                # in un-vmapped jit, cond executes one branch at runtime —
                # the whole point of the reuse (under vmap it lowers to
                # select and both sides run; use jac_reuse=1 for batches)
                G, C = jax.lax.cond(refresh, fresh_gc,
                                    lambda _: (c["Gc"], c["Cc"]), None)
            else:
                # per-step chord: unconditional assembly at the predictor —
                # static control flow, so vmapped lanes genuinely skip the
                # per-iteration jacfwd walk.  The fused walk's (S, Q) at the
                # predictor seed the chord init residual (ic = C·v exactly,
                # since C here IS ∂Q/∂x at x_pred) — one fewer model
                # instantiation in the program and one fewer jvp eval per
                # step attempt
                S0p, Q0p, G, C = rj(x_pred, t_new, eps_k, dly_k)
                init_parts = (S0p, Q0p,
                              c_apply(C, (c0 * x_pred + xdh) / h_real)
                              if cap_form else jnp.zeros_like(S0p))
            J = damp_J(c0 * C / h_real + G) if cap_form \
                else damp_J(a0 * C / h_real + beta * G)
            if use_sparse:
                fct = sops.factorize(J)

                def chord_solve(b, _fct=fct, _J=J):
                    return sops.solve_factorized(_fct, _J, b)
            else:
                fct = linalg.chord_factor(J)

                def chord_solve(b, _fct=fct):
                    return linalg.chord_solve(_fct, b)
            xn, Sn_new, Qn_new, nok, nnwt = newton_mod(
                x_pred, t_new, h_real, a0, Qhist, c["Sn"], beta, c0,
                xdh, chord_solve, eps=eps_k, dly=dly_k,
                init_parts=None if mn_cross else init_parts)
            if not mn_cross and opts.chord_fallback:
                # full-Newton rescue of a failed chord certify: a second
                # while_loop seeded at the chord iterate (done=nok).  When
                # every lane certified, the batched while's condition is
                # false on entry — zero body executions, so the rescue adds
                # nothing to the common path.  When a marginal lane's
                # frozen-J iteration stalls (the f32 eval-noise floor at a
                # breakpoint — the round-2 flaky-lane root cause), it
                # converges here instead of h-collapsing to an unfinished
                # lane that only the bench's host-side relaunch could save.
                # Engagement gate: only a lane whose Newton has ALREADY
                # failed opts.rescue_after consecutive attempts at this t
                # (h shrunk 4× each time — the collapse spiral signature)
                # enters the rescue; a one-off chord miss keeps the cheap
                # reject-and-shrink path.  Under vmap the rescue body runs
                # for the whole batch when any lane enters, so ungated
                # engagement cut batched throughput several-fold.
                _eligible = c["nfr"] >= opts.rescue_after
                # Seed hygiene: a chord iterate that diverged — non-finite
                # (every rescue dx would be non-finite, zeroed, x frozen:
                # the loop would spin the whole max_newton budget with no
                # possible recovery) or wandered beyond the 5.0 per-
                # iteration step cap from the predictor — restarts the
                # rescue at x_pred, whose fused-walk (S, Q) are already in
                # hand (S0p/Q0p) and whose (G, C) are exact there.
                _xfin = jnp.all(jnp.isfinite(xn))
                _far = jnp.logical_not(
                    jnp.max(jnp.abs(xn - x_pred)) <= 5.0)
                _from_pred = jnp.logical_and(
                    jnp.logical_not(nok), jnp.logical_or(
                        jnp.logical_not(_xfin), _far))
                _sx = jnp.where(_from_pred, x_pred, xn)
                _sS = jnp.where(_from_pred, S0p, Sn_new)
                _sQ = jnp.where(_from_pred, Q0p, Qn_new)
                _done0 = jnp.logical_or(nok, jnp.logical_not(_eligible))
                xn_r, Sn_r, Qn_r, nok_r, nnwt = newton_step(
                    _sx, t_new, h_real, a0, Qhist, c["Sn"], beta, c0, xdh,
                    eps=eps_k, dly=dly_k,
                    seed=(_sS, _sQ, G, C, _done0, nnwt))
                # ineligible lanes keep the chord outcome (the rescue's
                # while_loop returned their seed untouched, but its done0
                # was forced True — don't let that read as convergence)
                _res = jnp.logical_and(_eligible, jnp.logical_not(nok))
                xn = jnp.where(_res, xn_r, xn)
                Sn_new = jnp.where(_res, Sn_r, Sn_new)
                Qn_new = jnp.where(_res, Qn_r, Qn_new)
                nok = jnp.where(_res, nok_r, nok)
            # Newton failure with a STALE linearization is retried at the
            # same h with a fresh one before any step-size action
            stale_fail = (jnp.logical_and(jnp.logical_not(nok),
                                          jnp.logical_not(refresh))
                          if mn_cross else jnp.asarray(False))
        else:
            xn, Sn_new, Qn_new, nok, nnwt = newton_step(
                x_pred, t_new, h_real, a0, Qhist, c["Sn"], beta, c0, xdh,
                eps=eps_k, dly=dly_k)

        # LTE error (predictor-corrector difference), differential vars only
        wt = opts.atol + opts.rtol * jnp.maximum(jnp.abs(xn), jnp.abs(x))
        lerr = jnp.abs(xn - x_pred) / wt
        if lte_mask is not None:
            lerr = lerr * lte_mask
        err = jnp.max(lerr) / opts.trtol
        have_lte = nh >= 2
        stalled = c["rrun"] >= opts.stall_accept
        # acceptance deadband: marginal overshoots (1 < err ≤ slack) are
        # accepted — the controller still shrinks h for the next step
        # (fac = 0.9·err^(-1/3) < 0.9 there), so the deadband trades a
        # bounded sliver of local error for the full cost of a rejected
        # step.  slack=1 restores the strict classic rule.
        lte_ok = jnp.logical_or(jnp.logical_not(have_lte),
                                err <= opts.accept_slack)
        accept = jnp.logical_and(nok, jnp.logical_or(lte_ok, stalled))
        forced = jnp.logical_and(accept, jnp.logical_not(lte_ok))

        # new step size; variable-step BDF2 is zero-stable only for step
        # ratios < 1+sqrt(2), and its r-dependent error constant makes even
        # ratio-2 growth limit-cycle on oscillatory problems (measured: 70
        # rejects/accept at grow=2, 0.05 at grow=1.5) — clamp well below
        if method == "bdf2":
            grow = min(opts.grow, 1.5)
        elif method == "bdf3":
            # variable-step BDF3's zero-stability ratio bound is tighter
            # than BDF2's 1+√2 (safe uniform bound ≈ 1.26-1.5 in the
            # literature).  The clamp binds per ACTIVE order: after a
            # breakpoint the ladder restarts at order 1-2 where the looser
            # ratio is safe, so the h ramp out of the reset isn't throttled
            # by the top order's bound (growth-limited smooth stretches
            # otherwise cost MORE steps at higher order, measured)
            grow = jnp.where(nh >= 2, min(opts.grow, 1.3),
                             min(opts.grow, 1.5))
        elif method == "bdf5":
            # orders 4-5 tolerate even less step-ratio variation
            grow = jnp.where(nh >= 3, min(opts.grow, 1.2),
                             jnp.where(nh >= 2, min(opts.grow, 1.3),
                                       min(opts.grow, 1.5)))
        else:
            grow = opts.grow
        # the controller is detached from AD: sensitivities differentiate
        # the realized discretization, not the adaptivity (a tangent flowing
        # through h via err(x) adds spurious step-sequence derivatives —
        # measurable drift in jvp-through-integrator sensitivities)
        err_ctl = jax.lax.stop_gradient(err)
        # order+1 of the error estimate: the PC difference gauges the
        # predictor's leading term — h^3 with the quadratic predictor,
        # h^4 once bdf3's cubic predictor is active (nh>=3)
        if method == "bdf3":
            p1 = jnp.where(nh >= 3, 4.0, 3.0)
        elif method == "bdf5":
            # quartic predictor active from nh>=4: PC difference gauges h^5
            p1 = jnp.where(nh >= 4, 5.0, jnp.where(nh >= 3, 4.0, 3.0))
        else:
            p1 = 3.0
        if opts.controller == "pi":
            # digital PI control (Gustafsson / Hairer-Wanner PI.4.2):
            # damping by the previous step's error cuts the overshoot-
            # reject-shrink limit cycles an I-only controller falls into
            errp = jnp.maximum(c["errp"], 1e-10)
            err_s = jnp.maximum(err_ctl, 1e-10)
            fac_raw = 0.9 * err_s ** (-0.7 / p1) * errp ** (0.4 / p1)
        else:
            fac_raw = 0.9 * err_ctl ** (-1.0 / p1)
        fac = jnp.where(have_lte, jnp.clip(fac_raw, opts.shrink, grow), 2.0)
        h_acc = jnp.clip(h_real * fac, hmin, hmax)
        # after a breakpoint: restart small relative to the NEXT waveform
        # interval (an unchecked large first step can leap an entire ramp).
        # Past the final breakpoint the "interval" is the remaining span —
        # the consumed-schedule slot would give 0 and pin the restart at
        # hmin (dozens of growth-capped steps to recover)
        # post-accept schedule index: first entry still ahead of t_new.
        # searchsorted (bps is sorted ascending) advances past EVERY
        # consumed entry — two distinct breakpoints closer than
        # 1e-12·span (np.unique removes only exact duplicates; multi-
        # source PWL corners can differ by ulps) used to leave both this
        # interval lookup and bpi pinned on the stale sibling slot: the
        # restart interval came out ~0 (h stranded at hmin, aborting the
        # span) and the consumed-slot guard above mapped next_bp to inf
        # forever, silently skipping the rest of the schedule.
        bpi_acc = jnp.searchsorted(
            bps, t_new + 1e-12 * span, side="left").astype(jnp.int32)
        next_int = jnp.where(
            bpi_acc >= nb, tstop - t_new,
            bps[jnp.minimum(bpi_acc, nb - 1)] - t_new)
        h_bp = jnp.maximum(
            jnp.minimum(h_acc * opts.bp_restart,
                        0.05 * jnp.maximum(next_int, hmin)), hmin)
        h_acc = jnp.where(hit_bp, h_bp, h_acc)
        h_rej = jnp.maximum(h_real * jnp.where(nok, jnp.maximum(
            0.9 * jnp.maximum(err_ctl, 1.0) ** (-1.0 / 3.0), opts.shrink),
            0.25), hmin)
        if mn_cross:
            # stale-J failure: keep h, the retry refreshes the Jacobian
            h_rej = jnp.where(stale_fail, h_real, h_rej)

        xdot_be = (xn - x) / h_real
        xdot_tr = 2.0 * (xn - x) / h_real - c["xdot"]
        if method == "bdf2":
            xdot_n = (a0 * xn + a1 * x + a2 * x1) / h_real
        elif method == "bdf3":
            xdot_n = (a0 * xn + a1 * x + a2 * x1 + a3 * x2) / h_real
        elif method == "bdf5":
            xdot_n = (a0 * xn + a1 * x + a2 * x1 + a3 * x2
                      + a4 * c["x3"] + a5 * c["x4"]) / h_real
        elif method == "be":
            xdot_n = xdot_be
        else:
            xdot_n = jnp.where(use_be, xdot_be, xdot_tr)

        ok_cont = jnp.logical_or(accept, h_rej > hmin * 1.0000001)

        acc = accept
        ts_b = ts_b.at[kc].set(jnp.where(acc, t_new, ts_b[kc]))
        xs_b = xs_b.at[kc].set(jnp.where(acc, _proj(xn), xs_b[kc]))
        xd_b = xd_b.at[kc].set(jnp.where(acc, _proj(xdot_n), xd_b[kc]))
        c = dict(c)
        c.update(
            t=jnp.where(acc, t_new, t),
            h=jnp.where(acc, h_acc, h_rej),
            x=jnp.where(acc, xn, x),
            xdot=jnp.where(acc, xdot_n, c["xdot"]),
            Qn=jnp.where(acc, Qn_new, c["Qn"]),
            Qp=jnp.where(acc, c["Qn"], c["Qp"]),
            **({"Qpp": jnp.where(acc, c["Qp"], c["Qpp"])}
               if method == "bdf3" else {}),
            **({"Qpp": jnp.where(acc, c["Qp"], c["Qpp"]),
                "Qppp": jnp.where(acc, c["Qpp"], c["Qppp"]),
                "Qpppp": jnp.where(acc, c["Qppp"], c["Qpppp"]),
                "x4": jnp.where(acc, c["x3"], c["x4"]),
                "t4": jnp.where(acc, c["t3"], c["t4"])}
               if method == "bdf5" else {}),
            Sn=jnp.where(acc, Sn_new, c["Sn"]),
            x1=jnp.where(acc, x, c["x1"]),
            x2=jnp.where(acc, c["x1"], c["x2"]),
            x3=jnp.where(acc, c["x2"], c["x3"]),
            t1=jnp.where(acc, t, c["t1"]),
            t2=jnp.where(acc, c["t1"], c["t2"]),
            t3=jnp.where(acc, c["t2"], c["t3"]),
            nhist=jnp.where(
                acc,
                jnp.where(jnp.logical_or(hit_bp, forced),
                          jnp.asarray(0, jnp.int32),
                          jnp.minimum(nh + 1, jnp.asarray(
                              5 if method == "bdf5" else 3, jnp.int32))),
                nh).astype(jnp.int32),
            rrun=jnp.where(acc, jnp.asarray(0, jnp.int32),
                           c["rrun"] + 1).astype(jnp.int32),
            # Newton-failure streak: the chord_fallback engagement gate.
            # Any converged Newton (accepted OR LTE-rejected) resets it —
            # only back-to-back certify failures at shrinking h count.
            nfr=jnp.where(nok, jnp.asarray(0, jnp.int32),
                          c["nfr"] + 1).astype(jnp.int32),
            errp=jnp.where(
                jnp.logical_and(acc, jnp.logical_and(
                    have_lte, jnp.logical_not(jnp.logical_or(hit_bp,
                                                             forced)))),
                jnp.maximum(err_ctl, 1e-10),
                jnp.where(acc, 1.0, c["errp"])
            ).astype(dtype),
            bpi=jnp.where(acc, bpi_acc, c["bpi"]).astype(jnp.int32),
            k=(c["k"] + acc.astype(jnp.int32)).astype(jnp.int32),
            nrej=(c["nrej"] + (1 - acc.astype(jnp.int32))).astype(jnp.int32),
            nnwt=(c["nnwt"] + nnwt).astype(jnp.int32),
            ok=jnp.logical_and(c["ok"], ok_cont),
        )
        if mn_cross:
            c.update(
                Gc=G, Cc=C,
                jage=jnp.where(refresh, 1, c["jage"] + 1).astype(jnp.int32),
                # force a refresh after a stale failure or a breakpoint
                # crossing (the model jumps to a new operating region)
                jfail=jnp.logical_or(stale_fail,
                                     jnp.logical_and(acc, hit_bp)),
            )
        if n_ring:
            # push the accepted point's delayed-expression samples into the
            # shift ring (ascending times by construction — jnp.interp needs
            # sorted xs); td refreshes for the next step's lookups
            u_now, td_new = compiled.delay_sources(
                xn, ctx_t.at_time(t_new), params)
            c.update(
                t_ring=jnp.where(acc, jnp.concatenate(
                    [c["t_ring"][1:], t_new[None]]), c["t_ring"]),
                u_ring=jnp.where(acc, jnp.concatenate(
                    [c["u_ring"][1:], u_now.astype(dtype)[None, :]], axis=0),
                    c["u_ring"]),
                dly_td=jnp.where(acc, td_new.astype(dtype), c["dly_td"]),
            )
        if n_lat:
            # event-latch update at ACCEPTED points only: each latch site
            # sees the accepted solution (transition re-targets its ramp,
            # zi_* samples on its clock) — the event-queue replacement
            latw_new = compiled.latch_update(
                xn, ctx_t.at_time(t_new), dly_k, params)
            c.update(latw=jnp.where(acc, latw_new.astype(dtype),
                                    c["latw"]))
        kc = kc + acc.astype(jnp.int32)
        return c, (ts_b, xs_b, xd_b, kc)

    def chunk(state, _):
        ts_b = jnp.full((CH,), tstop, dtype)   # pad with tstop for interp
        xs_b = jnp.zeros((CH, n_store), dtype)
        xd_b = jnp.zeros((CH, n_store), dtype)
        kc0 = jnp.asarray(0, jnp.int32)

        def cond(carry):
            c, bufs = carry
            return jnp.logical_and(live(c), bufs[3] < CH)

        def body(carry):
            c, bufs = carry
            return attempt(c, bufs)

        (state, (ts_b, xs_b, xd_b, kc)) = jax.lax.while_loop(
            cond, body, (state, (ts_b, xs_b, xd_b, kc0)))
        # pad unwritten slots with the current state so raw tran_core output
        # interps monotonically (the tran() wrapper compacts on host, but
        # vmapped consumers read these buffers directly)
        written = (jnp.arange(CH) < kc)[:, None]
        xs_b = jnp.where(written, xs_b, _proj(state["x"]))
        xd_b = jnp.where(written, xd_b, _proj(state["xdot"]))
        return state, (ts_b, xs_b, xd_b, kc)

    state, (ts_c, xs_c, xd_c, kc_c) = jax.lax.scan(
        chunk, state0, None, length=n_chunks)
    ts_all = ts_c.reshape(-1)
    xs_all = xs_c.reshape(-1, n_store)
    xd_all = xd_c.reshape(-1, n_store)
    # prepend the initial point
    ts_all = jnp.concatenate([jnp.asarray([t0], dtype), ts_all])
    xs_all = jnp.concatenate([_proj(x0)[None], xs_all])
    xd_all = jnp.concatenate([_proj(xdot0)[None], xd_all])
    finished = jnp.logical_and(state["ok"], state["t"] >= t_end)
    final = {f: state[f] for f in ckpt_fields}
    return (ts_all, xs_all, xd_all, state["k"] + 1, finished,
            state["nrej"], state["nnwt"], final)


def save_checkpoint(path, ckpt: dict):
    """Persist a transient checkpoint (``sol.checkpoint``) to an .npz file —
    SURVEY.md §5 solver-state checkpointing (a capability the reference
    lacks; its runs restart from t=0 on failure)."""
    np.savez(path, **{k: np.asarray(v) for k, v in ckpt.items()})


def load_checkpoint(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def tran(compiled: CompiledCircuit, tspan, params=None, ctx: SimSpec = None,
         opts: TranOptions = None, dc_opts: NewtonOptions = None,
         x0=None, resume: dict = None) -> TranSolution:
    """Run a transient analysis (reference ``tran!``,
    /root/reference/src/sweeps.jl:450-465).

    ``resume``: a checkpoint dict (``sol.checkpoint`` from a previous run,
    or ``load_checkpoint(path)``) — continues the integration from the
    checkpoint's time with step size and predictor history intact; the DC
    operating point is skipped and ``tspan[0]`` is ignored in favor of the
    checkpoint time."""
    if opts is None:
        if compiled.eval_dtype != compiled.dtype and \
                compiled.eval_dtype == jnp.float32:
            # f32-eval noise floor — see dc.default_newton_options
            # LTE tolerances sit above the f32 noise floor (atol 1e-6
            # stalls the controller into endless shrinkage); validated on
            # the BSIM-CMG DFF against the f64 fixed-step golden.
            # jac_reuse=1 (per-step chord Newton) keeps the f32 noise out
            # of the Jacobian refresh decisions.
            opts = TranOptions(newton_reltol=1e-4, newton_abstol=5e-7,
                               res_tol=1e-3, jac_shunt=1e-7, res_rel=3e-5,
                               rtol=1e-2, atol=1e-4, jac_reuse=1)
        else:
            opts = TranOptions()
    params = compiled.params0 if params is None else params
    store_map = None
    if opts.store_vars is not None:
        # .save semantics on the public path (reference ``.save``/``.probe``
        # cards; VERDICT r3 missing #6): names resolve to state columns, the
        # waveform buffers store ONLY those columns (O(steps·len(save))
        # instead of O(steps·n_x) — the PVT-sweep memory lever), and the
        # returned solution maps names back to them.  The checkpoint still
        # carries the full state, so resume/windows are unaffected.
        idx, store_map = [], {}
        for col, v in enumerate(opts.store_vars):
            if isinstance(v, str):
                net = compiled.circuit._nets.get(v.lower())
                if net is None or net.is_ground:
                    raise ValueError(
                        f"store_vars: {v!r} is not a storable net (ground "
                        "and non-state observables cannot be projected); "
                        f"nets: {compiled.node_names[:20]}...")
                i = net.index
            else:
                i = int(v)
                if not (0 <= i < compiled.n_x):
                    raise ValueError(f"store_vars index {i} out of range "
                                     f"(n_x={compiled.n_x})")
            idx.append(i)
            name = (v.lower() if isinstance(v, str)
                    else (compiled.node_names[i]
                          if i < len(compiled.node_names) else f"x{i}"))
            store_map[name] = col
        import dataclasses as _dc
        opts = _dc.replace(opts, store_vars=tuple(idx))
    if ctx is None:
        from cedarsim_tpu.core.compile import default_ctx
        ctx = default_ctx(compiled)
    t0, tstop = float(tspan[0]), float(tspan[1])
    if resume is not None:
        t0 = float(np.asarray(resume["t"]))
        if t0 >= tstop:
            raise ValueError(f"checkpoint time {t0} is already past "
                             f"tstop={tstop}")
        if "t_ring" in resume and \
                len(np.asarray(resume["t_ring"])) != opts.delay_history:
            raise ValueError(
                f"checkpoint delay-history ring has "
                f"{len(np.asarray(resume['t_ring']))} slots but "
                f"TranOptions.delay_history={opts.delay_history} — resume "
                "with the same delay_history the checkpoint was saved with")
    span = tstop - t0

    # breakpoint schedule (static)
    bps = compiled.breakpoints(tstop)
    bps = np.concatenate([bps[bps > t0], [tstop], [np.inf]])
    bps_j = jnp.asarray(bps, compiled.dtype)

    h0 = opts.h0 if opts.h0 is not None else span * 1e-6
    if len(bps) > 2:
        h0 = min(h0, max(float(bps[0] - t0) * 0.1, span * 1e-9))

    # initial operating point
    if resume is not None:
        x0 = jnp.asarray(resume["x"], compiled.dtype)
        converged0 = True
    elif x0 is None:
        if opts.uic:
            x0 = jnp.zeros(compiled.n_x, compiled.dtype)
            for name, v in compiled.circuit.ics.items():
                net = compiled.circuit._nets[name]
                if not net.is_ground:
                    x0 = x0.at[net.index].set(v)
            converged0 = True
        else:
            res = solve_dc(compiled, params, ctx, opts=dc_opts,
                           mode=Modes.TRANOP)
            x0 = res.x
            converged0 = bool(np.all(np.asarray(res.converged)))
    else:
        x0 = jnp.asarray(x0, compiled.dtype)
        converged0 = True

    fn = _get_tran_jit(compiled, opts, len(bps), resume is not None)
    ctx_op = ctx.with_mode(Modes.TRANOP).at_time(t0)
    if resume is not None:
        xdot0 = jnp.asarray(resume["xdot"], compiled.dtype)
        h0 = float(np.asarray(resume["h"]))
    else:
        xdot0 = _consistent_xdot(compiled, x0, ctx_op, params)
    lte_mask = _differential_mask(compiled, x0, ctx_op, params)
    ts, xs, xd, k, fin, nrej, nnwt, final = fn(
        params, ctx, x0, xdot0, jnp.asarray(t0, compiled.dtype),
        jnp.asarray(tstop, compiled.dtype), bps_j,
        jnp.asarray(h0, compiled.dtype), lte_mask, resume)
    k = int(k)
    # compact chunk buffers on host: each chunk's first kc rows are valid
    ts = np.asarray(ts)
    xs = np.asarray(xs)
    xd = np.asarray(xd)
    CH = opts.chunk_size
    body_t = ts[1:].reshape(-1, CH)
    body_x = xs[1:].reshape(-1, CH, xs.shape[-1])
    body_d = xd[1:].reshape(-1, CH, xs.shape[-1])
    kcs = np.minimum(np.maximum(
        k - 1 - CH * np.arange(body_t.shape[0]), 0), CH)
    rows = [np.zeros(0, np.int64)] if k <= 1 else [
        np.arange(kc) + i * CH for i, kc in enumerate(kcs) if kc > 0]
    sel = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    ts_f = np.concatenate([ts[:1], body_t.reshape(-1)[sel]])
    xs_f = np.concatenate([xs[:1], body_x.reshape(-1, xs.shape[-1])[sel]])
    xd_f = np.concatenate([xd[:1], body_d.reshape(-1, xs.shape[-1])[sel]])
    return TranSolution(
        ts=ts_f, xs=xs_f, xdots=xd_f,
        converged=bool(fin) and converged0, n_accepted=k,
        n_rejected=int(nrej), n_newton=int(nnwt),
        compiled=compiled, ctx=ctx.with_mode(Modes.TRAN), params=params,
        checkpoint={f: np.asarray(v) for f, v in final.items()},
        store_map=store_map, opts=opts)


def _get_tran_jit(compiled: CompiledCircuit, opts: TranOptions, nbp: int,
                  resuming: bool = False):
    cache = compiled.__dict__.setdefault("_tran_jit_cache", {})
    key = (opts, nbp, resuming)
    if key not in cache:
        cache[key] = jax.jit(
            lambda params, ctx, x0, xdot0, t0, tstop, bps, h0, m, ist:
            tran_core(compiled, params, ctx, x0, xdot0, t0, tstop, bps, h0,
                      opts, m, init_state=ist))
    return cache[key]

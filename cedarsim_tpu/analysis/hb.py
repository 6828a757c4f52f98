"""Harmonic balance — periodic steady state by Fourier spectral collocation.

A capability beyond the reference (CedarSim has no PSS at all; this repo's
``analysis/pss.py`` adds single shooting, and this module adds the
frequency-domain method commercial simulators pair with it).  The periodic
orbit is represented by its values on an odd-N uniform grid over one period
(N = 2·n_harmonics + 1 — the real-signal trigonometric interpolant through
those samples is exactly the K-harmonic Fourier series), and the DAE
residual  d/dt Q(x) + S(x, t) = 0  is collocated at the grid points with
the time derivative taken spectrally:

    r_j = S(x_j, t_j) + sum_l D[j,l] Q(x_l) = 0,   j = 0..N-1

where D is the periodic Fourier differentiation matrix (Trefethen,
"Spectral Methods in MATLAB", ch. 3: D[j,l] = (pi/T)·(−1)^{j−l} /
sin(pi (j−l)/N)).  This time-domain collocation is algebraically identical
to classical harmonic balance on a square grid, but keeps every quantity
real and lets the device models evaluate exactly as they do in transient.

Batched shape: all N sample evaluations run as ONE vmap (the per-class
batched stamps batch over samples × instances), and the Newton system is a
dense (N·n)² matrix built from two einsums — dense matmul work, no
sequential time stepping at all.  Convergence is the classic HB trade: a handful of Newton
solves instead of integrating thousands of periods to steady state.

Two entry points:

- ``hb(compiled, period, ...)`` — driven circuits (known period).
- ``hb_autonomous(compiled, period_guess, anchor=...)`` — oscillators: the
  angular frequency ω joins the unknowns (r = S + ω·D̂ Q with D̂ the
  unit-period matrix, so ∂r/∂ω = D̂ Q in closed form) and the phase is
  pinned by anchoring the spectral derivative of one state to zero at
  sample 0.  This computes an oscillator's frequency as a Newton unknown —
  the reference can only measure it off a transient.

Both default to a short transient warm-up for the initial guess (standard
practice: HB's Newton basin is small for strongly nonlinear circuits).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from cedarsim_tpu import config
from cedarsim_tpu.core.compile import CompiledCircuit, default_ctx
from cedarsim_tpu.core.context import SimSpec, Modes
from cedarsim_tpu.ops import linalg
from cedarsim_tpu.analysis.dc import solve_dc
from cedarsim_tpu.analysis.tran import TranOptions, tran


def _diff_matrix(n_samples: int, dtype) -> np.ndarray:
    """Periodic spectral differentiation matrix for an odd number of
    uniform samples over period 2π (scale by 2π/T for period T)."""
    N = n_samples
    if N % 2 == 0:
        raise ValueError("harmonic balance uses an odd sample count")
    j = np.arange(N)
    diff = j[:, None] - j[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        Dhat = np.where(diff == 0, 0.0,
                        0.5 * (-1.0) ** diff / np.sin(np.pi * diff / N))
    return Dhat.astype(dtype)  # d/dθ on [0, 2π)


def _reject_aux_channels(compiled, what):
    if getattr(compiled, "n_dly", 0):
        raise NotImplementedError(
            f"{what} does not support integrator-carried aux state "
            "(exact-history delays / latched transition / zi_*): the "
            "collocation unknowns are the state samples only.  Use the "
            "state-based lowerings (delay_mode='pade', "
            "transition_mode='smooth') for harmonic balance.")


@dataclasses.dataclass
class HBResult:
    """One period of the steady state on the collocation grid.

    ``x_samples[j]`` is the state at ``t_samples[j]``; any signal is
    available as exact trigonometric interpolation through its samples
    (``interp``) or as complex harmonic coefficients (``spectrum``, with
    ``spectrum(name)[k]`` multiplying ``exp(+i k ω t)``; coefficient 0 is
    the DC term and |X_k| is half the peak amplitude of harmonic k>0).
    """
    compiled: CompiledCircuit
    params: object
    ctx: SimSpec
    t_samples: np.ndarray      # [N]
    x_samples: np.ndarray      # [N, n_x]
    xdot_samples: np.ndarray   # [N, n_x] spectral derivative
    period: float
    converged: bool
    iters: int
    resnorm: float             # max |r| at the solution
    n_harmonics: int

    @property
    def freq(self) -> float:
        return 1.0 / self.period

    def samples(self, name: str) -> np.ndarray:
        """Signal values at the collocation times."""
        fn = self.compiled.observe(name)
        ctx = self.ctx.with_mode(Modes.TRAN)
        out = jax.vmap(
            lambda x, xd, t: fn(x, xd, ctx.at_time(t), self.params))(
                jnp.asarray(self.x_samples), jnp.asarray(self.xdot_samples),
                jnp.asarray(self.t_samples))
        return np.asarray(out)

    def spectrum(self, name: str) -> np.ndarray:
        """Complex harmonic coefficients X_k, k = 0..n_harmonics, such that
        signal(t) = X_0 + 2·Re Σ_{k≥1} X_k exp(i k ω t)."""
        y = self.samples(name)
        X = np.fft.fft(y) / len(y)
        return X[: self.n_harmonics + 1]

    def interp(self, name: str, t) -> np.ndarray:
        """Exact trigonometric interpolation of a signal at time(s) t."""
        X = self.spectrum(name)
        t = np.asarray(t, dtype=float)
        w = 2.0 * np.pi / self.period
        k = np.arange(1, self.n_harmonics + 1)
        y = X[0].real + 2.0 * np.real(
            np.exp(1j * np.outer(t, k * w)) @ X[1:])
        return y if t.ndim else float(y.reshape(-1)[0])

    def thd(self, name: str) -> float:
        """Total harmonic distortion of a signal: sqrt(Σ_{k≥2}|X_k|²)/|X_1|
        (the .four definition, analysis/measure.py::fourier)."""
        X = self.spectrum(name)
        return float(np.sqrt(np.sum(np.abs(X[2:]) ** 2)) /
                     max(np.abs(X[1]), 1e-300))


def _newton(r_fn, step_fn, z0, tol, max_iter, damping):
    """Damped Newton with residual-norm backtracking (host loop — iteration
    counts are small and each body is one jitted program)."""
    z = z0
    rn = float(jnp.max(jnp.abs(r_fn(z))))
    converged = rn <= tol
    it = 0
    for it in range(1, max_iter + 1):
        if converged:
            break
        dz = step_fn(z)
        if not all(bool(jnp.all(jnp.isfinite(leaf)))
                   for leaf in jax.tree.leaves(dz)):
            break
        lam = damping
        improved = False
        for _ in range(8):
            z_try = jax.tree.map(lambda a, b: a + lam * b, z, dz)
            rn_try = float(jnp.max(jnp.abs(r_fn(z_try))))
            if np.isfinite(rn_try) and (rn_try < rn or rn_try <= tol):
                z, rn, improved = z_try, rn_try, True
                break
            lam *= 0.5
        if not improved:
            break
        converged = rn <= tol
    return z, converged, it, rn


def _warmup_samples(compiled, period, params, ctx, opts, warmup_periods,
                    ts_in_period, x0=None):
    """Integrate ``warmup_periods`` of transient and sample the last period
    at the collocation phases — the standard HB initial guess."""
    T = float(period)
    t_end = warmup_periods * T
    sol = tran(compiled, (0.0, t_end + T), params=params, ctx=ctx,
               opts=opts, x0=x0)
    ts = t_end + np.asarray(ts_in_period)
    xs = np.stack([np.asarray(sol.interp_state(t)) for t in ts])
    return xs, sol


def hb(compiled: CompiledCircuit, period: float, params=None,
       ctx: SimSpec = None, n_harmonics: int = 15, max_iter: int = 30,
       tol: float = 1e-9, damping: float = 1.0, init: str = "transient",
       warmup_periods: int = 2, tran_opts: TranOptions = None) -> HBResult:
    """Harmonic-balance PSS of a circuit driven at a known ``period``.

    ``init``: "transient" (default — integrate ``warmup_periods`` periods
    and sample; robust for strongly nonlinear circuits) or "dc" (flat
    operating-point start; fine for mildly nonlinear ones).
    """
    _reject_aux_channels(compiled, "harmonic balance")
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    d = compiled.dtype
    T = float(period)
    N = 2 * int(n_harmonics) + 1
    n = compiled.n_x
    ts = np.arange(N) * (T / N)
    D = jnp.asarray((2.0 * np.pi / T) * _diff_matrix(N, np.float64), d)
    ctx_t = ctx.with_mode(Modes.TRAN)
    tsj = jnp.asarray(ts, d)

    @jax.jit
    def r_fn(xs):
        S, Q = jax.vmap(
            lambda x, t: compiled.residuals(x, ctx_t.at_time(t), params))(
                xs, tsj)
        return S + D @ Q

    @jax.jit
    def step_fn(xs):
        S, Q = jax.vmap(
            lambda x, t: compiled.residuals(x, ctx_t.at_time(t), params))(
                xs, tsj)
        r = S + D @ Q
        G, C = jax.vmap(
            lambda x, t: compiled.jacobians(x, ctx_t.at_time(t), params))(
                xs, tsj)
        # J[(j,a),(l,b)] = δ_jl G_j[a,b] + D[j,l] C_l[a,b]
        J = jnp.einsum("jl,lab->jalb", D, C)
        J = J.at[jnp.arange(N), :, jnp.arange(N), :].add(G)
        dx = linalg.solve(J.reshape(N * n, N * n), -r.reshape(N * n))
        return dx.reshape(N, n)

    if init == "transient":
        xs0, _ = _warmup_samples(compiled, T, params, ctx, tran_opts,
                                 warmup_periods, ts)
        xs0 = jnp.asarray(xs0, d)
    else:
        op = solve_dc(compiled, params, ctx, mode=Modes.TRANOP)
        xs0 = jnp.tile(op.x[None, :], (N, 1))

    scale = float(jnp.max(jnp.abs(xs0))) + 1.0
    xs, converged, it, rn = _newton(r_fn, step_fn, xs0, tol * scale,
                                    max_iter, damping)
    xd = np.asarray(D @ xs)
    return HBResult(compiled=compiled, params=params, ctx=ctx,
                    t_samples=ts, x_samples=np.asarray(xs),
                    xdot_samples=xd, period=T, converged=bool(converged),
                    iters=it, resnorm=rn, n_harmonics=int(n_harmonics))


@dataclasses.dataclass
class PACSolution:
    """Periodic AC: small-signal transfer from the circuit's ``ac=``
    sources to every sideband ``f_in + k·f0`` around the periodic orbit.

    ``u[i, j, :]`` is the complex periodic envelope of the small-signal
    response at input frequency ``freqs[i]``, collocation sample ``j``:
    the full small-signal waveform is ``Re[(Σ_k U_k e^{i k ω0 t})
    e^{i 2π f_in t}]``.  ``sidebands(name)[i, k]`` is the complex gain to
    the output component at ``freqs[i] + k·f0`` (k from ``k_values``).
    """
    hbres: HBResult
    freqs: np.ndarray          # [nf] input frequencies (Hz)
    u: np.ndarray              # [nf, N, n_x] complex envelope samples

    @property
    def k_values(self) -> np.ndarray:
        N = self.u.shape[1]
        K = (N - 1) // 2
        return np.arange(-K, K + 1)

    def _obs_envelope(self, name) -> np.ndarray:
        """Observable's complex envelope at every (freq, sample)."""
        res = self.hbres
        compiled, params = res.compiled, res.params
        fn = compiled.observe(name)
        ctx = res.ctx.with_mode(Modes.TRAN)
        N = self.u.shape[1]
        D = jnp.asarray((2.0 * np.pi / res.period)
                        * _diff_matrix(N, np.float64), compiled.dtype)
        xs = jnp.asarray(res.x_samples)
        xds = jnp.asarray(res.xdot_samples)
        ts = jnp.asarray(res.t_samples)
        ws = 2.0 * np.pi * jnp.asarray(self.freqs, compiled.dtype)

        def one_freq(uf, wi):
            # tangent of xdot: d/dt(u e^{iωt}) envelope = u̇ + iω u
            ud = D @ uf + 1j * wi * uf

            def one_sample(x, xd, t, uu, uud):
                def f(xx, xxd):
                    return fn(xx, xxd, ctx.at_time(t), params)
                _, dre = jax.jvp(f, (x, xd), (uu.real, uud.real))
                _, dim = jax.jvp(f, (x, xd), (uu.imag, uud.imag))
                return dre + 1j * dim

            return jax.vmap(one_sample)(xs, xds, ts, uf, ud)

        return np.asarray(jax.jit(jax.vmap(one_freq))(
            jnp.asarray(self.u), ws))

    def sidebands(self, name: str) -> np.ndarray:
        """[nf, N] complex gains to output components at
        ``freqs[i] + k_values·f0``."""
        env = self._obs_envelope(name)          # [nf, N]
        N = env.shape[1]
        K = (N - 1) // 2
        Uk = np.fft.fft(env, axis=1) / N        # e^{+ikω0t} coefficients
        return np.concatenate([Uk[:, N - K:], Uk[:, : K + 1]], axis=1)

    def gain(self, name: str, k: int = 0) -> np.ndarray:
        """Complex gain [nf] to the sideband ``f_in + k·f0``."""
        sb = self.sidebands(name)
        K = (sb.shape[1] - 1) // 2
        return sb[:, K + k]


def pac(res: HBResult, freqs) -> PACSolution:
    """Periodic AC analysis around a harmonic-balance orbit.

    Solves the linear periodically-time-varying small-signal problem: for
    an input tone at ``f_in`` injected through the circuit's ``ac=``
    sources, the response is ``u(t)·e^{i 2π f_in t}`` with ``u``
    T-periodic, satisfying  G(t)u + d/dt(C(t)u) + iω_in·C(t)u = b
    (b = ``ac_rhs``, the same RHS-form vector classic ``ac()`` solves
    against).  Collocated on the HB grid this is one dense complex solve
    per input frequency — batched with vmap:

        [blockdiag(G_j + iω_in C_j) + D·blockdiag(C_j)] U = B

    This is the mixer/switched-capacitor workhorse (conversion gain,
    harmonic transfer) that neither the reference nor plain AC has.
    """
    compiled, params = res.compiled, res.params
    _reject_aux_channels(compiled, "periodic AC")
    if compiled.circuit.sparam_blocks:
        raise NotImplementedError(
            "periodic AC does not support S-parameter frequency stamps")
    d = compiled.dtype
    N, n = res.x_samples.shape
    T = res.period
    D = jnp.asarray((2.0 * np.pi / T) * _diff_matrix(N, np.float64), d)
    ctx_t = res.ctx.with_mode(Modes.TRAN)
    xs = jnp.asarray(res.x_samples, d)
    ts = jnp.asarray(res.t_samples, d)
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))

    @jax.jit
    def run():
        G, C = jax.vmap(
            lambda x, t: compiled.jacobians(x, ctx_t.at_time(t), params))(
                xs, ts)
        Gc = G.astype(config.complex_dtype)
        Cc = C.astype(config.complex_dtype)
        A0 = jnp.einsum("jl,lab->jalb", D.astype(config.complex_dtype), Cc)
        A0 = A0.at[jnp.arange(N), :, jnp.arange(N), :].add(Gc)
        A0 = A0.reshape(N * n, N * n)
        b = compiled.ac_rhs(params)
        B = jnp.tile(b, N)
        Cblk = jnp.zeros((N, n, N, n), config.complex_dtype)
        Cblk = Cblk.at[jnp.arange(N), :, jnp.arange(N), :].set(Cc)
        Cblk = Cblk.reshape(N * n, N * n)
        ws = 2.0 * np.pi * jnp.asarray(freqs, d)

        def solve_one(wi):
            A = A0 + 1j * wi.astype(config.complex_dtype) * Cblk
            return linalg.solve(A, B)

        return jax.vmap(solve_one)(ws).reshape(len(freqs), N, n)

    u = np.asarray(run())
    return PACSolution(hbres=res, freqs=freqs, u=u)


@dataclasses.dataclass
class PNoiseSolution:
    """Cyclostationary (periodic) noise at an output around an HB orbit.

    ``psd[i]`` is the output noise PSD at ``freqs[i]`` with noise folded in
    from every sideband ``freqs[i] − k·f0``; ``per_source[i, s]`` splits it
    by noise source (already sideband-summed)."""
    freqs: np.ndarray
    psd: np.ndarray            # [nf]
    per_source: np.ndarray     # [nf, n_eps]
    eps_names: list
    hbres: HBResult
    k_sidebands: int

    def __getitem__(self, _name="out"):
        return self.psd

    def total(self, f1=None, f2=None):
        f = self.freqs
        lo = f[0] if f1 is None else f1
        hi = f[-1] if f2 is None else f2
        m = (f >= lo) & (f <= hi)
        tz = getattr(np, "trapezoid", None) or np.trapz
        return float(np.sqrt(tz(self.psd[m], f[m])))

    def source(self, name):
        if name in self.eps_names:
            return self.per_source[:, self.eps_names.index(name)]
        cols = [k for k, n in enumerate(self.eps_names)
                if n.rsplit("#", 1)[0] == name]
        if not cols:
            raise KeyError(f"no noise source {name!r}; have {self.eps_names}")
        return self.per_source[:, cols].sum(axis=1)


def pnoise(res: HBResult, out: str, freqs, k_sidebands: int = None
           ) -> PNoiseSolution:
    """Periodic noise analysis (the PSS/PNOISE pairing of RF simulators —
    beyond both the reference and this repo's stationary ``noise()``).

    Model: each device noise source is a unit stationary process amplitude-
    modulated along the orbit, entering the linearized system through the
    periodic coupling column ``c_s(t) = ∂F/∂ε_s(t)·sqrt(pwr_s(t))`` (e.g.
    shot noise i = sqrt(2qI(t))·ξ(t)).  Output PSD at f folds every input
    sideband through the periodic small-signal operator:

        S(f) = Σ_s Σ_{|k|≤K} |L_k[A(ω_k)⁻¹ c_s]|² · |f − k·f0|^(−exp_s)

    with ω_k = 2π(f − k·f0), L_k the k-th output-envelope harmonic at the
    output observable, and A the same collocation operator as ``pac``.
    One transposed solve per (f, k) yields the transfers from ALL sources
    at once (the stationary ``noise()`` adjoint trick, lifted to the
    harmonic transfer matrix); the whole (f × k) grid is one vmap.

    ``k_sidebands`` defaults to the orbit's harmonic truncation."""
    compiled, params = res.compiled, res.params
    _reject_aux_channels(compiled, "periodic noise")
    if compiled.circuit.sparam_blocks:
        raise NotImplementedError(
            "periodic noise does not support S-parameter frequency stamps")
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    if compiled.n_eps == 0:
        return PNoiseSolution(freqs, np.zeros_like(freqs),
                              np.zeros((len(freqs), 0)), [], res, 0)
    d = compiled.dtype
    N, n = res.x_samples.shape
    T = res.period
    f0 = 1.0 / T
    K = res.n_harmonics if k_sidebands is None else int(k_sidebands)
    ks = np.arange(-K, K + 1)
    D = jnp.asarray((2.0 * np.pi / T) * _diff_matrix(N, np.float64), d)
    ctx_t = res.ctx.with_mode(Modes.TRAN)
    xs = jnp.asarray(res.x_samples, d)
    ts = jnp.asarray(res.t_samples, d)
    obs = compiled.observe(out)

    # (f, k) product grid, flattened for one vmap
    fg, kg = np.meshgrid(freqs, ks, indexing="ij")
    nu = fg - kg * f0                     # signed input frequency per pair
    w_in = jnp.asarray(2.0 * np.pi * nu.reshape(-1), d)
    k_flat = jnp.asarray(kg.reshape(-1), jnp.int32)

    @jax.jit
    def run():
        G, C = jax.vmap(
            lambda x, t: compiled.jacobians(x, ctx_t.at_time(t), params))(
                xs, ts)
        Jeps = jax.vmap(
            lambda x, t: jax.jacfwd(
                lambda e: compiled.residuals(
                    x, ctx_t.at_time(t), params, eps=e)[0])(
                jnp.zeros(compiled.n_eps, d)))(xs, ts)   # [N, n, n_eps]
        pwr, _ex = jax.vmap(
            lambda x, t: compiled.noise_sources(
                x, ctx_t.at_time(t), params))(xs, ts)    # [N, n_eps]
        Cmod = Jeps * jnp.sqrt(jnp.maximum(pwr, 0.0))[:, None, :]
        Cfull = Cmod.reshape(N * n, compiled.n_eps).astype(
            config.complex_dtype)
        # output linearization along the orbit (∂obs/∂x per sample; the
        # stationary noise() makes the same xdot-independence assumption)
        e_j = jax.vmap(
            lambda x, xd, t: jax.grad(
                lambda xx: obs(xx, xd, ctx_t.at_time(t), params))(x))(
            xs, jnp.asarray(res.xdot_samples, d), ts)    # [N, n]
        Gc = G.astype(config.complex_dtype)
        Cc = C.astype(config.complex_dtype)
        A0 = jnp.einsum("jl,lab->jalb", D.astype(config.complex_dtype), Cc)
        A0 = A0.at[jnp.arange(N), :, jnp.arange(N), :].add(Gc)
        A0 = A0.reshape(N * n, N * n)
        Cblk = jnp.zeros((N, n, N, n), config.complex_dtype)
        Cblk = Cblk.at[jnp.arange(N), :, jnp.arange(N), :].set(Cc)
        Cblk = Cblk.reshape(N * n, N * n)
        jgrid = jnp.arange(N)

        def one(wi, kk):
            A = A0 + 1j * wi.astype(config.complex_dtype) * Cblk
            # L_k functional: (1/N)·Σ_j e^{−i2πjk/N}·e_j·u_j
            ph = jnp.exp(-2j * jnp.pi * jgrid * kk / N) / N
            ev = (ph[:, None] * e_j.astype(config.complex_dtype)
                  ).reshape(N * n)
            v = linalg.solve(A.T, ev)
            return v @ Cfull                              # [n_eps]

        return jax.vmap(one)(w_in, k_flat)

    Tmat = np.asarray(run()).reshape(len(freqs), len(ks), compiled.n_eps)
    _, ex = compiled.noise_sources(
        jnp.asarray(res.x_samples[0], d), ctx_t.at_time(ts[0]), params)
    ex = np.asarray(ex)
    # flicker weight at the folded input frequency (clamped away from the
    # k·f0 = f singularity)
    nu_abs = np.maximum(np.abs(nu), 1e-12)
    w = nu_abs[:, :, None] ** (-ex[None, None, :])
    per = (np.abs(Tmat) ** 2 * w).sum(axis=1)            # [nf, n_eps]
    names = []
    for key in compiled.group_order:
        g = compiled.groups[key]
        for inst in g.instances:
            for k in range(g.model.n_noise):
                names.append(f"{inst.name}#n{k}")
    return PNoiseSolution(freqs=freqs, psd=per.sum(axis=1), per_source=per,
                          eps_names=names, hbres=res, k_sidebands=K)


@dataclasses.dataclass
class PhaseNoiseResult:
    """Oscillator phase noise via the perturbation projection vector
    (Demir/Mehrotra/Roychowdhury, "Phase noise in oscillators: a unifying
    theory", TCAS-I 2000).

    ``c`` is the time-shift diffusion constant (seconds): the variance of
    the oscillator's accumulated time jitter grows as ``c·t``, so the RMS
    jitter after n periods is ``sqrt(c·n·T)``.  The carrier-normalized
    spectrum is the Lorentzian  L(Δf) = f0²c / (π²f0⁴c² + Δf²).
    """
    c: float                   # phase (time-shift) diffusion constant [s]
    ppv: np.ndarray            # [N, n_x] PPV samples (time-shift normalized)
    per_source: np.ndarray     # [n_eps] contribution of each source to c
    eps_names: list
    hbres: HBResult
    #: quality metrics: relative spread of the biorthogonality product
    #: v(t)·C(t)·ẋ(t) across samples (≪1 for a trustworthy PPV), and the
    #: relative residual of the right null vector ẋ
    norm_spread: float
    null_resid: float

    def jitter(self, n_periods: float = 1.0) -> float:
        """RMS accumulated jitter after ``n_periods`` [s]."""
        return float(np.sqrt(self.c * n_periods * self.hbres.period))

    def ldbc(self, offsets) -> np.ndarray:
        """Phase noise L(Δf) in dBc/Hz at offset frequencies [Hz]."""
        df = np.atleast_1d(np.asarray(offsets, float))
        f0 = self.hbres.freq
        s = f0 ** 2 * self.c / (np.pi ** 2 * f0 ** 4 * self.c ** 2
                                + df ** 2)
        return 10.0 * np.log10(np.maximum(s, 1e-300))


def oscillator_phase_noise(res: HBResult, inv_iters: int = 3
                           ) -> PhaseNoiseResult:
    """Phase noise of an autonomous oscillator from its HB orbit.

    The orbit's time derivative ẋ(t) is the right null function of the
    linearized periodic operator A (the same collocation Jacobian Newton
    used); the PPV v(t) is the LEFT null function, normalized by the
    Floquet biorthogonality v(t)ᵀC(t)ẋ(t) = 1 — computed here by inverse
    iteration on Aᵀ (A is singular exactly to the HB convergence
    tolerance, so one LU back-solve per iteration snaps onto the null
    direction).  Each white noise source s, entering through the
    amplitude-modulated column c_s(t) = ∂F/∂ε_s·sqrt(pwr_s(t)) with
    double-sided PSD ½ (our ``pwr`` is single-sided), contributes

        c = (1/2N) Σ_j Σ_s (v_jᵀ c_{s,j})²   [seconds]

    to the time-shift diffusion.  Flicker sources are excluded (white-only,
    like the transient-noise path)."""
    compiled, params = res.compiled, res.params
    d = compiled.dtype
    N, n = res.x_samples.shape
    T = res.period
    w = 2.0 * np.pi / T
    Dhat = jnp.asarray(_diff_matrix(N, np.float64), d)
    ctx_t = res.ctx.with_mode(Modes.TRAN)
    xs = jnp.asarray(res.x_samples, d)
    ts = jnp.asarray(res.t_samples, d)

    @jax.jit
    def run():
        G, C = jax.vmap(
            lambda x, t: compiled.jacobians(x, ctx_t.at_time(t), params))(
                xs, ts)
        A = jnp.einsum("jl,lab->jalb", w * Dhat, C)
        A = A.at[jnp.arange(N), :, jnp.arange(N), :].add(G)
        A = A.reshape(N * n, N * n)
        # right null vector: the orbit derivative (sanity check only)
        r0 = jnp.asarray(res.xdot_samples, d).reshape(N * n)
        null_resid = (jnp.linalg.norm(A @ r0)
                      / (jnp.linalg.norm(A, ord="fro")
                         * jnp.linalg.norm(r0) / (N * n) + 1e-300))
        # left null vector by inverse iteration on Aᵀ
        v = jnp.ones(N * n, d)
        for _ in range(inv_iters):
            v = linalg.solve(A.T, v)
            v = v / jnp.linalg.norm(v)
        V = v.reshape(N, n)
        # biorthogonality normalization v_jᵀ C_j ẋ_j = 1
        xd = jnp.asarray(res.xdot_samples, d)
        s = jnp.einsum("ja,jab,jb->j", V, C, xd)
        V = V / jnp.mean(s)
        spread = jnp.std(s) / jnp.abs(jnp.mean(s))
        # modulated white-noise columns
        if compiled.n_eps:
            Jeps = jax.vmap(
                lambda x, t: jax.jacfwd(
                    lambda e: compiled.residuals(
                        x, ctx_t.at_time(t), params, eps=e)[0])(
                    jnp.zeros(compiled.n_eps, d)))(xs, ts)  # [N, n, n_eps]
            pwr, ex = jax.vmap(
                lambda x, t: compiled.noise_sources(
                    x, ctx_t.at_time(t), params))(xs, ts)
            white = (ex[0] == 0.0)
            Cmod = Jeps * (jnp.sqrt(jnp.maximum(pwr, 0.0))
                           * white[None, :])[:, None, :]
            proj = jnp.einsum("ja,jas->js", V, Cmod)        # [N, n_eps]
            per = jnp.sum(proj ** 2, axis=0) / (2.0 * N)    # [n_eps]
        else:
            per = jnp.zeros((0,), d)
        return V, per, spread, null_resid

    V, per, spread, null_resid = run()
    names = []
    for key in compiled.group_order:
        g = compiled.groups[key]
        for inst in g.instances:
            for k in range(g.model.n_noise):
                names.append(f"{inst.name}#n{k}")
    per = np.asarray(per)
    return PhaseNoiseResult(c=float(per.sum()), ppv=np.asarray(V),
                            per_source=per, eps_names=names, hbres=res,
                            norm_spread=float(spread),
                            null_resid=float(null_resid))


def hb_autonomous(compiled: CompiledCircuit, period_guess: float,
                  anchor: str, params=None, ctx: SimSpec = None,
                  n_harmonics: int = 15, max_iter: int = 40,
                  tol: float = 1e-9, damping: float = 1.0,
                  warmup_periods: float = 8.0, kick: float = 0.0,
                  tran_opts: TranOptions = None) -> HBResult:
    """Harmonic-balance PSS of an autonomous oscillator: the period is a
    Newton unknown.

    ``anchor`` names a net whose spectral derivative is pinned to zero at
    sample 0 (the phase gauge — pick a node that genuinely oscillates).
    ``period_guess`` seeds both ω and the transient warm-up used for the
    waveform guess; the warm-up's final upswing of the anchor node is
    phase-aligned so the anchor condition starts near-satisfied.

    ``kick``: startup perturbation added to the anchor state before the
    warm-up transient.  An oscillator's operating point is an (often
    exactly metastable) equilibrium — the adaptive integrator would sit on
    it forever, where real hardware starts from noise.  Pick a fraction of
    the expected swing (e.g. 0.1·VDD for a ring).
    """
    _reject_aux_channels(compiled, "harmonic balance")
    params = compiled.params0 if params is None else params
    ctx = default_ctx(compiled) if ctx is None else ctx
    d = compiled.dtype
    N = 2 * int(n_harmonics) + 1
    n = compiled.n_x
    Dhat = jnp.asarray(_diff_matrix(N, np.float64), d)   # d/dθ, θ∈[0,2π)
    ctx_t = ctx.with_mode(Modes.TRAN)
    net = compiled.circuit._nets.get(anchor)
    if net is None or net.is_ground:
        raise ValueError(f"anchor {anchor!r} must be a non-ground net")
    sel = net.index
    theta = np.arange(N) * (2.0 * np.pi / N)

    # The sources of an autonomous circuit are constant in TRAN mode, so
    # residuals may be evaluated at any fixed time.
    t_eval = jnp.asarray(0.0, d)

    def parts(xs):
        S, Q = jax.vmap(
            lambda x: compiled.residuals(x, ctx_t.at_time(t_eval), params))(
                xs)
        return S, Q

    @jax.jit
    def r_fn(z):
        xs, w = z
        S, Q = parts(xs)
        r = S + w * (Dhat @ Q)
        a = (Dhat @ xs)[0, sel]            # phase anchor: ẋ_sel(θ=0) = 0
        return jnp.concatenate([r.reshape(-1), a[None]])

    @jax.jit
    def step_fn(z):
        xs, w = z
        S, Q = parts(xs)
        r = S + w * (Dhat @ Q)
        G, C = jax.vmap(
            lambda x: compiled.jacobians(x, ctx_t.at_time(t_eval), params))(
                xs)
        J = jnp.einsum("jl,lab->jalb", w * Dhat, C)
        J = J.at[jnp.arange(N), :, jnp.arange(N), :].add(G)
        J = J.reshape(N * n, N * n)
        drdw = (Dhat @ Q).reshape(N * n, 1)
        arow = jnp.zeros((1, N * n), d)
        arow = arow.at[0, jnp.arange(N) * n + sel].set(Dhat[0, :])
        A = jnp.block([[J, drdw], [arow, jnp.zeros((1, 1), d)]])
        rhs = -jnp.concatenate([r.reshape(-1), (Dhat @ xs)[0, sel][None]])
        dz = linalg.solve(A, rhs)
        return dz[:-1].reshape(N, n), dz[-1]

    # --- initial guess: transient warm-up, phase-aligned on the anchor ---
    T0 = float(period_guess)
    x0w = None
    if kick:
        op = solve_dc(compiled, params, ctx, mode=Modes.TRANOP)
        x0w = np.asarray(op.x).copy()
        x0w[sel] += kick
        x0w = jnp.asarray(x0w, d)
    t_total = (warmup_periods + 2.0) * T0
    sol = tran(compiled, (0.0, t_total), params=params,
               ctx=ctx, opts=tran_opts, x0=x0w)
    # Refine the period estimate from the mean spacing of the anchor's
    # rising midlevel crossings over the settled tail.  The window must be
    # several guessed periods long: if the guess is far off (a ring's
    # period is hard to eyeball) a one-period window sees at most one
    # crossing and the stale guess can steer Newton onto a spurious
    # higher-mode orbit (a genuine but unstable HB solution).
    t_lo = max(0.0, t_total - max(5.0 * T0, 0.5 * t_total))
    tq = np.linspace(t_lo, t_total, 8192)
    y = np.interp(tq, sol.ts, np.asarray(sol[anchor]))
    mid = 0.5 * (y.max() + y.min())
    up = np.where((y[:-1] < mid) & (y[1:] >= mid))[0]
    T_est = T0
    if len(up) >= 3:
        # sub-sample crossing times by linear interpolation; use the last
        # few intervals (most settled)
        tc = tq[up] + (mid - y[up]) / (y[up + 1] - y[up]) * (tq[1] - tq[0])
        T_est = float(np.mean(np.diff(tc)[-4:]))
    elif len(up) == 2:
        T_est = float(up[1] - up[0]) * (tq[1] - tq[0])
    # start the grid at the anchor's maximum (ẋ_sel ≈ 0 there), placed so
    # the whole grid period lies inside the integrated span
    w_lo = max(t_lo, t_total - 2.0 * T_est)
    w_hi = max(w_lo + 1e-300, t_total - T_est)
    tq2 = np.linspace(w_lo, w_hi, 1024, endpoint=False)
    y2 = np.interp(tq2, sol.ts, np.asarray(sol[anchor]))
    t_start = tq2[int(np.argmax(y2))]
    ts0 = t_start + theta / (2.0 * np.pi) * T_est
    xs0 = jnp.asarray(
        np.stack([np.asarray(sol.interp_state(t)) for t in ts0]), d)
    w0 = jnp.asarray(2.0 * np.pi / T_est, d)

    scale = float(jnp.max(jnp.abs(xs0))) + 1.0
    z, converged, it, rn = _newton(r_fn, step_fn, (xs0, w0), tol * scale,
                                   max_iter, damping)
    xs, w = z
    T = float(2.0 * np.pi / float(w))
    ts = theta / (2.0 * np.pi) * T
    xd = np.asarray(float(w) * (Dhat @ xs))
    return HBResult(compiled=compiled, params=params, ctx=ctx,
                    t_samples=ts, x_samples=np.asarray(xs),
                    xdot_samples=xd, period=T, converged=bool(converged),
                    iters=it, resnorm=rn, n_harmonics=int(n_harmonics))

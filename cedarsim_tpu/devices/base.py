"""Device model protocol — the replacement for the reference's
trace-time circuit-element runtime (Net/branch!/kcl! intrinsics,
/root/reference/src/simulate_ir.jl:28-140).

Design
======
Instead of tracing per-instance device closures (which the reference's
DAECompiler then abstract-interprets), every device *class* defines one pure
function ``eval(lv, p, ctx, eps)`` evaluated **vectorized over all instances of
the class** via ``jax.vmap``.  The compiler (core/compile.py) gathers each
instance's local unknowns out of the global MNA vector with precomputed index
arrays, vmaps ``eval``, and scatter-adds the returned contributions into the
global residual.  Jacobians come from ``jax.jacfwd`` of the same function —
small dense per-instance blocks scattered into the global matrix.  This is the
"model-eval parallelism" the reference lacks (SURVEY.md §2.11): all FLOPs are
batched, static-shaped, and fuse into a handful of XLA kernels.

Local unknown vector ``lv`` layout (length ``n_lvar``)::

    [ V(terminal_0..k), V(internal_0..m), I(branch_0..b), control_0..c ]

Local equation rows (length ``n_lrow``)::

    [ KCL(terminal_0..k), KCL(internal_0..m), branch-eq_0..b ]

``eval`` returns ``(static, dynamic)`` row contributions such that the global
DAE residual is ``F(x, t) = S(x, t) + d/dt Q(x)``:

  * resistive current out of a net into the device  → ``static`` on a KCL row
  * charge pulled out of a net into the device      → ``dynamic`` on a KCL row
  * algebraic branch constraints (e.g. Vsrc: V(p)-V(n)-V0) → ``static`` on a
    branch row; flux terms (inductor −L·i) → ``dynamic`` on a branch row.

Sign convention: branch current flows p→n *through the device*; a device's
KCL contribution on terminal t is the current flowing out of net t into the
device.  This matches SPICE (I(V1) is the current entering the + terminal).

Noise: a device declares ``n_noise`` independent noise sources.  ``eval``
receives ``eps`` (zeros in normal simulation, exactly like DAECompiler
``epsilon`` intrinsics, /root/reference/src/va_env.jl:82-90) and must add
``eps[k] * unit-current`` into the rows the k-th source drives.  ``noise``
returns the per-source PSD parameters (power, flicker exponent) evaluated at
the operating point; the noise analysis builds ∂F/∂eps columns via jacfwd.
"""

from __future__ import annotations

import jax.numpy as jnp


class DeviceModel:
    """Base class for batched device models.

    Subclasses set class attributes and implement ``eval`` as a @staticmethod
    over *scalar per-instance* values (the compiler vmaps it).
    """

    #: terminal names in port order
    terminals: tuple = ()
    #: number of internal nodes (allocated per instance by the compiler)
    n_internal: int = 0
    #: number of branch-current unknowns
    n_branch: int = 0
    #: number of extra gathered control unknowns (e.g. a sensed branch current)
    n_control: int = 0
    #: number of noise sources
    n_noise: int = 0
    #: exact-history delayed-value inputs (VA absdelay, delay_mode="history");
    #: the aux vector passed to ``eval`` is [n_noise noise, n_delay delayed,
    #: n_latch latched]
    n_delay: int = 0
    #: event-latched state slots (LRM-exact transition() ramps, zi_* sampled
    #: filters): the integrator carries them across steps, seeds them with
    #: ``latch0(lv, p, ctx)`` at the operating point, and updates them with
    #: ``latch(lv, p, ctx, lat)`` after every ACCEPTED step (ctx.time = the
    #: accepted time) — the lax.while_loop replacement for an event queue
    n_latch: int = 0
    #: parameter defaults: dict name -> float. All params become traced arrays.
    params: dict = {}
    #: params for which a "was it given" mask is needed ($param_given /
    #: DefaultOr semantics, /root/reference/src/util.jl:23-51). For these,
    #: eval's ``p`` dict additionally holds boolean ``name + "$given"``.
    given_params: tuple = ()

    @classmethod
    def n_terms(cls):
        return len(cls.terminals)

    @classmethod
    def n_lvar(cls):
        return len(cls.terminals) + cls.n_internal + cls.n_branch + cls.n_control

    @classmethod
    def n_lrow(cls):
        return len(cls.terminals) + cls.n_internal + cls.n_branch

    @classmethod
    def group_key(cls, inst_params):
        """Key used to batch instances together.  Instances whose key matches
        are stacked into one vmapped eval.  Subclasses override when static
        structure differs per instance (e.g. PWL point-count buckets)."""
        return cls.__name__

    @staticmethod
    def eval(lv, p, ctx, eps):
        """Scalar-instance evaluation. Returns (static, dynamic) rows."""
        raise NotImplementedError

    @classmethod
    def noise(cls, lv, p, ctx):
        """Per-source noise PSD at the operating point: returns
        ``(power, exponent)`` arrays of length n_noise, meaning a current PSD
        of ``power * f**(-exponent)`` A²/Hz — the reference's
        white_noise/flicker_noise encoding (/root/reference/src/va_env.jl:82-90).
        """
        z = jnp.zeros((cls.n_noise,))
        return z, z

    @classmethod
    def ac_rhs(cls, p):
        """Complex AC drive contributions per local row (length n_lrow).
        Only independent sources with an ``ac`` magnitude return nonzero.
        Evaluated per-instance (vmapped); assembled into the AC right-hand
        side b of (G + jωC)x = b."""
        return None

    @classmethod
    def prepare(cls, raw: dict) -> dict:
        """Normalize a user/netlist parameter dict into the full param dict
        (defaults filled, given-masks added). Values stay python/num scalars
        or numpy arrays; stacking happens in the compiler."""
        p = {}
        for name, default in cls.params.items():
            if name in cls.given_params:
                p[name + "$given"] = float(name in raw and raw[name] is not None)
            v = raw.get(name)
            p[name] = default if v is None else v
        unknown = set(raw) - set(cls.params)
        if unknown:
            raise ValueError(
                f"{cls.__name__}: unknown parameter(s) {sorted(unknown)}")
        return p

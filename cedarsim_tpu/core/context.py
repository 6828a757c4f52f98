"""Simulation-wide context.

The reference threads a ``SimSpec`` plus a ``sim_mode`` symbol through every
device via Julia ScopedValues (/root/reference/src/simulate_ir.jl:12-24).  Here
the context is an explicit pytree argument: traced numeric fields (time,
temperature, gmin, ...) plus a *static* analysis mode string that selects one
of a small number of compiled variants — matching the reference's
``sim_mode ∈ (:dcop, :tranop, :tran, :ac)`` behavior for sources
(/root/reference/src/simpledevices.jl:274-300).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from cedarsim_tpu import config


class Modes:
    """Analysis modes (static compile-time switch).

    - ``DCOP``:   DC operating point; sources report their DC value, time=0.
    - ``TRANOP``: initial operating point for transient; sources report their
      transient waveform value at t=0 (falling back to DC).
    - ``TRAN``:   transient; sources follow their waveforms at ctx.time.
    - ``AC``:     small-signal linearization point (same large-signal values as
      DCOP; the AC drive is assembled separately).
    """

    DCOP = "dcop"
    TRANOP = "tranop"
    TRAN = "tran"
    AC = "ac"

    ALL = (DCOP, TRANOP, TRAN, AC)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["time", "temp", "gmin", "scale", "sourcefac", "mc_key"],
    meta_fields=["mode"],
)
@dataclasses.dataclass(frozen=True)
class SimSpec:
    """Simulation context handed to every device eval.

    Mirrors the reference ``SimSpec`` fields time/temp/gmin/scale/rng
    (/root/reference/src/simulate_ir.jl:12-20).  ``sourcefac`` is an addition:
    a 0..1 homotopy factor that independent sources multiply, used by the DC
    source-stepping continuation (the reference instead retries Newton from
    random points, /root/reference/src/dcop.jl:53-94 — we support both).
    """

    time: jax.Array = dataclasses.field(default=None)
    temp: jax.Array = dataclasses.field(default=None)     # Kelvin
    gmin: jax.Array = dataclasses.field(default=None)
    scale: jax.Array = dataclasses.field(default=None)
    sourcefac: jax.Array = dataclasses.field(default=None)
    mc_key: jax.Array = dataclasses.field(default=None)   # PRNG key for Monte-Carlo
    mode: str = Modes.TRAN

    @staticmethod
    def make(mode=Modes.TRAN, time=0.0, temp_c=27.0, gmin=1e-12, scale=1.0,
             sourcefac=1.0, mc_key=None, dtype=None):
        if mc_key is None:
            mc_key = jax.random.PRNGKey(0)
        # Scalar fields stay host floats: they fold as compile-time constants
        # in traces (device evals short-circuit concrete math on the host),
        # and as jit arguments they become tracers anyway.  Keeping them off
        # the device also keeps eager device round trips out of tracing.
        return SimSpec(
            time=float(time),
            temp=float(temp_c) + config.T_ZERO_C,
            gmin=float(gmin),
            scale=float(scale),
            sourcefac=float(sourcefac),
            mc_key=mc_key,
            mode=mode,
        )

    def at_time(self, t):
        return dataclasses.replace(self, time=t)

    def with_mode(self, mode):
        return dataclasses.replace(self, mode=mode)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def temp_c(self):
        """Temperature in Celsius — SPICE ``temper()``
        (/root/reference/src/spectre_env.jl:198)."""
        return self.temp - config.T_ZERO_C

    @property
    def vt(self):
        """Thermal voltage kT/q."""
        return self.temp * (config.K_BOLTZMANN / config.Q_CHARGE)

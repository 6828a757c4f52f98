"""Global configuration for cedarsim_tpu.

Circuit simulation needs f64: conductances span ~15 decades (gmin=1e-12 up to
k-ohm-level conductances) and Newton convergence tolerances are ~1e-6
relative.  States, Jacobians and the linear solves
(``cedarsim_tpu.ops.linalg``, XLA's native f64 LU) run in f64; compact-model
evaluation may opt into f32 per circuit (``compile_circuit(eval_dtype=...)``).

Set CEDARSIM_TPU_NO_X64=1 to opt out of enabling x64 globally (e.g. when
embedding into an ML program that must stay f32).
"""

import os

import jax
import jax.numpy as jnp

if not os.environ.get("CEDARSIM_TPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

#: The checkout the package runs from.  Every cache the package keeps for
#: itself lives in it: compiled XLA programs (below), DC warm starts
#: (utils/artifacts.py) and the native planner library (native/).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Persistent XLA compilation cache: circuit solvers are large traced programs
# (Newton + continuation + adaptive stepping); caching compiled executables
# across processes addresses the reference's known weak point — compile
# latency "often exceeding simulation time" (/root/reference/README-CedarSim.md:28).
# JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is unset does the
# cache go to one fixed directory in the checkout (a path that moves never
# hits, since the directory is part of what a later process looks up).
CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    CHECKOUT, ".jax_cache")
#: DC warm starts and the built native library, unless the environment
#: variables those modules read say otherwise.
LOCAL_CACHE = os.path.join(CHECKOUT, ".cedarsim_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

#: Default real dtype for simulator state.
real_dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32

#: how Verilog-A ``absdelay`` lowers by default: "pade" (Padé(3,3) all-pass
#: companion states, every analysis) or "history" (exact history
#: interpolation through the integrator's ring buffer; transient + DC only).
#: Per-model override: ``va.codegen.make_device(module, delay_mode=...)``.
va_delay_mode = "pade"

#: How VA ``transition()`` lowers: "smooth" (exponential edge shaping via a
#: companion state; all analyses) or "latch" (LRM-exact linear ramps over
#: the integrator's latched-state channel; AC treats it as unity gain).
#: Per-model override: ``va.codegen.make_device(module, transition_mode=...)``.
va_transition_mode = "smooth"

#: Default complex dtype (AC / noise analyses).
complex_dtype = jnp.complex128 if jax.config.read("jax_enable_x64") else jnp.complex64

#: Boltzmann constant (J/K) — matches reference usage for thermal noise
#: (/root/reference/src/simpledevices.jl:49-77).
K_BOLTZMANN = 1.380649e-23
#: Elementary charge (C).
Q_CHARGE = 1.602176634e-19
#: 0 Celsius in Kelvin.
T_ZERO_C = 273.15

#: Trace-time jaxpr cache for compact-model evaluation: trace each model's
#: eval once per (static-params, aval) signature and replay the jaxpr at
#: later trace sites (core/compile.cached_model_eval).  Cuts VA re-trace
#: cost; the emitted jaxpr (and so XLA compile + numerics) is identical.
trace_cache = True

#: Emit each cached model-eval subgraph as a nested jit CALL (a pjit
#: primitive per site sharing one computation) instead of inlining the
#: replayed jaxpr equations at every site.  On the BSIM4 DFF transient it
#: shortened tracing, left XLA compile time unchanged (XLA inlines the calls
#: before optimizing) and made the compiled program slower (call overhead
#: in the hot while_loop).  Off by default; kept as the measured negative
#: result and for trace-bound experimentation.
call_wrap = False

"""cedarsim_tpu — a SPICE-class analog circuit simulation framework on
JAX/XLA, running on a GPU or the CPU.

Capabilities modeled on NyanCAD/CedarSim.jl (see SURVEY.md): SPICE/Spectre and
Verilog-A netlists compile into pure JAX residual/Jacobian functions with
static structure derived from the circuit graph; DC operating point, transient
(adaptive implicit stepping inside ``lax.while_loop``), AC, and noise analyses
run entirely on-device; parameter sweeps and Monte-Carlo are ``vmap`` batches
sharded across device meshes.

Unlike the reference (Julia metaprogramming + DAECompiler abstract
interpretation, /root/reference/src/CedarSim.jl), this framework lowers the
netlist directly: device classes evaluate as vectorized jitted kernels over
instance parameter arrays, and the MNA structure is explicit data, not
intercepted IR.
"""

from cedarsim_tpu import config  # noqa: F401  (applies x64 default)

from cedarsim_tpu.core.context import SimSpec, Modes
from cedarsim_tpu.core.circuit import Circuit, Net, GROUND
from cedarsim_tpu.core.compile import compile_circuit, CompiledCircuit
from cedarsim_tpu.devices import (
    Resistor, Capacitor, Inductor, Diode,
    VSource, VSourcePWL, VSourcePULSE, VSourceSIN,
    ISource, ISourcePWL, ISourcePULSE, ISourceSIN,
    VCVS, VCCS, CCVS, CCCS, TLine,
)
from cedarsim_tpu.analysis.dc import solve_dc, NewtonOptions
from cedarsim_tpu.analysis.tran import (tran, TranOptions, save_checkpoint,
                                        load_checkpoint)
from cedarsim_tpu.analysis.ac import ac, acdec, noise
from cedarsim_tpu.analysis.pss import pss
from cedarsim_tpu.analysis.hb import (hb, hb_autonomous, pac, pnoise,
                                      oscillator_phase_noise)
from cedarsim_tpu.analysis.sweeps import (
    Sweep, ProductSweep, TandemSweep, SerialSweep, sweepify, dc_sweep,
)
from cedarsim_tpu.frontend.parser import parse_spice
from cedarsim_tpu.frontend.elaborate import load_spice, elaborate
from cedarsim_tpu.api import simulate

__version__ = "0.1.0"

"""Generate the trusted golden for the BSIM-CMG DFF benchmark.

The reference gates its gf180 DFF run on Q at 150/250/450/550/700 ns
(/root/reference/test/gf180_dff.jl:28-35) — levels that depend on the device
physics (its 401 ns CLKN/D race resolves per-model).  Since the gf180 BSIM4
cards are not redistributable here, the benchmark runs BSIM-CMG 107 at 1 V
and this script regenerates the golden from two *independent* tight-tolerance
small-step runs (different hmax / tolerances); they must agree at every
sample point before the golden is written.  Run on CPU:

    python benchmarks/gf180_dff/make_golden_cmg.py
"""

import json
import os
import sys

import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

D = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(D)))

SAMPLES_NS = [150.0, 250.0, 450.0, 550.0, 700.0]
VDD = 1.0


def run(hmax_frac, rtol, atol):
    from cedarsim_tpu import (parse_spice, elaborate, compile_circuit, tran,
                              TranOptions, SimSpec)
    nl = parse_spice(open(os.path.join(D, "dff_tb_cmg.cir")).read(),
                     file="dff_tb_cmg.cir")
    c = compile_circuit(elaborate(nl, include_paths=[D]))
    ctx = SimSpec.make(gmin=1e-15)
    sol = tran(c, (0.0, 7e-7), ctx=ctx,
               opts=TranOptions(max_steps=65536, hmax_frac=hmax_frac,
                                rtol=rtol, atol=atol))
    assert sol.converged, "golden run did not converge"
    qs = [float(sol.interp("q", t * 1e-9)) for t in SAMPLES_NS]
    return qs, dict(accepted=int(sol.n_accepted), rejected=int(sol.n_rejected),
                    hmax_frac=hmax_frac, rtol=rtol, atol=atol)


def main():
    qa, meta_a = run(hmax_frac=5e-5, rtol=1e-5, atol=1e-9)   # hmax = 35 ps
    qb, meta_b = run(hmax_frac=2e-5, rtol=3e-6, atol=3e-10)  # hmax = 14 ps
    print("run A:", [f"{q:.5f}" for q in qa], meta_a)
    print("run B:", [f"{q:.5f}" for q in qb], meta_b)
    for t, a, b in zip(SAMPLES_NS, qa, qb):
        assert abs(a - b) < 1e-3, f"runs disagree at {t} ns: {a} vs {b}"
        level = round(a / VDD)
        assert abs(a - level * VDD) < 0.02, \
            f"Q({t} ns)={a} is not settled at a logic level — unusable golden"
    golden = {
        "description": "BSIM-CMG 107 DFF golden Q levels, cross-checked "
                       "between two independent tight-tolerance runs",
        "vdd": VDD,
        "samples_ns": SAMPLES_NS,
        "q": [round(q, 6) for q in qa],
        "levels": [round(q / VDD) for q in qa],
        "tolerance": 0.02,
        "runs": [meta_a, meta_b],
    }
    with open(os.path.join(D, "golden_cmg.json"), "w") as f:
        json.dump(golden, f, indent=1)
    print("golden written:", golden["levels"])


if __name__ == "__main__":
    main()

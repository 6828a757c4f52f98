"""Benchmark harness: golden-gated DFF transients/s on one GPU.

Headline: the reference's flagship benchmark — the gf180-topology DFF
transient (the reference's test/DFF/DFF_cap_all.cir stimulus/loads) on a
**BSIM4-class compact model** (cedarsim_tpu/models/bsim4.va), correctness-
gated on all five reference sample times incl. the 401 ns CLKN/D race edge
(reference test/gf180_dff.jl:28-35).  The golden levels come from two
independent tight-tolerance f64 runs
(benchmarks/gf180_dff/make_golden_bsim4.py).

Metric: transients/s over a batch of nb=128 concurrent transients with a
+-1 % W scatter (Monte-Carlo style — the production PVT workload), run
through ``tran_sweep_sharded`` on one card with the library's f64 defaults.
The gate: the exactly-nominal middle lane must reproduce all five golden
points, every scattered lane the three non-race points (``chip_smoke.
golden_gate``).  Compile time (first call minus the warm second call) is
reported apart from the timed run and never folded into a rate.

Extra legs: the BSIM4 DFF single-stream through ``tran()`` and the BSIM-CMG
DFF single-stream, both gated on their goldens.

    python bench.py

Runs on a GPU or exits non-zero; the last line is one compact JSON record
carrying the device (platform, device_kind, count) and the card's
``nvidia-smi`` name and power limit.
"""

import json
import os
import sys
import time

import chip_smoke as cs

NB = 128


def batched_leg(nb=NB):
    import jax
    from cedarsim_tpu.parallel.mesh import make_mesh
    comp = cs.build_dff("dff_tb_bsim4.cir")
    mesh = make_mesh(1)

    def run():
        res = cs.dff_sweep(comp, nb, mesh)
        jax.block_until_ready(res.xs)
        return res
    res, comp_s, run_s = cs.timed_twice(run)
    gate, _ = cs.gate_sweep(comp, res, nb)
    return dict(nb=nb, **gate, compile_s=comp_s,
                wall_s=run_s, transients_per_sec=nb / run_s,
                solves_per_sec=gate["newton"] / run_s)


def single_leg(tb, golden):
    from cedarsim_tpu import tran, TranOptions
    from cedarsim_tpu.core.compile import default_ctx
    comp = cs.build_dff(tb)
    opts = TranOptions(max_steps=16384)
    sol, comp_s, run_s = cs.timed_twice(
        lambda: tran(comp, (0.0, 7e-7), ctx=default_ctx(comp), opts=opts))
    ok, worst, _ = cs.golden_gate(cs.load_golden(golden), sol.ts, sol["q"],
                                  nominal=0)
    return dict(golden_ok=bool(ok and sol.converged), worst_golden_err=worst,
                newton=int(sol.n_newton), accepted=int(sol.n_accepted),
                rejected=int(sol.n_rejected), compile_s=comp_s,
                wall_s=run_s, solves_per_sec=sol.n_newton / run_s)


def main():
    dev = cs.require_gpu()
    smi = cs.nvidia_smi()
    t0 = time.monotonic()
    b4 = batched_leg()
    extra = {f"bsim4_{k}": v for k, v in b4.items()}
    for name, tb, golden in (("bsim4_single", "dff_tb_bsim4.cir",
                              "golden_bsim4.json"),
                             ("cmg_single", "dff_tb_cmg.cir",
                              "golden_cmg.json")):
        extra.update({f"{name}_{k}": v
                      for k, v in single_leg(tb, golden).items()})
    ok = all(v for k, v in extra.items() if k.endswith("golden_ok"))
    extra["elapsed_s"] = round(time.monotonic() - t0, 1)
    print(json.dumps(dict(
        metric="bsim4_dff_transients_per_sec",
        value=b4["transients_per_sec"] if ok else 0.0,
        unit="transients/s", ok=ok, device=dev, nvidia_smi=smi,
        xla_flags=os.environ.get("XLA_FLAGS", ""), extra=extra),
        separators=(",", ":")), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

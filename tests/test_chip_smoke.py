"""The smoke run's contract, checked without a GPU: it refuses a CPU-only
process, its golden gate accepts the DFF golden and rejects a flipped lane,
and its last line is exactly the device record.  ``test_chip_smoke_on_gpu``
runs the whole script where a GPU is present."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _golden_waves(golden, lanes):
    """Q waveforms on a 1 ns grid that pass through every golden sample."""
    t = np.asarray(golden["samples_ns"]) * 1e-9
    ts = np.arange(0.0, 701e-9, 1e-9)
    qs = np.interp(ts, t, golden["q"])
    return np.tile(ts, (lanes, 1)), np.tile(qs, (lanes, 1))


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_cpu_only_process(script):
    p = subprocess.run([sys.executable, os.path.join(REPO, script)],
                       env=_cpu_env(), cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "no GPU" in p.stderr


def test_golden_gate_accepts_golden():
    g = chip_smoke.load_golden("golden_bsim4.json")
    ts, qs = _golden_waves(g, lanes=5)
    ok, worst, race = chip_smoke.golden_gate(g, ts, qs, nominal=2)
    assert ok and worst < 1e-12 and race == 1.0


def test_golden_gate_rejects_nominal_lane_flipped_at_race_edge():
    g = chip_smoke.load_golden("golden_bsim4.json")
    ts, qs = _golden_waves(g, lanes=5)
    # the nominal lane resolves the 401 ns CLKN/D race the other way: Q
    # rises to VDD after 401 ns and the 450/550 ns samples read 5 V
    qs[2, ts[2] > 401e-9] = g["vdd"]
    ok, worst, _ = chip_smoke.golden_gate(g, ts, qs, nominal=2)
    assert not ok and worst == pytest.approx(g["vdd"])
    # the same flip on a scattered lane only lowers race agreement
    ts, qs = _golden_waves(g, lanes=5)
    qs[0, (ts[0] > 401e-9) & (ts[0] < 600e-9)] = g["vdd"]
    ok, _, race = chip_smoke.golden_gate(g, ts, qs, nominal=2)
    assert ok and race == pytest.approx(6 / 8)


def test_rail_error_reads_each_cell_output():
    class Chain:
        node_names = ["vdd", "d0", "d1", "d2", "d3", "d4"]
    x = np.array([5.0, 2.5, 5.0 - 1e-3, 2e-3, 4.9, 2.5])
    # d0 (the driven input) and d4 (past the last cell asked for) are not
    # cell outputs of a 3-cell chain
    assert chip_smoke.rail_error(Chain, x, 3) == pytest.approx(0.1)


def test_result_line_is_exactly_the_contract():
    dev = dict(platform="gpu", kind="NVIDIA H100 80GB HBM3", count=1)
    line = chip_smoke.result_line(dict(dev, extra="dropped"))
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": dev}


@pytest.mark.gpu
def test_chip_smoke_on_gpu():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip() != "gpu":
        pytest.skip("needs a GPU: JAX found none in a fresh process")
    p = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=1500)
    assert p.returncode == 0, p.stderr[-3000:]
    last = json.loads(p.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"

"""Interactive parameter exploration — the reference's ``explore()`` Makie
slider UI (reference ext/CedarSimMakieExt.jl), redesigned as one batched
program.

The reference re-runs the simulation on every slider move (one CPU solve per
interaction).  Here the *entire slider grid* is simulated up front as ONE
vmapped XLA program — every combination of slider values is a batch lane —
and the output is a self-contained HTML file whose sliders simply select the
precomputed lane client-side.  Latency per interaction is zero, the heavy
compute runs where it's fastest (batched on the chip), and the artifact
works offline / headless (no display server, no websocket).
"""

from __future__ import annotations

import html
import itertools
import json

import numpy as np
import jax
import jax.numpy as jnp

_PALETTE = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e",
            "#8c564b", "#e377c2", "#7f7f7f"]


def explore(compiled, tspan, sliders, observables, path="explore.html",
            ctx=None, opts=None, n_samples=400, max_lanes=4096,
            title="cedarsim_tpu explore"):
    """Simulate every combination of ``sliders`` values as one vmapped batch
    and write an interactive HTML viewer.

    ``sliders``: {dotted-param-name: sequence of values} — the product grid
    becomes the batch.  ``observables``: names plottable via
    ``compiled.observe`` (nets, currents, VA variables).  Returns ``path``.
    """
    from cedarsim_tpu.core.context import SimSpec, Modes
    from cedarsim_tpu.core.compile import ensure_dynamic
    from cedarsim_tpu.analysis.dc import solve_dc
    from cedarsim_tpu.analysis.tran import (TranOptions, tran_core,
                                            _consistent_xdot,
                                            _differential_mask)

    names = list(sliders)
    grids = [np.asarray(sliders[k], dtype=float) for k in names]
    combos = list(itertools.product(*grids))
    if len(combos) > max_lanes:
        raise ValueError(f"slider grid has {len(combos)} lanes "
                         f"(> max_lanes={max_lanes}); coarsen the grid")
    nb = len(combos)

    compiled = ensure_dynamic(compiled, names)
    ctx = ctx or SimSpec.make(dtype=compiled.dtype)
    opts = opts or TranOptions()
    t0, tstop = float(tspan[0]), float(tspan[1])
    d = compiled.dtype

    # batched params: one lane per combo (host-side assembly, then one
    # device_put of the full grid)
    pb = jax.tree.map(lambda a: np.repeat(np.asarray(a)[None], nb, 0),
                      compiled.params0)
    for j, combo in enumerate(combos):
        for k, v in zip(names, combo):
            _set_lane(compiled, pb, j, k, v)
    pb = jax.tree.map(jnp.asarray, pb)

    op = solve_dc(compiled, ctx=ctx, mode=Modes.TRANOP)
    ctx_op = ctx.with_mode(Modes.TRANOP)
    xd0 = _consistent_xdot(compiled, op.x, ctx_op, compiled.params0)
    mask = _differential_mask(compiled, op.x, ctx_op, compiled.params0)
    bps = compiled.breakpoints(tstop)
    bps = np.concatenate([bps[bps > t0], [tstop], [np.inf]])
    x0b = jnp.repeat(op.x[None], nb, 0)
    xdb = jnp.repeat(xd0[None], nb, 0)

    fb = jax.jit(jax.vmap(
        lambda p, x, xd: tran_core(
            compiled, p, ctx, x, xd, jnp.asarray(t0, d),
            jnp.asarray(tstop, d), jnp.asarray(bps, d),
            jnp.asarray((tstop - t0) * 1e-6, d), opts, mask)))
    rb = fb(pb, x0b, xdb)
    ts = np.asarray(rb[0])                     # [nb, steps]
    xs = np.asarray(rb[1])
    xds = np.asarray(rb[2])

    # sample every lane / observable onto a uniform grid (client-side data)
    tgrid = np.linspace(t0, tstop, n_samples)
    data = {}
    for name in observables:
        fn = compiled.observe(name)
        f = jax.jit(jax.vmap(jax.vmap(
            lambda x, xd, t, p: fn(x, xd,
                                   ctx.with_mode(Modes.TRAN).at_time(t), p),
            in_axes=(0, 0, 0, None)), in_axes=(0, 0, 0, 0)))
        vals = np.asarray(f(rb[1], rb[2], rb[0], pb))   # [nb, steps]
        out = np.empty((nb, n_samples))
        for lane in range(nb):
            out[lane] = np.interp(tgrid, ts[lane], vals[lane])
        data[name] = out

    _write_html(path, title, names, grids, tgrid, data)
    return path


def _set_lane(compiled, pb, lane, dotted, value):
    """In-place write of one slider value into lane ``lane`` of the
    host-side batched param tree.  Bare names broadcast to every instance
    carrying the parameter (set_param semantics)."""
    if "." in dotted:
        gkey, j, pname = compiled.param_loc(dotted)
        pb[gkey][pname][lane, j] = value
        return
    pname = dotted.lower()
    hit = False
    for gkey in compiled.group_order:
        if pname in pb[gkey]:
            pb[gkey][pname][lane] = value
            hit = True
    if not hit:
        raise KeyError(f"no instance has parameter {pname!r}")


def _write_html(path, title, names, grids, tgrid, data):
    W, H, PAD = 900, 420, 48
    payload = {
        "names": names,
        "grids": [g.tolist() for g in grids],
        "t": tgrid.tolist(),
        "series": {k: np.round(v, 9).tolist() for k, v in data.items()},
        "palette": _PALETTE,
    }
    sliders_html = "".join(
        f'<div><label>{html.escape(n)}: '
        f'<span id="v{i}">{grids[i][0]:g}</span></label> '
        f'<input type="range" id="s{i}" min="0" max="{len(grids[i])-1}" '
        f'value="0" step="1" style="width:300px"></div>'
        for i, n in enumerate(names))
    doc = f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title></head>
<body style="font-family:sans-serif">
<h3>{html.escape(title)}</h3>
{sliders_html}
<svg id="plot" width="{W + 160}" height="{H}"></svg>
<script>
const D = {json.dumps(payload)};
const W = {W}, H = {H}, PAD = {PAD};
const sizes = D.grids.map(g => g.length);
function laneIndex() {{
  let lane = 0;
  for (let i = 0; i < sizes.length; i++) {{
    const v = +document.getElementById('s' + i).value;
    document.getElementById('v' + i).textContent = D.grids[i][v].toPrecision(4);
    lane = lane * sizes[i] + v;
  }}
  return lane;
}}
function draw() {{
  const lane = laneIndex();
  const svg = document.getElementById('plot');
  const t0 = D.t[0], t1 = D.t[D.t.length - 1];
  let ymin = Infinity, ymax = -Infinity;
  const keys = Object.keys(D.series);
  for (const k of keys) {{
    for (const v of D.series[k][lane]) {{
      if (v < ymin) ymin = v;
      if (v > ymax) ymax = v;
    }}
  }}
  if (ymax === ymin) ymax = ymin + 1;
  const sx = t => PAD + (t - t0) / (t1 - t0) * (W - 2 * PAD);
  const sy = v => H - PAD - (v - ymin) / (ymax - ymin) * (H - 2 * PAD);
  let out = `<line x1="${{PAD}}" y1="${{H - PAD}}" x2="${{W - PAD}}" ` +
    `y2="${{H - PAD}}" stroke="#888"/>` +
    `<line x1="${{PAD}}" y1="${{PAD}}" x2="${{PAD}}" y2="${{H - PAD}}" ` +
    `stroke="#888"/>` +
    `<text x="${{PAD}}" y="${{H - PAD + 18}}" font-size="11">` +
    `${{t0.toPrecision(3)}}s</text>` +
    `<text x="${{W - PAD - 40}}" y="${{H - PAD + 18}}" font-size="11">` +
    `${{t1.toPrecision(3)}}s</text>` +
    `<text x="4" y="${{sy(ymax) + 4}}" font-size="11">` +
    `${{ymax.toPrecision(3)}}</text>` +
    `<text x="4" y="${{sy(ymin) + 4}}" font-size="11">` +
    `${{ymin.toPrecision(3)}}</text>`;
  keys.forEach((k, i) => {{
    const pts = D.t.map((t, j) =>
      `${{sx(t).toFixed(1)}},${{sy(D.series[k][lane][j]).toFixed(1)}}`
    ).join(' ');
    const col = D.palette[i % D.palette.length];
    out += `<polyline fill="none" stroke="${{col}}" stroke-width="1.5" ` +
      `points="${{pts}}"/>`;
    out += `<text x="${{W - PAD + 8}}" y="${{PAD + 16 * (i + 1)}}" ` +
      `font-size="12" fill="${{col}}">${{k}}</text>`;
  }});
  svg.innerHTML = out;
}}
for (let i = 0; i < sizes.length; i++)
  document.getElementById('s' + i).addEventListener('input', draw);
draw();
</script></body></html>"""
    with open(path, "w") as f:
        f.write(doc)

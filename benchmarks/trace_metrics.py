"""Reduce a ``jax.profiler`` trace of one GPU run to device metrics.

    python benchmarks/trace_metrics.py TRACE [--annotation NAME]

TRACE is a ``jax.profiler`` trace directory or its ``.xplane.pb`` file.

Device busy time is the union of the kernel and copy intervals on the
GPU's stream lines; the idle share is 1 - busy / window.  The window is the
host ``TraceAnnotation`` span named by ``--annotation`` when the trace has
one, otherwise the extent of the device events.  Also reported: the event
count by kind (kernels, device-to-host and host-to-device copies) and the
longest idle gaps with their offsets into the window.  Prints one JSON line.
"""

import argparse
import glob
import json
import os
import sys


def intervals_union(iv):
    """Merge [(start, end)] into disjoint sorted intervals."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def window_metrics(events, t0, t1, n_gaps=5):
    """events: [(name, start_ns, dur_ns)] on the device.  Busy/idle share
    and the longest idle gaps inside [t0, t1]."""
    iv = [(max(s, t0), min(s + d, t1)) for _, s, d in events
          if s + d > t0 and s < t1]
    busy = intervals_union([(s, e) for s, e in iv if e > s])
    busy_ns = sum(e - s for s, e in busy)
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i] - t0)
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    span = max(t1 - t0, 1)
    return dict(window_ns=span, busy_ns=busy_ns,
                idle_share=1.0 - busy_ns / span,
                longest_gaps_ns=[dict(gap_ns=g, at_ns=a)
                                 for g, a in gaps[:n_gaps]])


def kind(name):
    n = name.lower().replace(" ", "")
    if "memcpy" in n or "memset" in n:
        if "dtoh" in n or "d2h" in n:
            return "copy_d2h"
        if "htod" in n or "h2d" in n:
            return "copy_h2d"
        return "copy_other"
    return "kernel"


def _profile(path):
    from jax.profiler import ProfileData
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                                 recursive=True))
        if not found:
            raise FileNotFoundError(f"no .xplane.pb under {path}")
        path = found[-1]
    return ProfileData.from_file(path)


def describe(path):
    """{plane: {line: event count}} — what a trace holds, for a first look
    before relying on its naming."""
    return {plane.name: {line.name: sum(1 for _ in line.events)
                         for line in plane.lines}
            for plane in _profile(path).planes}


def load(path):
    """(device events, {annotation name: [(start, end)]}) from a trace."""
    prof = _profile(path)
    dev, ann = [], {}
    for plane in prof.planes:
        if plane.name.startswith("/device:GPU"):
            for line in plane.lines:
                if line.name.startswith("Stream"):
                    dev += [(ev.name, ev.start_ns, ev.duration_ns)
                            for ev in line.events]
        elif plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    ann.setdefault(ev.name, []).append(
                        (ev.start_ns, ev.start_ns + ev.duration_ns))
    return dev, ann


def reduce_trace(path, annotation=None):
    dev, ann = load(path)
    if annotation and annotation in ann:
        t0, t1 = max(ann[annotation], key=lambda se: se[1] - se[0])
        source = f"annotation {annotation}"
    elif dev:
        t0 = min(s for _, s, _ in dev)
        t1 = max(s + d for _, s, d in dev)
        source = "device event extent"
    else:
        raise ValueError("trace has no GPU stream events")
    inside = [e for e in dev if t0 <= e[1] < t1]
    counts = {}
    for name, _, _ in inside:
        counts[kind(name)] = counts.get(kind(name), 0) + 1
    return dict(window=source, events=counts,
                **window_metrics(inside, t0, t1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--annotation", default=None)
    a = ap.parse_args()
    print(json.dumps(reduce_trace(a.trace, a.annotation)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

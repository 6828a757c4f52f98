"""Netlist-keyed artifact cache: persisted solver results keyed on the exact
elaborated circuit + parameter values + sim context.

SURVEY.md §5 checkpoint/resume names this as a new capability over the
reference: the compiled-code side is covered by the persistent XLA cache
(config.py); this covers the *solution* side — DC operating points are
stored under a content hash and replayed as warm starts, so a re-run of the
same deck skips the full gmin/source-stepping continuation ladder (the
plain-attempt rung of analysis/dc.py's schedule converges directly from the
cached point).  Warm starts are hints, never answers: the Newton solve still
verifies convergence, so a stale or corrupt artifact costs one extra rung,
not correctness.

Stored in ``.cedarsim_cache/artifacts`` in the checkout.  Disable with
CEDARSIM_TPU_ARTIFACTS=0; relocate by setting it to a path.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import jax


def cache_dir():
    from cedarsim_tpu.config import LOCAL_CACHE
    d = os.environ.get("CEDARSIM_TPU_ARTIFACTS",
                       os.path.join(LOCAL_CACHE, "artifacts"))
    if not d or d == "0":
        return None
    os.makedirs(d, exist_ok=True)
    return d


def _update_tree(h, tree):
    leaves, treedef = jax.tree.flatten(tree)
    h.update(repr(treedef).encode())
    for leaf in leaves:
        if isinstance(leaf, jax.core.Tracer):
            raise TypeError("traced value")
        a = np.asarray(leaf)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())


def op_key(compiled, params, ctx, mode) -> str | None:
    """Content hash of (elaborated structure, parameter values, context) —
    None when uncacheable (traced values, disabled cache)."""
    from cedarsim_tpu import __version__
    try:
        h = hashlib.sha256()
        h.update(f"op/{__version__}/{compiled.dtype}/"
                 f"{compiled.eval_dtype}/{mode}".encode())
        h.update("|".join(compiled.node_names).encode())
        for key in compiled.group_order:
            g = compiled.groups[key]
            h.update(key.encode())
            h.update(repr(sorted(g.static_params.items(),
                                 key=lambda kv: kv[0])).encode())
            h.update(np.ascontiguousarray(g.row_idx).tobytes())
            h.update(np.ascontiguousarray(g.var_idx).tobytes())
        _update_tree(h, params)
        _update_tree(h, (ctx.gmin, ctx.temp, ctx.sourcefac))
        return h.hexdigest()
    except TypeError:
        return None


def load_op(key):
    d = cache_dir()
    if d is None or key is None:
        return None
    path = os.path.join(d, f"{key}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return z["x"]
    except Exception:
        return None


def store_op(key, x):
    d = cache_dir()
    if d is None or key is None:
        return
    x = np.asarray(x)
    if not np.all(np.isfinite(x)):
        return
    path = os.path.join(d, f"{key}.npz")
    # np.savez appends .npz to names lacking it — keep the suffix on the
    # temp file so os.replace sees the actual written path
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, x=x)
    os.replace(tmp, path)

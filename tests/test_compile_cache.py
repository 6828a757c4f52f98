"""Where the package's caches go.  The persistent XLA compile cache:
JAX_COMPILATION_CACHE_DIR when it is set, otherwise one fixed directory in
the checkout; those cases import the package in a fresh process, since the
choice is made at import.  DC warm starts and the native planner library:
their own environment variable, otherwise ``.cedarsim_cache/`` in the
checkout."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import json, jax, cedarsim_tpu.config as c; "
         "print(json.dumps([jax.config.jax_compilation_cache_dir, "
         "c.CACHE_DIR]))")


def _probe(**env_over):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_over, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run([sys.executable, "-c", PROBE], env=env, cwd="/",
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_env_cache_dir_is_honoured(tmp_path):
    d = str(tmp_path / "xla")
    assert _probe(JAX_COMPILATION_CACHE_DIR=d) == [d, d]


def test_default_cache_dir_is_fixed_in_checkout():
    want = os.path.join(REPO, ".jax_cache")
    assert _probe() == [want, want]
    # the same path from any working directory and on every import
    assert _probe() == [want, want]


def test_dc_warm_starts_default_to_the_checkout(monkeypatch, tmp_path):
    from cedarsim_tpu.utils import artifacts
    monkeypatch.delenv("CEDARSIM_TPU_ARTIFACTS", raising=False)
    assert artifacts.cache_dir() == os.path.join(REPO, ".cedarsim_cache",
                                                 "artifacts")
    monkeypatch.setenv("CEDARSIM_TPU_ARTIFACTS", str(tmp_path))
    assert artifacts.cache_dir() == str(tmp_path)


def test_native_library_defaults_to_the_checkout(monkeypatch, tmp_path):
    from cedarsim_tpu import native
    monkeypatch.delenv("CEDARSIM_TPU_NATIVE_CACHE", raising=False)
    assert native._cache_dir() == os.path.join(REPO, ".cedarsim_cache",
                                               "native")
    monkeypatch.setenv("CEDARSIM_TPU_NATIVE_CACHE", str(tmp_path))
    assert native._cache_dir() == str(tmp_path)

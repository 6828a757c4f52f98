"""Test configuration: force an 8-device virtual CPU platform so sharding /
mesh tests run on one CPU, and enable x64 before JAX initializes."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Pin the platform through the config API as well, so a machine whose JAX
# has a GPU plugin still runs the tests on the CPU.
jax.config.update("jax_platforms", "cpu")

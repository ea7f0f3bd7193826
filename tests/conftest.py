"""Test configuration: the tests run on the CPU, with an 8-device virtual
CPU mesh for the sharded paths, set before any backend initializes.

The GPU is exercised by `python chip_smoke.py` (and `--four` on a host with
four cards), not by this suite.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

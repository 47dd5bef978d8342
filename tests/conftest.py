"""Test harness: run JAX on a virtual 8-device CPU mesh with float64 enabled.

Mirrors the multi-host test strategy from SURVEY.md section 4: sharding is
validated on ``xla_force_host_platform_device_count`` virtual devices so the
suite runs anywhere. The GPU run is ``python chip_smoke.py`` (one card) and
``python chip_smoke.py --cards 4`` (the mesh path).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

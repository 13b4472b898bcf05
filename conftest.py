"""Root conftest: force the CPU backend + virtual 8-device mesh.

jax.config.update switches the platform even when jax was imported before
this file ran.  (tests/conftest.py additionally enables x64 and the
persistent compile cache.)
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    pass  # older JAX: XLA_FLAGS path above covers it

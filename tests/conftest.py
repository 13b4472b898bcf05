import os

# Tests run on a virtual 8-device CPU mesh so multi-chip sharding behavior is
# exercised without a multi-device machine; f64 enabled for numerical parity oracles.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
# persistent compile cache: repeated suite runs skip XLA compilation
from pysolvers_tpu.utils.platform import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

"""Test config: force CPU with 8 virtual devices so sharding tests run
anywhere (the multi-card path itself runs on GPUs through
``chip_smoke.py --four-cards``)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from gopbrt_tpu.compile_cache import enable_compile_cache  # noqa: E402

# The suite runs on the CPU (tests that need a GPU compile for it without
# running, e.g. by lowering for CUDA); set after import so that it holds
# whatever the environment says.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
# persist compiled executables across runs
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

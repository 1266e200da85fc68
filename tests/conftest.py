"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Correctness tests run in f64 on a virtual 8-device CPU mesh (matching how
multi-device sharding is rehearsed without cards). Tests marked `gpu` need a
card and skip here; speed is measured on the card by bench.py.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

from iamr_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

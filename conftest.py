"""Root pytest config: run JAX on 8 virtual CPU devices, so the suite is
hermetic and exercises 8-device sharding (`jax.sharding.Mesh`) without
an accelerator, and keep the persistent compile cache off. The card is
checked by ``python chip_smoke.py``, not by this suite.
"""

import os

_platform = os.environ.get("KISS_TPU_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _platform
os.environ["KISS_TPU_NO_CACHE"] = "1"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", _platform)

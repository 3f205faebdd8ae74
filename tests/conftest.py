"""Test configuration: an 8-device virtual CPU mesh by default.

Runs before anything imports jax: tests exercise multi-device sharding on
a fake 8-device CPU platform (the standard JAX substitute for several
accelerators in unit tests — SURVEY.md section 4).  The platform is
``JAX_PLATFORMS`` if the caller set it, else ``cpu``, pinned through
jax.config too.  Tests marked ``gpu`` take the :func:`gpu_devices`
fixture, which skips unless JAX's default platform is a GPU: run them on
the card with ``python -m pytest -m gpu tests/``.  The persistent compile
cache stays off: tests that call a CLI ``main`` must not write compiled
programs into the checkout.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (must come after the env setup above)

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_devices():
    """JAX's devices when they are GPUs; skips the test otherwise.  The
    check runs inside the fixture, never at import or collection time, so
    every test worker collects the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's platform is {devices[0].platform!r}")
    return devices
